"""Durable serving: crash-safe journaling and byte-exact warm restart
over the write-ahead log (the port's copy of
``flexflow_tpu/serving/durable.py``; it imports no PyTorch itself).

Three pieces, layered over the recovery machinery
(``generation/recovery.py``) rather than beside it:

``DurableJournal``
    A :class:`~flexflow_tpu_torch.generation.recovery.GenerationJournal`
    subclass the scheduler already calls into. Every admission mirrors a
    full replay snapshot (original prompt, generated prefix, sampling
    seed, priority, response_format, speculation config, the deadline as
    ABSOLUTE WALL TIME and the journey's identity) into the WAL, every
    emitted token buffers a delta, and ``flush_step`` group-commits once
    per scheduler iteration inside the overlap pipeline's execute
    window. A failed append degrades that ONE stream to non-durable with
    a counted warning (``wal_append_failures``); the decode path never
    blocks on the log. Because tokens are a deterministic function of
    (prompt, seed, count), a replay regrows an un-journaled tail
    byte-exactly anyway.

``WarmRestart``
    Scans the predecessor's segments (torn tails truncated and counted),
    refuses replay across an engine-fingerprint mismatch with a typed
    :class:`FingerprintMismatchError`, expires streams whose wall-clock
    deadline passed while the process was down (the REMAINING budget is
    converted back onto the scheduler clock), and re-admits every
    unfinished stream through ``scheduler.adopt()`` in journal order,
    mid-stream requests to the queue front, where recompute prefill
    resumes them. Adopted streams are re-journaled into the new log's
    active segment and synced BEFORE the old segments are released for
    reaping, so a crash at any point replays idempotently.

``Durability``
    The per-engine runtime object tying the two together: owns the WAL,
    the :class:`~flexflow_tpu_torch.serving.stats.DurableStats` gauges,
    the journey spool next to the segments, and the resume index that
    ``GET /v2/generate/resume/{id}`` reads (live streams by durable id,
    plus a bounded LRU of terminal outcomes). Attaches at scheduler level
    or through ``GenerationModel.enable_durability``; a fleet with a
    ``durability_root`` attaches one per replica slot (``slot-N``): a
    replacement inherits its slot's journal, a stream that fails over is
    retired from the dead replica's journal with END("migrated"), and a
    fleet built after process death warm-restarts every slot.

The WAL bytes and :func:`engine_fingerprint` are the JAX package's, so a
journal either package wrote is replayed by the other for the same
configuration. Fault sites: ``serving.wal_append`` / ``serving.wal_fsync``
fire in the WAL; ``serving.wal_replay`` fires at the top of a warm
restart's replay, after the fingerprint check and before any stream is
re-admitted.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import threading
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Set, Tuple

from ..generation.engine import SamplingParams
from ..generation.recovery import GenerationJournal
from ..generation.scheduler import Request
from ..generation.speculative.drafter import SpeculationConfig, build_drafter
from ..obs import JourneyContext, JourneySpool
from ..runtime import faults
from ..runtime.wal import (
    WalError,
    WriteAheadLog,
    replay_streams,
    scan_wal,
    wal_fingerprints,
)
from .stats import DurableStats

# exceptions a journal append can surface without taking the stream
# (or the step loop) down with it
_APPEND_ERRORS = (
    faults.FaultInjected,
    faults.TransientDeviceError,
    WalError,
    OSError,
)


class FingerprintMismatchError(RuntimeError):
    """The WAL on disk was written by an engine whose configuration
    fingerprint differs from this one — replaying it could silently
    fork every stream (different geometry, vocab, or speculation
    ceiling changes what the recompute regenerates). A warm restart
    refuses rather than guesses; the operator either restores the
    matching config or removes the journal deliberately."""

    def __init__(self, expected: str, found: str):
        super().__init__(
            f"WAL fingerprint mismatch: journal was written by engine "
            f"{found[:16]}…, this engine is {expected[:16]}… — refusing "
            f"to replay (a mismatched replay can fork streams silently)"
        )
        self.expected = expected
        self.found = found


def engine_fingerprint(engine) -> str:
    """Stable hash over everything that must match for a journaled
    stream to replay byte-exactly on this engine: model config, cache
    geometry, slot/speculation ceilings, and the prompt buckets. The
    same spec and the same JSON as the JAX package's, so one
    configuration gives one digest in both. Weights are assumed managed
    alongside (the same checkpoint on both sides of the restart):
    hashing parameters would put device transfers on the attach path."""
    spec = {
        "wal_version": 1,
        "model": dataclasses.asdict(engine.cfg),
        "cache": dataclasses.asdict(engine.cache_config),
        "max_seq_len": engine.max_seq_len,
        "max_batch_slots": engine.max_batch_slots,
        "max_spec_tokens": engine.max_spec_tokens,
        "buckets": list(engine.buckets),
    }
    payload = json.dumps(spec, sort_keys=True, default=str).encode("utf-8")
    return hashlib.sha256(payload).hexdigest()


@dataclasses.dataclass
class DurabilityConfig:
    """Knobs for one engine's durable-serving attachment.

    ``wall_clock`` is injectable for the deadline-conversion tests (the
    journal stores ABSOLUTE wall deadlines; both ends of the conversion
    must read the same clock). ``fsync=False``: group commits still
    write, the OS owns persistence.
    """

    wal_dir: str
    max_segment_bytes: int = 1 << 20
    fsync: bool = True
    # fsync pacing: the host-death durability window (process death is
    # covered by the per-step write regardless — page cache survives it)
    commit_interval_s: float = 0.05
    wall_clock: Callable[[], float] = time.time
    resume_cache: int = 256  # terminal outcomes kept for late resumers
    # journey-span spool budget (obs/journey.py): the bounded on-disk
    # ring of pre-crash spans kept next to the WAL segments
    journey_spool_bytes: int = 1 << 20


class DurableJournal(GenerationJournal):
    """The scheduler-facing journal, mirrored into the WAL.

    Threading: ``record``/``discard``/``note_token``/``flush_step``
    run on the scheduler loop thread; ``_on_settle`` runs on whichever
    thread settles the handle (the loop thread, the watchdog, or a
    client cancel). The base class guards its entry map with its own
    lock; the durable bookkeeping below has a separate one so the two
    never nest.
    """

    def __init__(
        self,
        wal: WriteAheadLog,
        stats: DurableStats,
        *,
        sched_clock: Callable[[], float],
        wall_clock: Callable[[], float],
        flight=None,
        on_admit: Optional[Callable[[Request], None]] = None,
        on_terminal: Optional[Callable[[str, List[int], str], None]] = None,
    ):
        super().__init__()
        self.wal = wal
        self.stats = stats
        self.sched_clock = sched_clock
        self.wall_clock = wall_clock
        self.flight = flight
        self.on_admit = on_admit
        self.on_terminal = on_terminal
        # durable ids must stay unique across the restarts that share
        # one WAL directory: request ids restart with the process, so
        # prefix them with pid + attach wall-ms
        self._id_prefix = f"{os.getpid():x}-{int(wall_clock() * 1e3) & 0xFFFFFFFF:x}"
        self._dlock = threading.Lock()
        self._pending: Dict[str, List[int]] = {}  # unflushed token deltas; guarded-by: _dlock
        self._degraded: Set[str] = set()  # streams off the log after a failed append; guarded-by: _dlock
        self._ended: Set[str] = set()  # END written (settle-callback dedup); guarded-by: _dlock
        self._admitted: Set[str] = set()  # ids with an ADMIT in the log (END gating); guarded-by: _dlock
        self._settle_hooked: Set[int] = set()  # request (process-local) ids with a settle callback; guarded-by: _dlock

    def assign_id(self, req: Request) -> str:
        """Pin the stream's restart-stable durable id (idempotent)."""
        if req.durable_id is None:
            req.durable_id = f"{self._id_prefix}-{req.id}"
        return req.durable_id

    def hook_settle(self, req: Request) -> None:
        """Arrange the END record (and resume-index cleanup) at the
        handle's terminal settle — finish/fail/expire, NOT discard,
        which also fires on preemption where the stream stays open and
        the next re-ADMIT refreshes its snapshot. Idempotent per
        request object; safe to call at submit time (a stream shed
        before admission still gets its index entry retired)."""
        with self._dlock:
            hook = req.id not in self._settle_hooked
            if hook:
                self._settle_hooked.add(req.id)
        if hook:
            req.handle.future.add_done_callback(
                lambda fut, req=req: self._on_settle(req, fut)
            )

    # ------------------------------------------------------- admissions
    def record(self, req: Request, admitted_seq: int) -> None:
        super().record(req, admitted_seq)
        did = self.assign_id(req)
        rec = self._admit_record(req, admitted_seq)
        with self._dlock:
            degraded = did in self._degraded
            # a re-ADMIT (preemption re-slot, or a warm restart pinning
            # an old id onto a new request) reopens the stream
            self._ended.discard(did)
            self._pending.pop(did, None)
            self._admitted.add(did)
        if not degraded:
            try:
                self.wal.append(rec)
            except _APPEND_ERRORS:
                self._degrade(did, "admit")
        self.hook_settle(req)
        if self.on_admit is not None:
            self.on_admit(req)

    def _admit_record(self, req: Request, admitted_seq: int) -> Dict:
        # the deadline is journaled as ABSOLUTE WALL TIME: the
        # scheduler clock is injectable/relative and does not survive
        # the process, so a restart converts the REMAINING wall budget
        # back onto the new scheduler clock: the down-window can
        # neither extend nor double-expire the request
        wall_deadline = None
        if req.deadline is not None:
            wall_deadline = self.wall_clock() + (req.deadline - self.sched_clock())
        spec = dataclasses.asdict(req.speculation) if req.speculation else None
        return {
            "t": "admit",
            "id": req.durable_id,
            "seq": admitted_seq,
            "prompt": list(req.original_prompt),
            "generated": list(req.generated),
            "sampling": dataclasses.asdict(req.sampling),
            "priority": req.priority,
            "wall_deadline": wall_deadline,
            "response_format": req.response_format,
            "speculation": spec,
            "max_new": req.max_new,
            # the stream's journey identity: a warm restart restores
            # (journey id, chain tip, hop count) so post-crash spans
            # parent onto the pre-crash chain (None when journeys off)
            "journey": req.journey.snapshot(),
        }

    # ------------------------------------------------------ token deltas
    def note_token(self, req: Request, token: int) -> None:
        did = req.durable_id
        if did is None:
            return
        with self._dlock:
            if did in self._degraded or did in self._ended:
                return
            self._pending.setdefault(did, []).append(int(token))

    def flush_step(self) -> None:
        """Group commit: one TOK record per stream that emitted this
        step, then a single write (the committer thread owns the fsync).
        Called once per scheduler iteration, off the device dispatch
        path (the overlap pipeline's dispatched step executes while this
        runs)."""
        with self._dlock:
            if self._pending:
                pending, self._pending = self._pending, {}
            else:
                pending = None
        if pending:
            for did, toks in pending.items():
                try:
                    self.wal.append({"t": "tok", "id": did, "toks": toks})
                except _APPEND_ERRORS:
                    self._degrade(did, "tok")
        self.wal.flush()

    # ------------------------------------------------------- terminations
    def _on_settle(self, req: Request, fut) -> None:
        if fut.cancelled():
            outcome = "cancelled"
        else:
            exc = fut.exception()
            outcome = type(exc).__name__ if exc is not None else "completed"
        self.end_stream(req, outcome)

    def end_stream(self, req: Request, outcome: str) -> None:
        """Write the END record exactly once per (re)admission epoch;
        safe from any thread."""
        did = req.durable_id
        if did is None:
            return
        with self._dlock:
            if did in self._ended:
                return
            self._ended.add(did)
            # a stream that never journaled an ADMIT (shed/expired in
            # queue) writes no END — the log never knew it
            degraded = did in self._degraded or did not in self._admitted
            tail = self._pending.pop(did, None)
        if not degraded:
            try:
                if tail:
                    self.wal.append({"t": "tok", "id": did, "toks": tail})
                self.wal.append({"t": "end", "id": did, "outcome": outcome})
            except _APPEND_ERRORS:
                self._degrade(did, "end")
        if self.on_terminal is not None:
            self.on_terminal(did, list(req.generated), outcome)

    def _degrade(self, did: str, where: str) -> None:
        """A journal append failed: take this ONE stream off the log
        with a counted warning. Generation continues untouched — the
        WAL keeps whatever prefix was already journaled, and replay
        regrows the rest deterministically."""
        with self._dlock:
            fresh = did not in self._degraded
            self._degraded.add(did)
            self._pending.pop(did, None)
        if fresh:
            self.stats.incr("wal_append_failures")
            if self.flight is not None:
                self.flight.record_event("wal_degraded", stream=did, where=where)

    def degraded_count(self) -> int:
        with self._dlock:
            return len(self._degraded)


class Durability:
    """One engine's durable-serving runtime: WAL + journal + stats +
    the resume index. Attach before traffic (the constructor swaps the
    scheduler's journal; entries already live are re-recorded so
    nothing mid-flight escapes the log)."""

    def __init__(
        self,
        scheduler,
        config: DurabilityConfig,
        *,
        grammar_cache=None,
    ):
        self.scheduler = scheduler
        self.config = config
        self.grammar_cache = grammar_cache
        self.fingerprint = engine_fingerprint(scheduler.engine)
        self.wal = WriteAheadLog(
            config.wal_dir,
            max_segment_bytes=config.max_segment_bytes,
            fsync=config.fsync,
            commit_interval_s=config.commit_interval_s,
            fingerprint=self.fingerprint,
            wall_clock=config.wall_clock,
        )
        self.stats = DurableStats()
        self.stats.wal = self.wal
        self._lock = threading.Lock()
        self._live: Dict[str, Request] = {}  # durable id -> live request; guarded-by: _lock
        self._done: "OrderedDict[str, Dict]" = OrderedDict()  # terminal LRU; guarded-by: _lock
        self.journal = DurableJournal(
            self.wal,
            self.stats,
            sched_clock=scheduler.clock,
            wall_clock=config.wall_clock,
            flight=scheduler.flight,
            on_admit=self._note_live,
            on_terminal=self._note_terminal,
        )
        # journeys: spool this scheduler's spans into a bounded on-disk
        # ring next to the WAL segments so pre-crash hops stay joinable
        # after SIGKILL (the same directory across restarts: the
        # successor's spool scans the predecessor's segments)
        self.journey_spool = None
        journeys = getattr(scheduler, "journeys", None)
        if journeys is not None:
            self.journey_spool = JourneySpool(
                os.path.join(config.wal_dir, "journeys"),
                max_bytes=config.journey_spool_bytes,
                stats=scheduler.journey_stats,
            )
            journeys.spool = self.journey_spool
        for entry in scheduler.journal.entries():
            self.journal.record(entry.req, entry.admitted_seq)
        scheduler.journal = self.journal
        self.stats.register_gauges(scheduler.stats)

    # ------------------------------------------------------ resume index
    def track(self, req: Request) -> str:
        """Submit-time registration: pin the durable id and index the
        stream so the HTTP response (and an immediate reconnect) can
        name it before admission journals it."""
        did = self.journal.assign_id(req)
        self.journal.hook_settle(req)
        self._note_live(req)
        return did

    def _note_live(self, req: Request) -> None:
        with self._lock:
            self._live[req.durable_id] = req

    def _note_terminal(self, did: str, tokens: List[int], outcome: str) -> None:
        with self._lock:
            self._live.pop(did, None)
            self._done[did] = {"tokens": list(tokens), "outcome": outcome}
            self._done.move_to_end(did)
            while len(self._done) > self.config.resume_cache:
                self._done.popitem(last=False)

    def lookup(self, durable_id: str) -> Optional[Tuple[str, object]]:
        """Resume-endpoint lookup: ``("live", Request)`` while the
        stream is running, ``("done", {"tokens", "outcome"})`` from the
        terminal LRU afterwards, ``None`` for unknown/evicted ids."""
        with self._lock:
            req = self._live.get(durable_id)
            if req is not None:
                return ("live", req)
            done = self._done.get(durable_id)
            if done is not None:
                return ("done", dict(done))
        return None

    # --------------------------------------------------------- lifecycle
    def sync(self) -> None:
        """Hard durability point outside the scheduler loop (step-mode
        callers, teardown): group-commit the pending deltas AND block
        until the fsync frontier covers them; the per-step path never
        waits like this."""
        self.journal.flush_step()
        self.wal.sync()

    def warm_restart(self) -> Dict:
        return WarmRestart(self).run()

    def report(self) -> Dict:
        """The /v2/durable (and obsreport) view."""
        counters = self.wal.counters()
        with self._lock:
            live, done = len(self._live), len(self._done)
        return {
            "fingerprint": self.fingerprint,
            "wal_dir": self.config.wal_dir,
            "fsync": self.config.fsync,
            "watermark": self.wal.watermark(),
            "wal": counters,
            "segments": self.wal.segment_count(),
            "counters": self.stats.counts(),
            "degraded_streams": self.journal.degraded_count(),
            "resume_index": {"live": live, "terminal": done},
        }

    def close(self) -> None:
        """Flush and release the WAL and the journey spool, joining the
        WAL's commit thread. The journal keeps serving the in-memory
        recovery paths; further appends are dropped as degraded."""
        if self.journey_spool is not None:
            self.journey_spool.close()
        self.wal.close()


class WarmRestart:
    """Replay a predecessor's WAL onto a freshly attached
    :class:`Durability`. Run BEFORE serving traffic: the scan reads
    every segment in the directory, and the re-admitted streams go to
    the queue front ahead of anything new."""

    def __init__(self, durability: Durability):
        self.durability = durability

    def run(self) -> Dict:
        d = self.durability
        sched = d.scheduler
        records, torn = scan_wal(
            d.wal.dirpath, before_index=d.wal.active_index
        )
        if torn:
            d.stats.incr("torn_records", torn)
        for fp in wal_fingerprints(records):
            if fp != d.fingerprint:
                raise FingerprintMismatchError(expected=d.fingerprint, found=fp)
        unfinished = [s for s in replay_streams(records) if not s.ended]
        faults.inject(faults.SERVING_WAL_REPLAY, len(unfinished))
        adopted: List[Request] = []
        expired: List[str] = []
        for stream in unfinished:
            remaining = None
            wall_deadline = stream.admit.get("wall_deadline")
            if wall_deadline is not None:
                remaining = wall_deadline - d.config.wall_clock()
                if remaining <= 0:
                    # the budget ran out while the process was down:
                    # expire WITHOUT re-admitting, but leave a terminal
                    # resume entry so a reconnecting client gets a
                    # typed outcome instead of a 404
                    expired.append(stream.admit["id"])
                    d._note_terminal(stream.admit["id"], stream.tokens, "expired")
                    continue
            req = self._rebuild(stream, remaining)
            d.stats.incr("replayed_streams")
            d.stats.incr("replayed_tokens", len(stream.tokens))
            sched.adopt(req, front=req.n_generated > 0)
            # the adopt hop (recorded inside adopt()) parented onto the
            # pre-crash chain tip restored from the WAL snapshot; the
            # restart itself is its own hop so the stitched timeline
            # shows the down-window explicitly
            req.journey.hop(
                "warm_restart", durable_id=req.durable_id,
                n_tokens=len(stream.tokens), torn_records=torn,
            )
            adopted.append(req)
        # re-journal into the NEW active segment and make it durable
        # BEFORE releasing the predecessor segments for reaping — a
        # crash anywhere in between replays the old records again
        # (idempotent: the newest re-ADMIT per id wins)
        for seq, req in enumerate(adopted):
            d.journal.record(req, seq)
        d.journal.flush_step()
        d.wal.sync()  # the re-journal must be ON DISK before reaping
        d.wal.mark_recovered()
        report = {
            "replayed_streams": len(adopted),
            "replayed_tokens": sum(r.n_generated for r in adopted),
            "expired_streams": expired,
            "torn_records": torn,
            "fingerprint": d.fingerprint,
            "segments": d.wal.segment_count(),
        }
        if sched.flight is not None:
            sched.flight.record_event(
                "warm_restart",
                replayed=len(adopted),
                expired=len(expired),
                torn=torn,
            )
        return report

    def _rebuild(self, stream, remaining: Optional[float]) -> Request:
        """Reconstruct the Request from its admit snapshot + token
        deltas. Everything replay needs is in the record: the
        per-token-count seeded sampling stream makes the recompute
        byte-exact, as it does for preemption and journal replay."""
        d = self.durability
        sched = d.scheduler
        admit = stream.admit
        sampling = SamplingParams(**admit["sampling"])
        spec = None
        drafter = None
        if admit.get("speculation"):
            spec = SpeculationConfig(**admit["speculation"])
            if spec.enabled:
                drafter = build_drafter(
                    spec,
                    draft_params=sched.draft_params,
                    max_seq_len=sched.engine.max_seq_len,
                )
        grammar = None
        response_format = admit.get("response_format")
        if response_format is not None and d.grammar_cache is not None:
            grammar = d.grammar_cache.get(response_format)
        req = Request(
            list(admit["prompt"]),
            sampling,
            deadline=None,
            speculation=spec,
            drafter=drafter,
            priority=admit.get("priority", "standard"),
            grammar=grammar,
            response_format=response_format,
        )
        req.generated = [int(t) for t in stream.tokens]
        req.max_new = int(admit.get("max_new", sampling.max_new_tokens))
        req.durable_id = admit["id"]
        snap = admit.get("journey")
        if snap and sched.journeys is not None:
            # identity survives the process: same journey id, next hop
            # parents onto the pre-crash tip (adopt() binds the
            # recorder when it retargets observability at this scheduler)
            req.journey = JourneyContext.restore(snap)
        req.submitted_at = sched.clock()
        if remaining is not None:
            req.deadline = sched.clock() + remaining
        return req
