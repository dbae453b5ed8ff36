"""Self-healing layer around the generation engine: journal-replay
recovery, crash supervision and a step watchdog (port of
``flexflow_tpu/generation/recovery.py``).

Every stream is exactly replayable: the per-request sampling noise is
indexed by generated-token count, and recompute-prefill (the preemption
path) reproduces a stream token for token. Crash recovery therefore
needs no device-side checkpoint, only the host-side **generation
journal** (prompt, emitted tokens, sampling/speculation state), which
the scheduler keeps anyway.

* :class:`GenerationJournal`: the per-request replay log. An entry is
  recorded at admission and discarded when the request leaves its slot
  (finish, fail, preempt, quarantine).
* :class:`EngineSupervisor`: wraps every batched device step. On a step
  failure it (1) retries the step once, (2) bisects the batch with
  subset probes and quarantines a request whose subset reproducibly
  crashes alone, (3) otherwise resets the engine (``engine.reset()``:
  the KV cache zeroed in place, the allocator and prefix index
  restored; nothing is captured again) and journal-replays every live
  stream, under an exponential-backoff restart budget. An engine with
  ``donate`` set (the accelerator default) goes straight to (3), as the
  JAX engine does when its jitted steps donate their cache buffers.
  NaN/inf logits never raise: the step's per-slot finiteness flags pin
  the poisoned request (partial blame, quarantine) or restart the engine
  (whole-batch blame).
* :class:`StepWatchdog`: detects stalled device steps through a
  heartbeat the scheduler stamps around every device call; a trip opens
  the circuit breaker, fails deadline-expired handles and marks the step
  stale, so the supervisor discards its late result and restarts.

Failure taxonomy:

  transient device error   -> RetryPolicy retry, invisible
  hard step crash, once    -> supervisor step retry, invisible
  reproducible + isolable  -> quarantine (fails alone, original error)
  NaN logits, some slots   -> quarantine with PoisonedRequestError
  NaN logits, all slots    -> engine restart + journal replay
  crash, not isolable      -> engine restart + journal replay
  stalled step             -> watchdog trip -> restart + journal replay
  restart budget exhausted -> EngineFailedError for running streams +
                              breaker OPEN; queued requests are HELD and
                              admitted again when the breaker's
                              half-open probe succeeds

Every step failure, retry, restart, double fault and watchdog trip is an
event on the scheduler's flight recorder; a restart, a quarantine and a
give-up attach the ring's incident snapshot to their error
(``flight_snapshot``), which the HTTP front end returns in the failed
request's body.

Chaos sites: ``generation.journal_replay`` fires at the top of every
restart (a crash there is a double fault that consumes another budget
unit). All clocks and sleeps are injectable.
"""
from __future__ import annotations

import dataclasses
import random
import threading
import time
from typing import TYPE_CHECKING, Callable, List, Optional, Sequence

from ..runtime import faults
from ..runtime.backoff import backoff_delay
from ..serving.resilience import DeadlineExceededError

if TYPE_CHECKING:  # import cycle: scheduler imports this module
    from .scheduler import ContinuousBatchingScheduler, Request, _Running


class EngineFailedError(RuntimeError):
    """The generation engine is permanently gone (restart budget
    exhausted): the typed error of streams that had already emitted
    tokens. Fresh queued requests are HELD rather than failed."""


class PoisonedRequestError(RuntimeError):
    """THIS request's data produced non-finite logits and it was failed
    alone so the rest of the batch could keep generating. (A request
    quarantined by crash bisection gets the original device exception
    instead.)"""

    def __init__(self, message: str, *, request_id: int, step: str, reason: str):
        super().__init__(message)
        self.request_id = request_id
        self.step = step  # "prefill" | "decode" | "verify"
        self.reason = reason  # "nan_logits"


class StalledStepError(RuntimeError):
    """A device step exceeded the watchdog's stall timeout; its (late)
    result was discarded and the engine restarted."""


class RecoveryStats:
    """Self-healing counters for one scheduler (supervisor + watchdog):

      recoveries       completed engine restart + journal-replay cycles
      step_retries     failed device steps absorbed by the single retry
      replayed_tokens  generated tokens folded back into prompts for
                       recompute-replay across all recoveries
      quarantined      poisoned requests failed alone
      watchdog_trips   stalled device steps detected by the watchdog
      engine_failures  restart budgets exhausted (engine declared dead)
      kv_imports       handed-off KV payloads committed into this cache
                       (a disaggregated decode-pool admission)
      kv_imports_rejected  imported payloads rejected (CRC, geometry or
                       an injected fault) and recomputed instead

    Written by the loop thread and the watchdog thread under a lock;
    :meth:`register_gauges` puts every field on the scheduler's
    ``ServingStats``."""

    FIELDS = (
        "recoveries", "step_retries", "replayed_tokens",
        "quarantined", "watchdog_trips", "engine_failures",
        "kv_imports", "kv_imports_rejected",
    )

    def __init__(self):
        self._lock = threading.Lock()
        for f in self.FIELDS:
            setattr(self, f, 0)

    def incr(self, field: str, n: int = 1) -> None:
        if field not in self.FIELDS:
            raise ValueError(f"unknown recovery counter {field!r}")
        with self._lock:
            setattr(self, field, getattr(self, field) + n)

    def snapshot(self) -> dict:
        with self._lock:
            return {f: getattr(self, f) for f in self.FIELDS}

    def register_gauges(self, stats) -> None:
        for f in self.FIELDS:
            stats.add_gauge(f, lambda f=f: getattr(self, f))


@dataclasses.dataclass(frozen=True)
class RecoveryPolicy:
    """Supervisor tuning. ``max_restarts`` engine restarts are allowed
    per sliding ``budget_window_s`` (scheduler clock); each restart
    backs off exponentially with seeded jitter (``runtime/backoff.py``,
    the same curve as RetryPolicy)."""

    max_restarts: int = 4
    budget_window_s: float = 300.0
    retry_step_once: bool = True
    backoff_base_s: float = 0.02
    backoff_max_s: float = 1.0
    backoff_jitter: float = 0.25
    seed: int = 0
    sleep: Callable[[float], None] = time.sleep


@dataclasses.dataclass(frozen=True)
class WatchdogPolicy:
    """Step-watchdog tuning. ``stall_timeout_s`` is measured on the
    scheduler's clock (virtual in tests); ``poll_s`` is the real-time
    cadence of the thread started by ``scheduler.start()``."""

    enabled: bool = True
    stall_timeout_s: float = 30.0
    poll_s: float = 0.5


class JournalEntry:
    """One replayable stream: the request object carries the full replay
    state (original prompt, every emitted token, the seeded sampling
    stream, speculation config and adaptive-k EMA)."""

    __slots__ = ("req", "admitted_seq")

    def __init__(self, req: "Request", admitted_seq: int):
        self.req = req
        self.admitted_seq = admitted_seq


class GenerationJournal:
    """Replay log of every slot-resident stream, keyed by request id. It
    holds no device state: replay is recompute-prefill of
    ``original_prompt + generated``, which the per-token-count sampling
    noise makes byte-exact."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: dict = {}

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def record(self, req: "Request", admitted_seq: int) -> None:
        with self._lock:
            self._entries[req.id] = JournalEntry(req, admitted_seq)

    def discard(self, req: "Request") -> None:
        with self._lock:
            self._entries.pop(req.id, None)

    def entries(self) -> List[JournalEntry]:
        """Live entries in admission order (FCFS replay order)."""
        with self._lock:
            return sorted(self._entries.values(), key=lambda e: e.admitted_seq)

    def drain(self) -> List[JournalEntry]:
        with self._lock:
            out = sorted(self._entries.values(), key=lambda e: e.admitted_seq)
            self._entries.clear()
            return out

    # Durable-serving hooks: no-ops here, overridden by
    # serving.durable.DurableJournal to mirror the journal into the WAL.
    # The scheduler calls note_token from every emitted-token path and
    # flush_step once per scheduling iteration (the group-commit
    # boundary); on the base class, the scheduler never imports the
    # serving tier.
    def note_token(self, req: "Request", token: int) -> None:
        pass

    def flush_step(self) -> None:
        pass


class EngineSupervisor:
    """Turns a step failure into the narrowest possible outcome:
    absorbed retry > quarantine > engine restart + journal replay >
    declared engine death."""

    def __init__(
        self,
        scheduler: "ContinuousBatchingScheduler",
        policy: Optional[RecoveryPolicy] = None,
    ):
        self.scheduler = scheduler
        self.policy = policy or RecoveryPolicy()
        self.stats = scheduler.recovery_stats
        self._rng = random.Random(f"supervisor|{self.policy.seed}")
        self._restart_times: List[float] = []
        self._consecutive = 0  # restarts since the last healthy step
        self._stall_lock = threading.Lock()
        # heartbeat seq the watchdog tripped on; popped by the
        # sequential ladders and the pipeline's consume via _consume_stall
        self._stalled_seq: Optional[int] = None  # guarded-by: _stall_lock
        self.failed = False  # restart budget exhausted; engine declared dead

    def note_engine_recovered(self) -> None:
        """A half-open probe succeeded against a declared-dead engine:
        the spent restart budget is forgiven."""
        self.failed = False
        self._restart_times.clear()
        self._consecutive = 0

    # ------------------------------------------------------------ watchdog
    def mark_stalled(self, seq: int) -> None:
        """Watchdog: the device call with heartbeat ``seq`` is stale; its
        result must be discarded."""
        with self._stall_lock:
            self._stalled_seq = max(self._stalled_seq or 0, seq)

    def _consume_stall(self, since_seq: int) -> bool:
        """True only when the flagged stall belongs to a device call
        issued after ``since_seq``, one of the caller's own calls. A trip
        on some other stamped section (an admission prefill, a probe, the
        recovery path itself) must not condemn a later healthy step."""
        with self._stall_lock:
            seq, self._stalled_seq = self._stalled_seq, None
            return seq is not None and seq > since_seq

    # ---------------------------------------------------------------- step
    def run_step(self, kind: str, step_fn, states: Sequence["_Running"], probe):
        """Run one batched device step under supervision. Returns the
        step's output, or None when the failure was fully handled here
        (quarantine or journal replay): the scheduler then skips its
        scatter phase."""
        sched = self.scheduler
        seq0 = sched._hb_seq  # stalls flagged past this are OUR calls
        try:
            out = sched._device(step_fn)
        except Exception as e:
            # the failing step goes on the flight ring first, so every
            # incident snapshot cut after it contains it
            sched.flight.record_event("step_failed", step=kind, error=repr(e)[:200])
            if self._consume_stall(seq0):
                self._restart_and_replay(e, kind)
                return None
            if sched.engine.donate:
                # a donating engine's failed step is not retried or
                # bisected (the JAX engine's donated cache buffers are
                # gone): reset + journal replay, byte-exact
                self._restart_and_replay(e, kind)
                return None
            if not self.policy.retry_step_once:
                self._handle_double_failure(e, kind, states, probe)
                return None
            self.stats.incr("step_retries")
            sched.flight.record_event("step_retry", step=kind)
            try:
                out = sched._device(step_fn)
            except Exception as e2:
                sched.flight.record_event("step_failed", step=kind, error=repr(e2)[:200])
                if self._consume_stall(seq0):
                    self._restart_and_replay(e2, kind)
                    return None
                self._handle_double_failure(e2, kind, states, probe)
                return None
        if self._consume_stall(seq0):
            # the watchdog already tripped the breaker and reaped expired
            # handles; the step's late result is stale, so replay instead
            self._restart_and_replay(
                StalledStepError(f"{kind} step exceeded the watchdog stall timeout"),
                kind,
            )
            return None
        self._consecutive = 0  # healthy step: the backoff curve restarts
        return out

    def resume_step(self, kind, first_error, step_fn, states, probe, since_seq):
        """A PIPELINED step failed. Resume the sequential ladder from the
        point just after a synchronous step's first failure, so the
        outcome AND the accounting match ``run_step``: a retryable error
        is re-run invisibly (what RetryPolicy.run would have done), a
        hard error pays one breaker failure, then retry -> bisect ->
        restart. ``since_seq`` scopes stall flags to the failed chain's
        own device calls."""
        sched = self.scheduler
        if sched.retry.would_retry(first_error):
            return self.run_step(kind, step_fn, states, probe)
        sched.flight.record_event("step_failed", step=kind, error=repr(first_error)[:200])
        sched.breaker.record_failure()
        if self._consume_stall(since_seq):
            self._restart_and_replay(first_error, kind)
            return None
        if sched.engine.donate:
            self._restart_and_replay(first_error, kind)
            return None
        if not self.policy.retry_step_once:
            self._handle_double_failure(first_error, kind, states, probe)
            return None
        self.stats.incr("step_retries")
        sched.flight.record_event("step_retry", step=kind)
        try:
            out = sched._device(step_fn)
        except Exception as e2:
            sched.flight.record_event("step_failed", step=kind, error=repr(e2)[:200])
            if self._consume_stall(since_seq):
                self._restart_and_replay(e2, kind)
                return None
            self._handle_double_failure(e2, kind, states, probe)
            return None
        if self._consume_stall(since_seq):
            self._restart_and_replay(
                StalledStepError(f"{kind} step exceeded the watchdog stall timeout"),
                kind,
            )
            return None
        self._consecutive = 0
        return out

    def _handle_double_failure(self, err, kind, states, probe) -> None:
        """The step failed twice. Bisect with subset probes: a strict
        subset that reproducibly fails alone is quarantined (a batch of
        one fails its request); anything else is an engine-level fault."""
        blamed = self._bisect(list(states), probe)
        if blamed and (len(blamed) < len(states) or len(states) == 1):
            for s in blamed:
                self.scheduler._quarantine(s, err)
            return
        self._restart_and_replay(err, kind)

    def _bisect(self, states, probe) -> List["_Running"]:
        """Probe subsets of the failed batch (outputs discarded; cache
        writes are idempotent replays of the same step) to isolate
        requests that crash on their own. Probes bypass retry/breaker."""

        def failing(sub) -> bool:
            try:
                probe(sub)
            except Exception:
                return True
            return False

        def rec(sub):
            if not failing(sub):
                return []
            if len(sub) == 1:
                return list(sub)
            mid = len(sub) // 2
            return rec(sub[:mid]) + rec(sub[mid:])

        return rec(list(states))

    # ------------------------------------------------------------- restart
    def handle_engine_nan(self, kind: str) -> None:
        """Every live slot's logits went non-finite at once: nothing to
        pin on one request, so reset and replay (the in-place rezero
        also clears any NaN the batch wrote)."""
        self._restart_and_replay(
            RuntimeError(f"non-finite logits across all slots at {kind} step"), kind
        )

    def _restart_and_replay(self, cause: BaseException, kind: str) -> None:
        """Reset the engine and rebuild every journaled stream by
        recompute-replay, with backoff and a sliding restart budget. A
        failure during recovery is a double fault: it consumes another
        budget unit and backs off further."""
        sched = self.scheduler
        pol = self.policy
        # the overlap frontier's in-flight step (if any) is chained on
        # state this reset tears down: discard it first (idempotent)
        sched._discard_frontier()
        # postmortem first: the snapshot shows the engine's last steps
        # (the step_failed marker included) before the reset; attached to
        # the cause, so a later give-up's error still carries it
        snap = sched.flight.incident(
            "restart", step=kind, error=repr(cause)[:200],
            journal_entries=len(sched.journal),
        )
        if getattr(cause, "flight_snapshot", None) is None:
            try:
                cause.flight_snapshot = snap
            except Exception:
                pass  # exceptions with __slots__ cannot carry the dump
        while True:
            now = sched.clock()
            self._restart_times = [
                t for t in self._restart_times if now - t <= pol.budget_window_s
            ]
            if len(self._restart_times) >= pol.max_restarts:
                self._give_up(cause)
                return
            self._restart_times.append(now)
            self._consecutive += 1
            pol.sleep(
                backoff_delay(
                    self._consecutive,
                    base_s=pol.backoff_base_s,
                    max_s=pol.backoff_max_s,
                    jitter=pol.backoff_jitter,
                    rng=self._rng,
                )
            )
            try:
                # stamped: a reset that wedges on a dead device stays
                # visible to the watchdog
                with sched._stamped():
                    faults.inject(faults.GENERATION_JOURNAL_REPLAY, sched.journal.entries())
                    sched.engine.reset()
                    sched._rebuild_from_journal()
            except Exception as e:  # double fault: burn another budget unit
                cause = e
                sched.flight.record_event("double_fault", error=repr(e)[:200])
                continue
            self.stats.incr("recoveries")
            sched.flight.record_event("recovery", step=kind, consecutive=self._consecutive)
            # recovery proved the device responsive: close the breaker a
            # trip (or the crash's recorded failures) opened
            sched.breaker.record_success()
            return

    def _give_up(self, cause: BaseException) -> None:
        self.failed = True
        self.stats.incr("engine_failures")
        err = EngineFailedError(
            f"generation engine failed permanently: {self.policy.max_restarts} "
            f"restarts exhausted within {self.policy.budget_window_s}s "
            f"(last cause: {cause!r})"
        )
        err.__cause__ = cause
        err.flight_snapshot = self.scheduler.flight.incident(
            "engine_failed", error=repr(cause)[:200]
        )
        self.scheduler._fail_running_engine_dead(err)
        # queued-but-never-admitted requests are NOT failed: they wait out
        # the outage behind the breaker or expire at their deadlines
        self.scheduler.breaker.trip()


class StepWatchdog:
    """Detects device steps that neither return nor raise.

    The scheduler stamps ``_heartbeat = (seq, started_at)`` around every
    device call; ``check()`` compares its age against the stall timeout
    on the scheduler's clock. One trip per seq: it opens the breaker,
    marks the supervisor so the step's late result is discarded, and
    fails deadline-expired handles (slots and blocks stay with the loop
    thread). A pipelined step stamps at dispatch and is re-stamped when
    its predecessor completes, so each step's age is its OWN device
    time; a consume that never returns ages its stamp until the trip."""

    def __init__(
        self,
        scheduler: "ContinuousBatchingScheduler",
        policy: Optional[WatchdogPolicy] = None,
    ):
        self.scheduler = scheduler
        self.policy = policy or WatchdogPolicy()
        self.stats = scheduler.recovery_stats
        self._last_tripped_seq = -1
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def check(self) -> bool:
        """One inspection (tests call this directly on virtual clocks).
        Returns True if a stall was newly detected."""
        sched = self.scheduler
        hb = sched._heartbeat  # (seq, started_at) or None; atomic read
        if hb is None:
            return False
        seq, started = hb
        if sched.clock() - started < self.policy.stall_timeout_s:
            return False
        tripped = seq != self._last_tripped_seq
        if tripped:
            self._last_tripped_seq = seq
            self.stats.incr("watchdog_trips")
            sched.flight.record_event(
                "watchdog_trip", heartbeat_seq=seq, stalled_s=sched.clock() - started,
            )
            sched.breaker.trip()  # health stops reporting a hung device ready
            sched.supervisor.mark_stalled(seq)
        # while the device is wedged the loop thread cannot expire
        # anything, so deadline enforcement moves here (handles only)
        self._reap_expired()
        return tripped

    def _reap_expired(self) -> None:
        sched = self.scheduler
        now = sched.clock()
        with sched._lock:
            queued = list(sched._queue)
        running = [s.req for s in list(sched._running.values())]
        admitting = sched._admitting  # popped for a (possibly wedged) prefill
        for req in queued + running + ([admitting] if admitting else []):
            if (
                req.deadline is not None
                and now >= req.deadline
                and req.handle._fail(
                    DeadlineExceededError("deadline expired during a stalled engine step")
                )
            ):
                sched.stats.incr("expired")

    def start(self) -> None:
        if not self.policy.enabled or self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(timeout=self.policy.poll_s):
            try:
                self.check()
            except Exception:
                # the watchdog must never die of a transient inspection
                # race; missing one poll beats losing stall detection
                pass
