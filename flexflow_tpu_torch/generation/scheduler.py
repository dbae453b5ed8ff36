"""Continuous batching: iteration-level scheduling of generation
requests (Orca, OSDI'22) over the block KV cache (port of the core of
``flexflow_tpu/generation/scheduler.py``).

Every ``step()`` runs ONE decode across the engine's fixed batch slots —
or ONE verify, when a running request speculates — and between steps the
batch recomposes freely —

* **join-mid-flight**: a queued request is admitted (FCFS) the moment a
  slot AND enough cache blocks are free; it prefills and decodes
  alongside sequences that are hundreds of tokens in;
* **prefix reuse**: admission matches the prompt against the engine's
  cross-request prefix cache (``prefix.py``), shares the cached blocks
  (swapping offloaded ones back in, copying the boundary block of a
  fully covered prompt) and prefills only the suffix; the prompt's
  written blocks join the cache after a finite prefill. Unreferenced
  cached blocks are reclaimed (offloaded to the host tier) before a
  request waits or a running one is preempted, and a preempted
  sequence's blocks are stashed in the cache for its re-admission;
* **free-on-finish**: a sequence hitting EOS / max-tokens / its deadline
  releases its blocks in the same step;
* **preempt-by-recompute**: if the cache cannot grow a running sequence,
  the youngest running sequence is evicted — blocks freed, prompt +
  generated-so-far re-queued at the FRONT — and later re-prefilled
  (vLLM's recompute preemption). Sampling noise is indexed by
  generated-token count, so a preempted request's token stream
  continues exactly where it left off;
* **speculation**: a request submitted with a SpeculationConfig drafts up
  to its adaptive k tokens per iteration, and the step verifies every
  slot's window in ONE fixed-shape ``engine.verify`` (a plain request in
  the batch is a zero-draft window, sampled exactly as decode samples).
  Blocks are grown for the whole window; under cache pressure the window
  shrinks before anyone is preempted, and the blocks a partly accepted
  window no longer covers are returned;
* **self-healing** (``recovery.py``): every admitted stream is entered in
  a :class:`GenerationJournal`; batched device steps run under an
  :class:`EngineSupervisor` (retry once, bisect and quarantine, or
  ``engine.reset()`` + journal replay under a restart budget), device
  calls run under ``RetryPolicy`` and a :class:`CircuitBreaker`, NaN
  logits are blamed per slot (quarantine) or batch-wide (restart), and a
  :class:`StepWatchdog` on a heartbeat catches wedged steps;
* **constrained decoding** (``constrained/``): a request submitted with a
  compiled grammar carries an automaton cursor (``mask_state``), rebuilt
  at every admission by re-advancing over its generated tokens (so
  preemption and journal replay just drop it); each step it takes part
  in — its prefill, decode or verify — adds its grammar rows to the
  logits, drafts are cut to the longest prefix the grammar accepts, and
  a refused advance quarantines that one request at the next iteration;
* **overlapped decode** (on by default; ``overlap=False`` gives the
  sequential loop): steady-state decode is a two-deep pipeline. Step
  N+1 is dispatched, its tokens carried on the device from step N's
  output, before step N is consumed, so step N's readback and the
  host's bookkeeping run while step N+1 executes. An in-flight
  *frontier* of at most one step is drained deterministically on every
  non-steady event (admission, EOS/finish, cache pressure,
  cancel/deadline, speculation, failure, watchdog trip, shutdown), so
  supervision, NaN blame and journal replay see the sequential
  semantics: streams are token-identical with overlap on and off. The
  verify path stays sequential: drafting needs step N's tokens on the
  host, and so does a constrained slot's next grammar row.

The queue is bounded (:class:`QueueFullError`) and requests carry
deadlines (:class:`DeadlineExceededError` before OR during generation),
on an injectable clock so tests run on virtual time. ``step()`` does one
iteration and returns; ``start()`` runs it on a background thread (with
the watchdog) and ``stop(drain)`` ends it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from ..runtime import faults
from ..serving.resilience import (
    CircuitBreaker,
    CircuitOpenError,
    DeadlineExceededError,
    QueueFullError,
    RetryPolicy,
    ShuttingDownError,
)
from ..serving.stats import ConstrainedStats
from .constrained.errors import MaskDeadEndError
from .decoder import params_to
from .engine import GenerationEngine, InFlightDecode, SamplingParams
from .recovery import (
    EngineFailedError,
    EngineSupervisor,
    GenerationJournal,
    PoisonedRequestError,
    RecoveryPolicy,
    RecoveryStats,
    StalledStepError,
    StepWatchdog,
    WatchdogPolicy,
)
from .speculative.drafter import SpeculationConfig, build_drafter

_END = object()  # token-stream sentinel
_request_ids = itertools.count(1)


class GenerationHandle:
    """Caller's view of one request: a Future of the generated token
    list plus a per-token stream."""

    def __init__(self, request: "Request"):
        self._request = request
        self.future: Future = Future()
        self._tokens: "queue.Queue" = queue.Queue()
        # the loop and watchdog threads race to settle a handle; the
        # claim's winner settles it, the loser does nothing
        self._settle_lock = threading.Lock()
        self._settled = False

    def _claim(self) -> bool:
        with self._settle_lock:
            if self._settled or self.future.done():
                return False
            self._settled = True
            return True

    def done(self) -> bool:
        return self.future.done()

    def result(self, timeout: Optional[float] = None) -> List[int]:
        return self.future.result(timeout=timeout)

    def cancel(self) -> None:
        """Ask the scheduler to drop this request at its next step."""
        self._request.cancelled = True

    def tokens(self, timeout: Optional[float] = None):
        """Iterate generated tokens as they are produced. Raises the
        request's failure if it errors mid-stream."""
        while True:
            item = self._tokens.get(timeout=timeout)
            if item is _END:
                return
            if isinstance(item, BaseException):
                raise item
            yield item

    # -------------------------------------------------------- scheduler
    def _emit(self, token: int) -> None:
        self._tokens.put(token)

    def _finish(self, tokens: List[int]) -> None:
        if not self._claim():
            return
        self.future.set_result(tokens)
        self._tokens.put(_END)

    def _fail(self, err: BaseException) -> bool:
        """Returns True only if THIS call failed the handle (the losers
        of the loop/watchdog race must not count twice)."""
        if not self._claim():
            return False
        self.future.set_exception(err)
        self._tokens.put(err)
        self._tokens.put(_END)
        return True


class Request:
    """One generation request. ``prompt`` may grow on preemption (the
    generated prefix is folded in for recompute); ``n_generated`` is the
    TOTAL generated count across preemptions, which also indexes the
    request's sampling noise stream. A speculating request carries its
    drafter and its adaptive k (``spec_k``, inside [1, speculation.k]).
    A constrained request carries its compiled grammar (``grammar``, a
    :class:`~flexflow_tpu_torch.generation.constrained.TokenDFA` shared
    across requests) and its automaton cursor (``mask_state``, rebuilt
    from ``generated`` at each admission); ``mask_error`` parks a refused
    advance for the step loop's quarantine sweep."""

    def __init__(
        self,
        prompt: List[int],
        sampling: SamplingParams,
        deadline: Optional[float] = None,
        speculation: Optional[SpeculationConfig] = None,
        drafter=None,
        grammar=None,
        response_format: Optional[Dict] = None,
    ):
        self.id = next(_request_ids)
        self.original_prompt = list(prompt)
        self.prompt = list(prompt)  # prompt + recomputed prefix
        self.sampling = sampling
        self.deadline = deadline  # absolute, scheduler clock
        # effective budget, possibly clamped to the cache room the
        # scheduler can actually give this sequence
        self.max_new = sampling.max_new_tokens
        self.generated: List[int] = []  # tokens generated so far (total)
        self.cancelled = False
        self.preemptions = 0
        self.replays = 0  # journal-replay recoveries this stream rode out
        self.handle = GenerationHandle(self)
        # speculation state: live k adapts inside [1, config.k]; the
        # drafter is a pure function of the prefix, so preemption needs
        # no drafter checkpointing
        self.speculation = speculation if (speculation and speculation.enabled) else None
        self.drafter = drafter if self.speculation else None
        self.spec_k = speculation.k if self.speculation else 0
        self.acc_ema: Optional[float] = None
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.grammar = grammar
        self.response_format = response_format
        self.mask_state = None
        self.mask_error: Optional[PoisonedRequestError] = None

    @property
    def n_generated(self) -> int:
        return len(self.generated)

    def update_speculation(self, proposed: int, accepted: int) -> None:
        """Fold one verification window into the adaptive-k state."""
        self.spec_proposed += proposed
        self.spec_accepted += accepted
        cfg = self.speculation
        if cfg is None or proposed <= 0:
            return
        rate = accepted / proposed
        self.acc_ema = (
            rate
            if self.acc_ema is None
            else cfg.ema_alpha * rate + (1.0 - cfg.ema_alpha) * self.acc_ema
        )
        if not cfg.adaptive:
            return
        if self.acc_ema < cfg.low_acceptance:
            self.spec_k = max(1, self.spec_k - 1)
        elif self.acc_ema >= cfg.high_acceptance:
            self.spec_k = min(cfg.k, self.spec_k + 1)

    def finished(self) -> bool:
        if self.n_generated >= self.max_new:
            return True
        eos = self.sampling.eos_id
        return eos is not None and bool(self.generated) and self.generated[-1] == eos


class _Running:
    """Slot-resident state for an admitted request."""

    __slots__ = ("req", "slot", "blocks", "cached_len", "admitted_seq", "step_k",
                 "shared_idx", "shared_entries")

    def __init__(self, req: Request, slot: int, blocks: List[int], cached_len: int,
                 admitted_seq: int, shared_idx=None, shared_entries=None):
        self.req = req
        self.slot = slot
        self.blocks = blocks
        self.cached_len = cached_len  # cache positions written so far
        self.admitted_seq = admitted_seq  # admission order, for LIFO preemption
        self.step_k = 0  # drafts planned for THIS step (<= req.spec_k)
        # prefix caching: table positions whose blocks the prefix index
        # owns (refcounted, immutable, freed by the index — never by this
        # sequence) and the entries this sequence holds
        self.shared_idx = shared_idx if shared_idx is not None else set()
        self.shared_entries = shared_entries if shared_entries is not None else []


class _Frontier:
    """The overlap pipeline's in-flight frontier: AT MOST ONE outstanding
    decode step. Holds the dispatch-time slot states and the host-side
    argument arrays (bumped by one for the next dispatch of the same
    composition), the step's heartbeat seq, and ``seq0``, the heartbeat
    seq just before the chain began: a stall flagged on any later seq
    belongs to this chain and voids its late result. Loop thread only."""

    __slots__ = ("handle", "states", "positions", "active", "temps", "top_ks",
                 "seeds", "counts", "tables", "sig", "hb_seq", "seq0")

    def __init__(self, handle: InFlightDecode, states, positions, active, temps, top_ks,
                 seeds, counts, tables, sig, hb_seq, seq0):
        self.handle = handle
        self.states = states
        self.positions = positions
        self.active = active
        self.temps = temps
        self.top_ks = top_ks
        self.seeds = seeds
        self.counts = counts
        self.tables = tables
        self.sig = sig
        self.hb_seq = hb_seq
        self.seq0 = seq0


class ContinuousBatchingScheduler:
    """``speculation`` is the default policy of requests submitted without
    their own; ``draft_params`` back ``method="draft_model"`` drafters
    (moved to the engine's device). ``breaker``/``retry`` guard device
    calls, ``recovery``/``watchdog`` tune the supervisor and the stall
    watchdog, and ``overlap`` (default on) selects the pipelined decode
    loop."""

    def __init__(
        self,
        engine: GenerationEngine,
        *,
        max_queue: int = 256,
        clock: Callable[[], float] = time.monotonic,
        breaker: Optional[CircuitBreaker] = None,
        retry: Optional[RetryPolicy] = None,
        idle_wait_s: float = 0.002,
        speculation: Optional[SpeculationConfig] = None,
        draft_params=None,
        recovery: Optional[RecoveryPolicy] = None,
        watchdog: Optional[WatchdogPolicy] = None,
        overlap: Optional[bool] = None,
    ):
        self.engine = engine
        self.max_queue = max_queue
        self.clock = clock
        self.breaker = breaker or CircuitBreaker(clock=clock)
        self.retry = retry or RetryPolicy()
        self.idle_wait_s = idle_wait_s
        self.speculation_default = speculation
        self.draft_params = (
            None if draft_params is None else params_to(draft_params, engine.device)
        )
        self._queue: deque = deque()
        self._running: Dict[int, _Running] = {}  # slot -> state
        self._free_slots = list(range(engine.max_batch_slots - 1, -1, -1))
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._alive = False
        self._draining = False
        self._hard_stop = False
        self._stopped = False  # a started-then-stopped scheduler rejects submits
        self._admitted_seq = itertools.count()
        self.preemptions = 0
        # admitted / completed / expired / cancelled / rejected / failed,
        # and the speculation windows: spec_windows / spec_proposed /
        # spec_accepted / spec_emitted / drafter_errors
        self.counts: Dict[str, int] = {}
        self._counts_lock = threading.Lock()
        # overlapped decode: the at-most-one-deep frontier (loop thread
        # only) and plain counters: dispatches through the pipeline,
        # frontier drains by reason, in-flight steps discarded
        self.overlap = True if overlap is None else bool(overlap)
        self._pipe: Optional[_Frontier] = None
        self.pipe_dispatches = 0
        self.pipe_drains: Dict[str, int] = {}
        self.pipe_discards = 0
        # self-healing: journal + supervisor + watchdog. _heartbeat is
        # (seq, started_at) while a device call is in flight, the
        # watchdog's stall signal
        self.recovery_stats = RecoveryStats()
        # constrained decoding: grammar-cache and masked-step counters (a
        # GrammarCache built with this object counts its compiles here)
        self.constrained_stats = ConstrainedStats()
        self.journal = GenerationJournal()
        self.supervisor = EngineSupervisor(self, recovery)
        self.watchdog = StepWatchdog(self, watchdog)
        self._heartbeat = None
        self._hb_seq = 0
        # the request popped for admission but not yet slot-resident,
        # visible to the watchdog's deadline reaper while its prefill runs
        self._admitting: Optional[Request] = None

    def _incr(self, name: str, n: int = 1) -> None:
        with self._counts_lock:
            self.counts[name] = self.counts.get(name, 0) + n

    # ------------------------------------------------------------- submit
    def submit(
        self,
        prompt: Sequence[int],
        sampling: Optional[SamplingParams] = None,
        deadline_s: Optional[float] = None,
        speculation: Optional[SpeculationConfig] = None,
        grammar=None,
        response_format: Optional[Dict] = None,
    ) -> GenerationHandle:
        """Enqueue one request (FCFS). Raises QueueFullError when the
        bounded queue is full, CircuitOpenError while the breaker holds
        traffic, ShuttingDownError while draining or after ``stop()``,
        DeadlineExceededError for an already-expired budget, and
        ValueError for a prompt that can never be served.
        ``speculation`` turns on (exact) speculative decoding for this
        request; None falls back to the scheduler's default policy.
        ``grammar`` is a compiled constrained-decoding TokenDFA (see
        ``generation/constrained/``), checked against the engine's
        vocabulary; ``response_format`` is the wire spec it came from."""
        if self._draining:
            raise ShuttingDownError("generation scheduler draining")
        if self._stopped:
            raise ShuttingDownError("generation scheduler stopped")
        sampling = sampling or SamplingParams()
        if not prompt:
            raise ValueError("empty prompt")
        if len(prompt) > self.engine.buckets[-1]:
            raise ValueError(
                f"prompt length {len(prompt)} exceeds max bucket {self.engine.buckets[-1]}"
            )
        room = self.engine.max_seq_len - len(prompt)
        if room < 1:
            raise ValueError(f"prompt fills max_seq_len {self.engine.max_seq_len}")
        if (
            self.engine.cache_config.blocks_for(len(prompt) + 1)
            > self.engine.allocator.num_total
        ):
            raise ValueError("prompt exceeds total cache capacity; can never be admitted")
        if grammar is not None and grammar.vocab_size != self.engine.cfg.vocab_size:
            raise ValueError(
                f"grammar compiled against vocab {grammar.vocab_size}, "
                f"engine vocab is {self.engine.cfg.vocab_size}"
            )
        if deadline_s is not None and deadline_s <= 0:
            self._incr("expired")
            raise DeadlineExceededError("deadline already expired at submit")
        with self._lock:
            # ready(), not allow(): submit only enqueues; the half-open
            # probe slot is claimed by the admission that calls the device
            if not self.breaker.ready():
                self._incr("rejected")
                raise CircuitOpenError("generation circuit open")
            if len(self._queue) >= self.max_queue:
                self._incr("rejected")
                raise QueueFullError(f"generation queue full ({self.max_queue})")
            deadline = None if deadline_s is None else self.clock() + deadline_s
            spec = speculation if speculation is not None else self.speculation_default
            drafter = None
            if spec is not None and spec.enabled:
                # clamp to the engine's verify window so per-request k
                # NEVER changes the step's shape
                if spec.k > self.engine.max_spec_tokens:
                    spec = dataclasses.replace(spec, k=self.engine.max_spec_tokens)
                drafter = build_drafter(
                    spec, draft_params=self.draft_params, max_seq_len=self.engine.max_seq_len,
                )
            req = Request(list(prompt), sampling, deadline=deadline, speculation=spec,
                          drafter=drafter, grammar=grammar, response_format=response_format)
            # the sequence can never outgrow max_seq_len NOR the TOTAL
            # cache: a sequence needing more blocks than exist would
            # preempt itself forever at the head of the FCFS queue
            cache_room = (
                self.engine.allocator.num_total * self.engine.cache_config.block_size
                - len(prompt)
            )
            req.max_new = min(sampling.max_new_tokens, room, cache_room)
            self._queue.append(req)
        self._incr("admitted")
        self._wake.set()
        return req.handle

    # ------------------------------------------------------------ control
    def start(self) -> None:
        """Run ``step()`` on a background thread, with the watchdog."""
        if self._alive:
            return
        self._alive = True
        self._draining = False
        self._hard_stop = False
        self._stopped = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        self.watchdog.start()

    def stop(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Graceful by default: finish queued + running requests, then
        exit. ``drain=False`` fails outstanding work at once with a typed
        ShuttingDownError."""
        if self._thread is None:
            # never-started (manual-step) scheduler: honor the drain
            # contract inline, so queued futures never hang
            self._draining = True
            if drain:
                while self.has_work() and self.step():
                    pass
            self._abort_all(ShuttingDownError("scheduler stopped"))
            self._draining = False
            self._stopped = True
            return
        self._draining = True
        self._alive = False
        if not drain:
            self._hard_stop = True  # the loop exits after the current step
        self._wake.set()
        self._thread.join(timeout=timeout)
        if self._thread.is_alive() and self._heartbeat is None:
            # alive but NOT inside a device call: the drain is starved
            # (an open breaker holding queued requests), not wedged
            self._hard_stop = True
            self._wake.set()
            self._thread.join(timeout=5.0)
        wedged = self._thread.is_alive()
        self._thread = None
        if wedged:
            # a wedged step keeps ownership of the slot/allocator state;
            # the watchdog stays alive to fail deadline-carrying handles
            return
        if drain:
            while self.has_work() and self.step():
                pass
        if self.has_work():
            # leftovers that cannot make progress: fail them typed
            self._abort_all(ShuttingDownError("scheduler stopped"))
        self.watchdog.stop()
        self._draining = False
        self._stopped = True

    def _abort_all(self, err: BaseException) -> None:
        """Shutdown-only teardown (``err`` is a typed ShuttingDownError)."""
        self._discard_frontier()  # shutdown: in-flight results are moot
        with self._lock:
            queued, self._queue = list(self._queue), deque()
        for req in queued:
            if req.handle._fail(err):
                self._incr("failed")
        for state in list(self._running.values()):
            self._release(state)
            if state.req.handle._fail(err):
                self._incr("failed")

    def _fail_running_engine_dead(self, err: EngineFailedError) -> None:
        """Restart budget exhausted: every slot-resident stream is lost to
        this engine and fails with the typed EngineFailedError. The
        engine is reset, so slot/allocator bookkeeping restarts from
        empty rather than freeing stale block ids into the fresh list."""
        self.journal.drain()
        states = sorted(self._running.values(), key=lambda s: s.admitted_seq)
        self._reset_slots()
        self.engine.reset()
        for state in states:
            state.blocks = []
            state.shared_idx = set()
            state.shared_entries = []
            if state.req.handle.done():
                continue
            if state.req.finished():
                # finished at a pipeline consume, release still pending:
                # it holds every token
                state.req.handle._finish(list(state.req.generated))
                self._incr("completed")
            elif state.req.handle._fail(err):
                self._incr("failed")
        # replay-requeued MID-STREAM requests are as lost as the
        # slot-resident ones; fresh queued requests stay held
        with self._lock:
            keep: deque = deque()
            for req in self._queue:
                if req.n_generated > 0:
                    if req.handle._fail(err):
                        self._incr("failed")
                else:
                    keep.append(req)
            self._queue = keep

    def _rebuild_from_journal(self) -> None:
        """Journal replay after ``engine.reset()``: every live stream is
        requeued at the FRONT with its generated tokens folded into the
        prompt; the preempt-by-recompute path then resumes each stream
        exactly."""
        entries = self.journal.drain()
        self._reset_slots()
        replayed = 0
        requeue = []
        for entry in entries:
            req = entry.req
            if req.handle.done():  # reaped (deadline) while the engine was down
                continue
            if req.finished():
                # completed its budget/EOS at a pipeline consume before
                # the teardown: it holds every token
                req.handle._finish(list(req.generated))
                self._incr("completed")
                continue
            req.prompt = req.original_prompt + list(req.generated)
            # the journal IS the grammar state: rebuilt at re-admission
            req.mask_state = None
            req.replays += 1
            replayed += req.n_generated
            requeue.append(req)
        with self._lock:
            for req in reversed(requeue):
                self._queue.appendleft(req)
        if replayed:
            self.recovery_stats.incr("replayed_tokens", replayed)
        self._wake.set()

    def _reset_slots(self) -> None:
        """Post-``engine.reset()`` slot bookkeeping: every slot empty and
        every outstanding block table invalid wholesale (no per-block
        frees after the allocator's reset)."""
        self._running.clear()
        self._free_slots = list(range(self.engine.max_batch_slots - 1, -1, -1))

    def _quarantine(self, state: _Running, err: BaseException) -> None:
        """Fail ONE poisoned request and keep the batch."""
        req = state.req
        self._release(state)
        if req.handle._fail(err):
            self._incr("failed")
            self.recovery_stats.incr("quarantined")

    def _sweep_mask_errors(self) -> None:
        """Quarantine running slots whose constrained stream parked a
        grammar error during token bookkeeping. ``_advance_mask`` never
        raises mid-emit (a refused advance must not unwind the scatter
        and take the batch's other slots with it), so the error waits one
        iteration here, where quarantine is safe."""
        for state in list(self._running.values()):
            err = state.req.mask_error
            if err is not None:
                state.req.mask_error = None
                self._quarantine(state, err)

    def ready(self) -> bool:
        return not self._draining and self.breaker.ready()

    def has_work(self) -> bool:
        return bool(self._queue) or bool(self._running)

    def cache_report(self) -> Dict:
        """Allocator state, the per-request block residency and the
        prefix cache's snapshot. A running request's private blocks
        (``blocks - shared_blocks``) plus the prefix index's resident
        blocks sum to ``used``: a shared block is counted once, by the
        index."""
        alloc = self.engine.allocator
        cfg = alloc.config
        free = alloc.num_free
        residency = [
            {"request_id": s.req.id, "slot": s.slot, "blocks": len(s.blocks),
             "shared_blocks": len(s.shared_idx), "live_tokens": s.cached_len}
            for s in sorted(self._running.values(), key=lambda s: s.slot)
        ]
        return {
            "config": {"num_blocks": cfg.num_blocks, "block_size": cfg.block_size,
                       "bytes_per_block": cfg.bytes_per_block},
            "blocks": {"total": alloc.num_total, "free": free, "used": alloc.num_total - free},
            "queue_depth": len(self._queue),
            "residency": residency,
            "prefix_cache": self.engine.prefix_cache.snapshot(),
        }

    def _loop(self) -> None:
        while (self._alive or (self._draining and self.has_work())) and not self._hard_stop:
            if not self.step():
                self._wake.wait(timeout=self.idle_wait_s)
                self._wake.clear()

    # ---------------------------------------------------------- internals
    def _release(self, state: _Running) -> None:
        self.journal.discard(state.req)
        # private blocks go back to the allocator; shared (index-owned)
        # blocks only drop this sequence's reference
        self.engine.release_admission(state.blocks, state.shared_idx, state.shared_entries)
        state.blocks = []
        state.shared_idx = set()
        state.shared_entries = []
        del self._running[state.slot]
        self._free_slots.append(state.slot)

    def _finish(self, state: _Running) -> None:
        self._release(state)
        state.req.handle._finish(list(state.req.generated))
        self._incr("completed")

    def _expire(self) -> None:
        now = self.clock()
        with self._lock:
            keep: deque = deque()
            for req in self._queue:
                if req.handle.done():
                    pass  # reaped by the watchdog during a stall; just drop
                elif req.cancelled:
                    if req.handle._fail(ShuttingDownError("request cancelled")):
                        self._incr("cancelled")
                elif req.deadline is not None and now >= req.deadline:
                    if req.handle._fail(DeadlineExceededError("deadline expired while queued")):
                        self._incr("expired")
                else:
                    keep.append(req)
            self._queue = keep
        for state in list(self._running.values()):
            req = state.req
            if req.handle.done():
                # failed by the watchdog's reaper: the resources are freed
                # here, the count was taken there
                self._release(state)
            elif req.cancelled:
                self._release(state)
                if req.handle._fail(ShuttingDownError("request cancelled")):
                    self._incr("cancelled")
            elif req.deadline is not None and now >= req.deadline:
                self._release(state)
                if req.handle._fail(DeadlineExceededError("deadline expired mid-generation")):
                    self._incr("expired")

    @contextlib.contextmanager
    def _stamped(self):
        """Heartbeat stamp around any section that can wedge on the
        device: the watchdog's only stall signal."""
        self._hb_seq += 1
        self._heartbeat = (self._hb_seq, self.clock())
        try:
            yield
        finally:
            self._heartbeat = None

    def _device(self, fn):
        """Run one device step under retry + breaker accounting, with a
        heartbeat stamped around the call."""
        with self._stamped():
            try:
                out = self.retry.run(fn)
            except Exception:
                self.breaker.record_failure()
                raise
        self.breaker.record_success()
        return out

    def _probe_call(self, fn):
        """A bisection probe's device call: heartbeat only, no retry or
        breaker (an expected crash while assigning blame is no health
        signal, but a stall during a probe must stay visible)."""
        with self._stamped():
            return fn()

    def _preempt_self(self, state: _Running) -> None:
        """Evict ``state`` for recompute: stash its computed blocks in the
        prefix cache, free the rest, fold its generated tokens into the
        prompt, and requeue it at the FRONT."""
        # the stash: its re-admission (and any request sharing the
        # prefix) re-matches the blocks; under continued pressure they
        # offload to the host tier and swap back in
        self.engine.stash_prefix(state)
        self._release(state)
        req = state.req
        req.prompt = req.original_prompt + list(req.generated)
        req.mask_state = None  # rebuilt from `generated` at re-admission
        req.preemptions += 1
        self.preemptions += 1
        with self._lock:
            self._queue.appendleft(req)

    def _preempt_youngest(self, exclude: Optional[_Running] = None) -> bool:
        """Evict the youngest running sequence (vLLM's LIFO recompute
        victim) other than ``exclude``, the sequence trying to grow.
        Returns False when there is none."""
        victims = [s for s in self._running.values() if s is not exclude]
        if not victims:
            return False
        self._preempt_self(max(victims, key=lambda s: s.admitted_seq))
        return True

    def _admit(self) -> bool:
        """FCFS, cache-capacity-aware admission with prefix reuse.
        Returns True if the queue's head was admitted (prefilled) or
        failed."""
        engine = self.engine
        with self._lock:
            if not self._queue or not self._free_slots:
                return False
            # an OPEN breaker holds admission; after recovery_s the next
            # admission is the half-open probe
            if not self.breaker.allow():
                return False
            req = self._queue[0]
        if req.grammar is not None and req.mask_state is None:
            # constrained stream: rebuild the automaton cursor by
            # re-advancing over every emitted token (first admission starts
            # at the grammar's start state; preempt-recompute and journal
            # replay arrive here with mask_state dropped). A refused token
            # fails the ONE request typed
            try:
                req.mask_state = req.grammar.state_after(req.generated, req.sampling.eos_id)
            except Exception as e:
                with self._lock:
                    if self._queue and self._queue[0] is req:
                        self._queue.popleft()
                self.constrained_stats.incr("dead_end_failures")
                err = PoisonedRequestError(
                    f"request {req.id} could not rebuild its grammar state: {e}",
                    request_id=req.id, step="mask", reason="mask_advance",
                )
                if req.handle._fail(err):
                    self._incr("failed")
                    self.recovery_stats.incr("quarantined")
                return True
        plan = engine.prefix_plan(req.prompt)
        need = engine.cache_config.blocks_for(len(req.prompt) + 1) - plan.n_resident
        blocks = engine.allocator.allocate(need)
        if blocks is None:
            # unreferenced cached prefixes are reclaimed (offloaded to the
            # host tier) before the head waits; the swap-out device reads
            # ride the heartbeat
            with self._stamped():
                reclaimed = engine.reclaim_cached(need - engine.allocator.num_free)
            if reclaimed:
                blocks = engine.allocator.allocate(need)
        if blocks is None:
            return False
        with self._lock:
            self._queue.popleft()
            slot = self._free_slots.pop()
        with self._stamped():
            prep = engine.prepare_prefix(req.prompt, plan, blocks)
        if prep is None:
            # a failed swap-in could not be replaced: everything was
            # handed back; requeue the head and retry next iteration
            self._free_slots.append(slot)
            with self._lock:
                self._queue.appendleft(req)
            return False
        table, shared_idx, entries, prefix_len = prep
        self._admitting = req
        try:
            pf_mask = None
            if req.mask_state is not None:
                # the prefill samples the stream's next token: mask it as
                # a decode step would
                pf_mask = req.mask_state.mask_row(req.sampling.eos_id)
                self.constrained_stats.incr("masked_steps")
            token = self._device(
                lambda: engine.prefill_one(
                    req.prompt, table, req.sampling, sample_index=req.n_generated,
                    prefix_len=prefix_len, mask=pf_mask,
                )
            )
        except Exception as e:
            self._admitting = None
            engine.release_admission(table, shared_idx, entries)
            self._free_slots.append(slot)
            if self.supervisor.failed:
                # half-open probe against a still-dead engine: a HELD
                # request goes back to the front
                with self._lock:
                    self._queue.appendleft(req)
                return False
            if req.n_generated > 0:
                # a replayed/preempted stream whose client already holds
                # tokens: treat the failure as engine-level
                with self._lock:
                    self._queue.appendleft(req)
                self.supervisor._restart_and_replay(e, "prefill")
                return True
            if req.handle._fail(e):
                self._incr("failed")
            return True  # did work (and must not spin on the same head)
        if not bool(engine.last_finite[0]):
            # poisoned prompt: a single-sequence step needs no bisection
            self._admitting = None
            engine.release_admission(table, shared_idx, entries)
            self._free_slots.append(slot)
            err = PoisonedRequestError(
                f"request {req.id} produced non-finite logits at prefill",
                request_id=req.id, step="prefill", reason="nan_logits",
            )
            if req.handle._fail(err):
                self._incr("failed")
                self.recovery_stats.incr("quarantined")
            return True
        # the prompt's written blocks join the prefix index only after the
        # finiteness check: non-finite K/V never becomes shared content
        engine.register_prefix(req.prompt, table, shared_idx, entries, prefix_len=prefix_len)
        state = _Running(
            req, slot, table, cached_len=len(req.prompt),
            admitted_seq=next(self._admitted_seq),
            shared_idx=shared_idx, shared_entries=entries,
        )
        self._running[slot] = state
        self._admitting = None
        if self.supervisor.failed:  # a dead engine just served a prefill
            self.supervisor.note_engine_recovered()
        self.journal.record(req, state.admitted_seq)
        if req.handle.done():  # the watchdog reaped it while the prefill ran
            self._release(state)
            return True
        self._emit_token(state, token)
        if req.finished():
            self._finish(state)
        return True

    def _emit_token(self, state: _Running, token: int) -> None:
        state.req.generated.append(int(token))
        state.req.handle._emit(int(token))
        self.journal.note_token(state.req, int(token))
        if state.req.mask_state is not None:
            self._advance_mask(state.req, int(token))

    def _advance_mask(self, req: Request, token: int) -> None:
        """Advance a constrained request's automaton over one emitted
        token. Never raises: a refused advance (an injected
        ``generation.mask_advance`` fault or replay divergence) parks a
        typed error on the request for :meth:`_sweep_mask_errors`. A
        cleanly exhausted grammar (accepting, no live continuation)
        clamps the budget so the stream completes this step."""
        ms = req.mask_state
        try:
            ms.advance(token, req.sampling.eos_id)
        except Exception as e:
            reason = "mask_dead_end" if isinstance(e, MaskDeadEndError) else "mask_advance"
            self.constrained_stats.incr("dead_end_failures")
            req.mask_error = PoisonedRequestError(
                f"request {req.id} grammar refused emitted token {token}: {e}",
                request_id=req.id, step="mask", reason=reason,
            )
            return
        if ms.exhausted() and not ms.done:
            # only EOS (when the request has one) is left: end the stream
            # instead of decoding against an everything-banned row
            req.max_new = req.n_generated

    def _plan_speculation(self) -> None:
        """Decide each running sequence's draft count for THIS step: its
        adaptive k, capped by the remaining token budget (never draft past
        max_new), the sequence-length ceiling, and — in _grow — cache
        pressure."""
        for state in self._running.values():
            req = state.req
            if req.drafter is None:
                state.step_k = 0
                continue
            budget = req.max_new - req.n_generated  # >= 1 while running
            pos_room = (self.engine.max_seq_len - 1) - state.cached_len
            state.step_k = max(0, min(req.spec_k, budget - 1, pos_room))

    def _grow(self) -> None:
        """Ensure every running sequence has cache blocks for its next
        window — up to step_k + 1 new positions. Under pressure, first
        shrink the window (cap speculation), then preempt-by-recompute."""
        for state in list(self._running.values()):
            if self._running.get(state.slot) is not state:
                continue  # preempted earlier in this sweep
            while True:
                need = self.engine.cache_config.blocks_for(
                    state.cached_len + state.step_k + 1
                )
                if len(state.blocks) >= need:
                    break
                got = self.engine.allocator.allocate(1)
                if got is None:
                    # evict an unreferenced cached prefix (offloading it
                    # to the host tier) before shrinking anyone's window
                    # or preempting a live sequence
                    with self._stamped():
                        reclaimed = self.engine.reclaim_cached(1)
                    if reclaimed:
                        got = self.engine.allocator.allocate(1)
                if got is not None:
                    state.blocks.extend(got)
                    continue
                if state.step_k > 0:
                    # cap on cache pressure: give up drafts before
                    # evicting anyone
                    state.step_k -= 1
                    continue
                if not self._preempt_youngest(exclude=state):
                    # nothing left to evict but this sequence itself:
                    # recompute it later when capacity returns
                    self._preempt_self(state)
                    break

    def _collect_slots(self, order):
        """Slot-indexed arrays a batched decode step needs: the seed token
        (last emitted, not yet cached), its cache position, block tables,
        the live mask, and per-slot sampling params (``seeds``/``counts``
        index each slot's sampling noise)."""
        b = self.engine.max_batch_slots
        last = np.zeros((b,), np.int32)
        start = np.zeros((b,), np.int32)
        tables = np.zeros((b, self.engine.max_blocks_per_seq), np.int32)
        active = np.zeros((b,), bool)
        temps = np.zeros((b,), np.float32)
        top_ks = np.zeros((b,), np.int32)
        seeds = np.zeros((b,), np.uint32)
        counts = np.zeros((b,), np.int32)
        for state in order:
            i = state.slot
            req = state.req
            last[i] = req.generated[-1] if req.generated else req.prompt[-1]
            start[i] = state.cached_len  # next cache position
            tables[i, : len(state.blocks)] = state.blocks
            active[i] = True
            temps[i] = req.sampling.temperature
            top_ks[i] = req.sampling.top_k
            seeds[i] = req.sampling.seed & 0xFFFFFFFF
            counts[i] = req.n_generated
        return last, start, tables, active, temps, top_ks, seeds, counts

    def _decode_mask(self, order):
        """The constrained slots' grammar rows for one decode step
        ({slot: [V] row}), or None when no live slot is constrained (the
        step then reads the engine's zero mask and uploads nothing)."""
        mask = {s.slot: s.req.mask_state.mask_row(s.req.sampling.eos_id)
                for s in order if s.req.mask_state is not None}
        if not mask:
            return None
        self.constrained_stats.incr("masked_steps", len(mask))
        return mask

    def _quarantine_nan(self, kind: str, order) -> bool:
        """Act on the step's per-slot finiteness flags. Partial blame
        quarantines the flagged request(s) and keeps everyone else (their
        tokens from this step are valid). Whole-batch blame is not
        data-dependent: restart and journal-replay instead (returns True:
        skip the scatter)."""
        ok = self.engine.last_finite
        live = [s for s in order if self._running.get(s.slot) is s]
        blamed = [s for s in live if not bool(ok[s.slot])]
        if not blamed:
            return False
        if len(blamed) == len(live) and len(live) > 1:
            self.supervisor.handle_engine_nan(kind)
            return True
        for state in blamed:
            self._quarantine(
                state,
                PoisonedRequestError(
                    f"request {state.req.id} produced non-finite logits at {kind} step",
                    request_id=state.req.id, step=kind, reason="nan_logits",
                ),
            )
        return False

    def _decode_step_fns(self, order):
        """The sequential decode step and its bisection probe over
        ``order``, from ONE slot collection (shared by the sequential
        iteration and the pipeline-failure re-run)."""
        b = self.engine.max_batch_slots
        (tokens, positions, tables, active, temps, top_ks, seeds,
         counts) = self._collect_slots(order)
        mask = self._decode_mask(order)

        def step():
            return self.engine.decode(tokens, positions, tables, active, temps, top_ks,
                                      seeds, counts, mask)

        def probe(subset):
            # blame-assignment probe: the same step (and the same mask)
            # with only ``subset`` active; outputs discarded, cache writes
            # idempotent
            act = np.zeros((b,), bool)
            for s in subset:
                act[s.slot] = True
            self._probe_call(
                lambda: self.engine.decode(tokens, positions, tables, act, temps, top_ks,
                                           seeds, counts, mask)
            )

        return step, probe

    def _decode_once(self) -> bool:
        if not self._running:
            return False
        order = sorted(self._running.values(), key=lambda s: s.slot)
        step, probe = self._decode_step_fns(order)
        out = self.supervisor.run_step("decode", step, order, probe)
        if out is None:
            return True  # failure handled: quarantined or journal-replayed
        if self._quarantine_nan("decode", order):
            return True
        self._scatter_decode(order, out)
        return True

    def _scatter_decode(self, order, out, defer_finish: bool = False):
        """Scatter one decode step's sampled tokens back onto the slot
        states. Returns (tokens emitted, finished states). With
        ``defer_finish`` (the pipeline) a finished slot's blocks are not
        released here: a successor step may still be writing them. A slot
        that ALREADY finished at a previous consume is skipped (its token
        in a drained in-flight step is one the sequential loop never
        decoded)."""
        n_live = 0
        finish = []
        for state in order:
            if self._running.get(state.slot) is not state:
                continue  # preempted/expired between collect and scatter
            if state.req.handle.done():
                continue  # watchdog-reaped mid-step; _expire releases it
            if state.req.finished():
                continue  # finished at a previous pipeline consume
            state.cached_len += 1
            self._emit_token(state, int(out[state.slot]))
            n_live += 1
            if state.req.finished():
                finish.append(state)
        if not defer_finish:
            for state in finish:
                self._finish(state)
        return n_live, finish

    # ----------------------------------------------------- overlap pipeline
    def _nonsteady(self, now: float) -> bool:
        """True when THIS iteration must run the sequential path (after a
        frontier drain): any event whose handling mutates slot or block
        state the in-flight step depends on, or whose semantics are
        sequential: admission, finish, cancel/deadline, speculation, a
        constrained slot (its next grammar row needs the token the
        in-flight step has not brought back yet), shutdown, a declared-dead
        engine."""
        if self._draining or self._hard_stop or self.supervisor.failed:
            return True
        if self._queue:
            with self._lock:
                queued = list(self._queue)
            for req in queued:
                if req.handle.done() or req.cancelled or (
                    req.deadline is not None and now >= req.deadline
                ):
                    return True  # queue expiry needs the sequential sweep
            if self._free_slots and self.breaker.ready():
                return True  # an admission could actually place
        for s in self._running.values():
            req = s.req
            if (
                req.handle.done()
                or req.cancelled
                or req.finished()
                or (req.deadline is not None and now >= req.deadline)
                or req.drafter is not None
                or req.grammar is not None
            ):
                return True
        return False

    def _discard_frontier(self) -> None:
        """Drop the in-flight step WITHOUT bookkeeping: its tokens are
        never emitted, and the next sequential step recomputes them (its
        K/V writes, at positions past every context, are rewritten from
        the same inputs). Swallows the step's own error."""
        f, self._pipe = self._pipe, None
        if f is None:
            return
        self.engine.discard_decode(f.handle)
        self.pipe_discards += 1
        self._heartbeat = None

    def _drain_frontier(self, reason: str) -> None:
        """Empty the pipeline before a non-steady event: consume the
        in-flight step with FULL bookkeeping, so the state afterwards is
        what a sequential scheduler would hold. Never raises: failures
        take the pipeline-failure path."""
        f, self._pipe = self._pipe, None
        if f is None:
            return
        self.pipe_drains[reason] = self.pipe_drains.get(reason, 0) + 1
        try:
            self._consume_and_finish(f)
        except Exception as e:
            self._pipeline_failure(e, f.seq0)

    def _consume_and_finish(self, f: _Frontier):
        """Consume one in-flight decode step: its readback, the stall
        arbitration, NaN blame, the token scatter; then, if a stream
        finished, drain the successor before releasing its blocks.
        Returns tokens emitted, or None when a failure was fully handled
        here. Device errors propagate to the caller's pipeline-failure
        handling."""
        try:
            faults.inject(faults.GENERATION_ASYNC_READBACK, ("decode", len(f.states)))
        except BaseException:
            self.engine.discard_decode(f.handle)  # its readback is lost with it
            raise
        out = self.engine.consume_decode(f.handle)
        # completion stamp: the successor only starts device work now, so
        # its heartbeat age is measured from here
        nf = self._pipe
        if nf is not None:
            self._heartbeat = (nf.hb_seq, self.clock())
            nf.handle.t_started = time.perf_counter()
        else:
            self._heartbeat = None
        if self.supervisor._consume_stall(f.seq0):
            # the watchdog tripped while this chain was in flight: the
            # late result is stale; discard everything and replay
            self._discard_frontier()
            self.supervisor._restart_and_replay(
                StalledStepError("decode step exceeded the watchdog stall timeout"),
                "decode",
            )
            return None
        ok = self.engine.last_finite
        live = [s for s in f.states if self._running.get(s.slot) is s]
        if any(not bool(ok[s.slot]) for s in live):
            # the successor was dispatched from this step's (poisoned)
            # tokens: discard it, then apply the standard blame rules
            self._discard_frontier()
            if self._quarantine_nan("decode", f.states):
                return None
        n_live, finish = self._scatter_decode(f.states, out, defer_finish=True)
        if finish:
            # the successor may still be writing into the finishing
            # streams' blocks: drain it (bookkept; its tokens for finished
            # slots are skipped) before any release
            if self._pipe is not None:
                self._drain_frontier("finish")
            for st in finish:
                if self._running.get(st.slot) is st and not st.req.handle.done():
                    self._finish(st)
        return n_live

    def _dispatch_pipeline(self, live, prev: Optional[_Frontier]) -> _Frontier:
        """Dispatch the next decode step without waiting. With an
        unconsumed predecessor the token input is its device output, and
        the argument arrays are the predecessor's, bumped in place."""
        b = self.engine.max_batch_slots
        sig = tuple((s.slot, s.req.id, len(s.blocks)) for s in live)
        covered = {s.slot for s in prev.states} if prev is not None else set()
        if prev is not None and prev.sig == sig:
            positions, active = prev.positions, prev.active
            temps, top_ks = prev.temps, prev.top_ks
            seeds, counts, tables = prev.seeds, prev.counts, prev.tables
            for s in live:  # same composition: everyone advances by one
                positions[s.slot] += 1
                counts[s.slot] += 1
        else:
            positions = np.zeros((b,), np.int32)
            active = np.zeros((b,), bool)
            temps = np.zeros((b,), np.float32)
            top_ks = np.zeros((b,), np.int32)
            seeds = np.zeros((b,), np.uint32)
            counts = np.zeros((b,), np.int32)
            tables = np.zeros((b, self.engine.max_blocks_per_seq), np.int32)
            for s in live:
                i = s.slot
                pend = 1 if i in covered else 0
                positions[i] = s.cached_len + pend
                counts[i] = s.req.n_generated + pend
                active[i] = True
                temps[i] = s.req.sampling.temperature
                top_ks[i] = s.req.sampling.top_k
                seeds[i] = s.req.sampling.seed & 0xFFFFFFFF
                tables[i, : len(s.blocks)] = s.blocks
        tokens_host = None
        if prev is None:
            tokens_host = np.zeros((b,), np.int32)
            for s in live:
                req = s.req
                tokens_host[s.slot] = req.generated[-1] if req.generated else req.prompt[-1]
        hb_prev = self._heartbeat
        seq0 = prev.seq0 if prev is not None else self._hb_seq
        self._hb_seq += 1
        seq = self._hb_seq
        self._heartbeat = (seq, self.clock())  # dispatch stamp
        try:
            handle = self.engine.decode_async(
                tokens_host, positions, tables, active, temps, top_ks, seeds, counts,
                carry=None if prev is None else prev.handle,
            )
        except Exception:
            self._heartbeat = hb_prev  # the step never went in flight
            raise
        return _Frontier(handle, list(live), positions, active, temps, top_ks, seeds,
                         counts, tables, sig, seq, seq0)

    def _pipeline_failure(self, e: BaseException, since_seq: int) -> None:
        """A pipelined dispatch or consume failed. Discard what is in
        flight, then give the failed step the sequential treatment from
        the point after its first failure (``supervisor.resume_step``). A
        ``donate`` engine goes straight to reset + journal replay."""
        self._discard_frontier()
        if self.engine.donate:
            self.supervisor._restart_and_replay(e, "decode")
            return
        order = [
            s for s in sorted(self._running.values(), key=lambda s: s.slot)
            if not s.req.handle.done() and not s.req.finished()
        ]
        if not order:
            return
        step, probe = self._decode_step_fns(order)
        out = self.supervisor.resume_step("decode", e, step, order, probe, since_seq)
        if out is None:
            return
        if self._quarantine_nan("decode", order):
            return
        self._scatter_decode(order, out)

    def _try_pipeline(self) -> Optional[bool]:
        """One overlapped-decode iteration. Returns None when the
        iteration must run sequentially instead (the frontier is drained
        by then); True when pipelined work happened. Steady state:
        dispatch step N+1 (its tokens carried from step N on the device),
        then consume step N, whose bookkeeping runs while N+1 executes."""
        now = self.clock()
        if self._nonsteady(now):
            # drain, then fall through to the sequential body in the SAME
            # iteration: the non-steady event must not wait an extra step
            self._drain_frontier("nonsteady")
            return None
        order = sorted(self._running.values(), key=lambda s: s.slot)
        if not order:
            if self._pipe is not None:  # defensive: should be unreachable
                self._drain_frontier("idle")
            return None
        f = self._pipe
        covered = {s.slot for s in f.states} if f is not None else set()
        # slots live at the NEXT dispatch: budget-predicted finishes are
        # excluded (sequential would have freed them before this step);
        # EOS cannot be predicted and is handled at consume
        live = []
        for s in order:
            pend = 1 if s.slot in covered else 0
            if s.req.n_generated + pend >= s.req.max_new:
                continue
            live.append(s)
        if not live:
            if f is None:
                return None
            # stream tail: nothing left to dispatch — consume only
            self._pipe = None
            try:
                self._consume_and_finish(f)
            except Exception as e:
                self._pipeline_failure(e, f.seq0)
            return True
        # grow block tables for the dispatch positions (plain allocation
        # only: reclaim/preempt pressure is handled sequentially)
        for s in live:
            pend = 1 if s.slot in covered else 0
            need = self.engine.cache_config.blocks_for(s.cached_len + pend + 1)
            short = False
            while len(s.blocks) < need:
                got = self.engine.allocator.allocate(1)
                if got is None:
                    short = True
                    break
                s.blocks.extend(got)
            if short:
                if f is not None:
                    self._drain_frontier("pressure")
                    return True
                return None
        try:
            new_f = self._dispatch_pipeline(live, f)
        except Exception as e:
            # dispatch failed host-side; the in-flight predecessor is
            # healthy: consume it first, then give the failed step the
            # sequential recovery treatment
            if f is not None:
                self._pipe = None
                try:
                    self._consume_and_finish(f)
                except Exception as e2:
                    self._pipeline_failure(e2, f.seq0)
                    return True
            self._pipeline_failure(e, self._hb_seq)
            return True
        self._pipe = new_f
        self.pipe_dispatches += 1
        if f is None:
            return True  # warm-up: its tokens arrive next iteration
        try:
            self._consume_and_finish(f)
        except Exception as e:
            self._pipeline_failure(e, f.seq0)
        return True

    def _trim_blocks(self, state: _Running) -> None:
        """Return trailing blocks a partially-accepted window no longer
        covers (their positions hold rejected-draft K/V the next window
        would rewrite anyway). cached_len + 1, not cached_len: the next
        step always writes position cached_len."""
        keep = max(1, self.engine.cache_config.blocks_for(state.cached_len + 1))
        if len(state.blocks) > keep:
            extra = state.blocks[keep:]
            del state.blocks[keep:]
            self.engine.allocator.free(extra)

    def _verify_mask(self, order, window, n_draft):
        """The constrained slots' grammar rows for one verify step
        ({(slot, j): [V] row}), or None when nothing running is
        constrained. Window position j samples the token after the first
        j window tokens, so row 0 is the cursor's row and row j+1 the row
        at the state reached through draft tokens 0..j: the states a
        masked sequential decode would pass through, which keeps
        acceptance token-identical to the unspeculated stream."""
        mask = {}
        n = 0
        for state in order:
            ms = state.req.mask_state
            if ms is None:
                continue
            i = state.slot
            eos = state.req.sampling.eos_id
            mask[(i, 0)] = ms.mask_row(eos)
            draft = [int(t) for t in window[i, 1: 1 + max(0, int(n_draft[i]))]]
            for j, st in enumerate(ms.states_along(draft, eos)):
                mask[(i, j + 1)] = ms.dfa.mask_row(st, eos)
            n += 1
        if not mask:
            return None
        self.constrained_stats.incr("masked_steps", n)
        return mask

    def _verify_once(self) -> bool:
        """One speculative verification step across all running slots:
        draft (host), verify the batch x (k+1) window (ONE fixed-shape
        device step, supervised), then emit each slot's accepted run —
        truncated at mid-window EOS and the request's budget."""
        if not self._running:
            return False
        b = self.engine.max_batch_slots
        w = self.engine.spec_window
        order = sorted(self._running.values(), key=lambda s: s.slot)
        last, start, tables, _active, temps, top_ks, seeds, counts = self._collect_slots(order)
        window = np.zeros((b, w), np.int32)
        window[:, 0] = last
        n_draft = np.full((b,), -1, np.int32)  # -1 = inactive slot
        for state in order:
            i = state.slot
            req = state.req
            draft: List[int] = []
            if state.step_k > 0 and req.drafter is not None:
                try:
                    # original_prompt, NOT prompt: after a preemption the
                    # recompute prompt already folds in generated tokens
                    draft = list(
                        req.drafter.propose(req.original_prompt + req.generated, state.step_k)
                    )[: state.step_k]
                except Exception:
                    # verification is exact with ANY draft, so a failed
                    # proposal degrades to a plain (zero-draft) window
                    self._incr("drafter_errors")
            if req.mask_state is not None and draft:
                # a grammar-banned draft token would be rejected by the
                # masked target anyway: cut to the longest legal prefix
                draft = req.mask_state.filter_draft(draft, req.sampling.eos_id)
            window[i, 1: 1 + len(draft)] = draft
            n_draft[i] = len(draft)
        wmask = self._verify_mask(order, window, n_draft)

        def step():
            return self.engine.verify(window, start, n_draft, tables, temps, top_ks, seeds,
                                      counts, wmask)

        def probe(subset):
            nd = np.full((b,), -1, np.int32)  # everyone else inactive
            for s in subset:
                nd[s.slot] = n_draft[s.slot]
            self._probe_call(
                lambda: self.engine.verify(window, start, nd, tables, temps, top_ks, seeds,
                                           counts, wmask)
            )

        result = self.supervisor.run_step("verify", step, order, probe)
        if result is None:
            return True  # failure handled: quarantined or journal-replayed
        out, n_emitted = result
        if self._quarantine_nan("verify", order):
            return True
        for state in order:
            if self._running.get(state.slot) is not state:
                continue  # preempted/expired between collect and scatter
            if state.req.handle.done():
                continue  # watchdog-reaped mid-step; _expire releases it
            req = state.req
            i = state.slot
            m = int(n_emitted[i])
            toks = [int(t) for t in out[i, :m]]
            # budget truncation: never emit past max_new
            toks = toks[: req.max_new - req.n_generated]
            # mid-window EOS: keep through the FIRST eos, drop the rest
            eos = req.sampling.eos_id
            if eos is not None and eos in toks:
                toks = toks[: toks.index(eos) + 1]
            proposed = int(max(0, n_draft[i]))
            accepted = max(0, m - 1)  # drafts the target agreed with
            req.update_speculation(proposed=proposed, accepted=accepted)
            emitted = 0
            for t in toks:
                self._emit_token(state, t)
                emitted += 1
                if req.mask_state is not None and (
                    req.mask_error is not None or req.finished()
                ):
                    # the constrained stream ended mid-window (a parked
                    # advance error or the exhaustion clamp): the rest of
                    # the run was sampled past the grammar's end
                    break
            self._incr("spec_windows")
            self._incr("spec_proposed", proposed)
            self._incr("spec_accepted", accepted)
            self._incr("spec_emitted", emitted)
            state.cached_len += emitted
            self._trim_blocks(state)
            if req.finished():
                self._finish(state)
        return True

    # ---------------------------------------------------------------- step
    def step(self) -> bool:
        """One scheduling iteration. With overlap on, a steady iteration
        pipelines dispatch/consume; otherwise (and after any frontier
        drain): expire, quarantine parked grammar errors, admit
        (join-mid-flight), plan speculation,
        grow/preempt, then decode — or verify, when any running request
        speculates. Returns True if any work happened."""
        if self.overlap:
            r = self._try_pipeline()
            if r is not None:
                return r
        self._expire()
        self._sweep_mask_errors()
        admitted = 0
        while self._admit():
            admitted += 1
        self._plan_speculation()
        self._grow()
        speculating = any(s.step_k > 0 for s in self._running.values())
        stepped = self._verify_once() if speculating else self._decode_once()
        return stepped or admitted > 0
