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

* **overload control** (``serving/overload.py``): the queue is
  priority-ordered (interactive / standard / best_effort, FCFS within a
  class); an AIMD concurrency limiter throttles admission before the
  queue fills, a full queue sheds the youngest fresh request of a lower
  class, a roofline-predicted TTFT past the deadline fails fast, and a
  degradation ladder caps speculation, clamps new budgets and sheds
  best-effort work under sustained pressure — all typed
  :class:`OverloadedError` rejections with a ``Retry-After``;
* **observability** (``obs/``; ``observability=False`` turns it off):
  one :class:`RequestTrace` per request (queue time, TTFT, TPOT, event
  log) finished into a :class:`TraceRing`, one flight-recorder record
  per iteration, the step-anatomy profiler's host spans and device
  execute span, KV-cache block telemetry, SLO burn rates and goodput,
  all registered as gauges on the scheduler's :class:`ServingStats`
  (``/v2/stats``, ``/metrics``); and the request's journey
  (``obs/journey.py``): one parent-linked span per hop (submit, admit,
  prefill, replay, adopt, finish) in the scheduler's
  :class:`JourneyRecorder`, whose id tags the TTFT/TPOT/queue-time
  exemplars;
* **durable serving** (``serving/durable.py``): the journal's
  ``note_token`` and its once-per-iteration ``flush_step`` (the WAL's
  group commit, inside the overlap pipeline's execute window) are no-ops
  on the base journal; ``adopt`` re-admits a warm-restarted stream by
  recompute prefill.

Requests carry deadlines (:class:`DeadlineExceededError` before OR during
generation), on an injectable clock so tests run on virtual time.
``step()`` does one iteration and returns; ``start()`` runs it on a
background thread (with the watchdog) and ``stop(drain)`` ends it.
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

from ..obs import (
    NULL_JOURNEY,
    NULL_TRACE,
    CacheTelemetry,
    FlightRecorder,
    JourneyContext,
    JourneyRecorder,
    JourneyStats,
    RequestTrace,
    SLOMonitor,
    StepAnatomy,
    TraceRing,
    next_request_id,
)
from ..runtime import faults
from ..serving.overload import OverloadConfig, OverloadController, Priority
from ..serving.resilience import (
    CircuitBreaker,
    CircuitOpenError,
    DeadlineExceededError,
    RetryPolicy,
    ShuttingDownError,
)
from ..serving.stats import (
    ConstrainedStats,
    GoodputStats,
    ServingStats,
    SpeculationStats,
    TokenRate,
)
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


class GenerationHandle:
    """Caller's view of one request: a Future of the generated token
    list plus a per-token stream."""

    def __init__(self, request: "Request"):
        self._request = request
        self.future: Future = Future()
        self._tokens: "queue.Queue" = queue.Queue()
        # the loop and watchdog threads race to settle a handle; the
        # claim's winner owns both the future and the trace, and closes the
        # trace BEFORE the future settles, so a client woken by the future
        # never reads a half-open trace
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

    @property
    def trace(self):
        """The request's RequestTrace (NULL_TRACE when observability is
        off)."""
        return self._request.trace

    def trace_dict(self) -> dict:
        return self._request.trace.to_dict()

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
        self._request._trace_done("completed", None)
        self.future.set_result(tokens)
        self._tokens.put(_END)

    def _fail(self, err: BaseException) -> bool:
        """Returns True only if THIS call failed the handle (the losers
        of the loop/watchdog race must not count twice)."""
        if not self._claim():
            return False
        self._request._trace_done(type(err).__name__, err)
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
    advance for the step loop's quarantine sweep. ``priority`` orders
    admission, preemption victims and sheds; ``overload_release`` returns
    the request's limiter slot when it settles. Ids come from the
    process-wide ``obs`` counter, so a trace id names one request.
    ``journey`` is the request's journey context (NULL_JOURNEY when
    journeys are off), minted or joined at submit and restored from the
    WAL on a warm restart; ``durable_id`` is its WAL identity, stable
    across process restarts (set by a DurableJournal; None when the
    stream is not journaled)."""

    def __init__(
        self,
        prompt: List[int],
        sampling: SamplingParams,
        deadline: Optional[float] = None,
        speculation: Optional[SpeculationConfig] = None,
        drafter=None,
        priority: str = Priority.STANDARD,
        grammar=None,
        response_format: Optional[Dict] = None,
    ):
        self.id = next_request_id()
        self.priority = priority
        self.priority_rank = Priority.rank(priority)
        self.overload_release: Optional[Callable[[], None]] = None
        # the scheduler swaps in a live trace (+ its ring and the SLO sink)
        # at submit when observability is on
        self.trace = NULL_TRACE
        self.trace_ring: Optional[TraceRing] = None
        self.journey = NULL_JOURNEY
        self.durable_id: Optional[str] = None
        self.slo_sink: Optional[Callable[["Request"], None]] = None
        self.submitted_at = 0.0  # stamped by the scheduler
        # admission-wait blame: when the queue's head first stalled on
        # cache blocks, and how many it was short
        self.cache_wait_start: Optional[float] = None
        self.cache_wait_short = 0
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
        # disaggregated serving: a CRC-stamped KVHandoffPayload attached
        # by adopt(imported=...), consumed (imported or rejected) at
        # admission
        self.imported_kv = None

    @property
    def n_generated(self) -> int:
        return len(self.generated)

    def _trace_done(self, outcome: str, err: Optional[BaseException]) -> None:
        """Terminal hook, called once by the handle's settle winner: the
        limiter slot goes back (observability off must not leak it), the
        trace finishes into its ring, the SLO/goodput sink records it and
        the journey takes its terminal hop."""
        release, self.overload_release = self.overload_release, None
        if release is not None:
            try:
                release()
            except Exception:
                pass  # limiter accounting must never poison a settle path
        if self.trace is not NULL_TRACE:
            self.trace.mark_finish(outcome, err)
            if self.trace_ring is not None:
                self.trace_ring.add(self.trace)
            if self.slo_sink is not None:
                try:
                    self.slo_sink(self)
                except Exception:
                    pass  # SLO accounting must never poison a settle path
        if self.journey is not NULL_JOURNEY:
            # the terminal span carries the trace's decomposition and event
            # log; recorded even when the trace is NULL (a warm-restored
            # stream has a journey but no trace): the journey must end
            try:
                tr = {} if self.trace is NULL_TRACE else self.trace.to_dict()
                self.journey.hop(
                    "finish", outcome=outcome, n_generated=len(self.generated),
                    queue_time_s=tr.get("queue_time_s"), ttft_s=tr.get("ttft_s"),
                    tpot_s=tr.get("tpot_s"), total_s=tr.get("total_s"),
                    preemptions=tr.get("preemptions"), replays=tr.get("replays"),
                    error=None if err is None else str(err),
                    trace_events=tr.get("events"),
                )
            except Exception:
                pass  # journeys must never poison a settle path

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
    loop. ``observability`` turns the traces, the flight recorder, the
    step anatomy and the cache telemetry on (the default) or off;
    ``trace_ring_size``, ``flight_capacity`` and ``trace_progress_every``
    size them, ``slo_objectives`` replaces the default SLOs,
    ``pressure_threshold`` is the free-block fraction under which the
    cache counts as under pressure, and ``overload`` tunes the overload
    controller. ``journeys`` (default: on with observability) records
    each request's journey; ``journeys=False`` keeps tracing on with
    journeys off. ``fault_scope`` (a fleet replica's id) runs every
    iteration inside that fault-injection scope and names the journey
    lane; the fleet sets ``failover_sink`` and ``handoff_sink``."""

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
        observability: bool = True,
        journeys: Optional[bool] = None,
        trace_ring_size: int = 256,
        flight_capacity: int = 512,
        trace_progress_every: int = 8,
        slo_objectives=None,
        pressure_threshold: float = 0.10,
        fault_scope: Optional[str] = None,
        overlap: Optional[bool] = None,
        overload: Optional[OverloadConfig] = None,
    ):
        self.engine = engine
        # fleet integration (serving/fleet.py): fault_scope tags every
        # step's injection sites with this replica's id (so chaos plans
        # can target ONE replica) and names this scheduler's journey lane;
        # failover_sink, when set, receives every live request instead of
        # a terminal EngineFailedError when the restart budget exhausts
        # (the fleet journal-replays them onto surviving replicas via
        # adopt()); handoff_sink, when set (prefill-pool replicas only),
        # ends admission at the first token: the prompt's KV packs into
        # the wire format and (request, payload) goes to the sink for the
        # decode pool
        self.fault_scope = fault_scope
        self.failover_sink: Optional[Callable] = None
        self.handoff_sink: Optional[Callable] = None
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
        # observability, surfaced on /v2/stats and /metrics through the
        # serving front end (the gauge names are the JAX scheduler's)
        self.stats = ServingStats()
        self.token_rate = TokenRate(clock=time.monotonic)
        self.preemptions = 0
        alloc, cc = engine.allocator, engine.cache_config
        self.stats.add_gauge("queue_depth", lambda: len(self._queue))
        self.stats.add_gauge("running", lambda: len(self._running))
        self.stats.add_gauge("tokens_generated", lambda: self.token_rate.total)
        self.stats.add_gauge("tokens_per_s", self.token_rate.rate)
        self.stats.add_gauge("preemptions", lambda: self.preemptions)
        self.stats.add_gauge("cache_blocks_used", lambda: alloc.num_total - alloc.num_free)
        self.stats.add_gauge("cache_blocks_total", lambda: alloc.num_total)
        # one GPU: the shard is the whole cache
        self.stats.add_gauge("mesh_devices", lambda: engine.mesh_devices)
        self.stats.add_gauge("tp_degree", lambda: engine.tp_degree)
        self.stats.add_gauge("cache_shard_bytes",
                             lambda: cc.total_bytes // max(1, engine.tp_degree))
        self.stats.add_gauge("cache_shard_heads",
                             lambda: cc.num_heads // max(1, engine.tp_degree))
        self.stats.add_gauge("cache_occupancy",
                             lambda: 1.0 - alloc.num_free / max(1, alloc.num_total))
        # new step signatures past the first, read from trace_counts (on a
        # GPU: graph captures)
        self.stats.add_gauge("recompiles", lambda: sum(engine.recompiles().values()))
        self.stats.add_gauge("device_time_s", lambda: sum(engine.device_time_s.values()))
        # one RequestTrace per submit, finished traces in a bounded ring
        # (GET /v2/debug/traces); one flight record per iteration (GET
        # /v2/debug/timeline, quarantine/restart postmortems); the
        # anatomy's host spans + device execute span per iteration
        self.obs_enabled = observability
        self.trace_progress_every = trace_progress_every
        self.trace_ring = TraceRing(trace_ring_size)
        # request journeys: this scheduler's span ring (lane: the fleet
        # replica id, else "local"),
        # stitched with the HTTP ingress lane and the on-disk spool at
        # query time. Rides observability by default
        self.journey_stats = JourneyStats()
        self.journey_stats.register_gauges(self.stats)
        journeys_on = observability and (journeys is None or bool(journeys))
        self.journeys: Optional[JourneyRecorder] = (
            JourneyRecorder(lane=fault_scope or "local", clock=self.clock,
                            stats=self.journey_stats)
            if journeys_on else None
        )
        # dual-clock records: t (perf_counter, the timeline's clock) and
        # t_sched (this scheduler's possibly virtual clock)
        self.flight = FlightRecorder(
            capacity=flight_capacity, enabled=observability, sched_clock=self.clock
        )
        self._step_phases: Dict[str, float] = {}
        self._step_info: Dict = {}
        self._step_recorded = False
        self.anatomy = StepAnatomy(enabled=observability)
        self.anatomy.register_gauges(self.stats)
        self._step_spans: List = []  # this iteration's (phase, t0, t1); loop thread
        self.spec_stats = SpeculationStats()
        self.spec_stats.register_gauges(self.stats)
        self.capacity = CacheTelemetry(
            alloc, clock=self.clock, pressure_threshold=pressure_threshold,
            enabled=observability,
            reclaimable=lambda: engine.prefix_cache.evictable_blocks,
        )
        self.capacity.register_gauges(self.stats, lambda: list(self._running.values()))
        # overload control: priority-aware admission, the AIMD limiter
        # (fed by the queue-time/TTFT windows and the pressure flag), the
        # degradation ladder, and the infeasibility fast-fail, whose
        # predicted TTFT behind ``depth`` queued requests is (depth + 1)
        # prefills on the serving roofline
        fm = engine.flops_model
        self.overload = OverloadController(
            clock=self.clock,
            slots=engine.max_batch_slots,
            max_queue=max_queue,
            queue_depth=lambda: len(self._queue),
            queue_p95=lambda: self.stats.window_p95("queue_time"),
            ttft_p95=lambda: self.stats.window_p95("ttft"),
            cache_pressure=lambda: self.capacity.under_pressure,
            ttft_predictor=lambda n, depth: (depth + 1) * fm.roofline_s(
                fm.prefill_flops(n), fm.prefill_bytes(n)
            ),
            stats=self.stats,
            on_transition=self._note_degrade,
            config=overload,
        )
        self.overload.register_gauges(self.stats)
        for p in Priority.ORDER:
            self.stats.add_gauge(
                f"overload_queue_depth_{p}",
                lambda p=p: sum(1 for r in list(self._queue) if r.priority == p),
            )
        # prefix-cache telemetry (flexflow_serving_prefix_cache_*)
        pc = engine.prefix_cache
        self.stats.add_gauge("prefix_cache_hit_ratio", pc.hit_ratio)
        self.stats.add_gauge("prefix_cache_blocks_reused_total", lambda: pc.blocks_reused_total)
        self.stats.add_gauge("prefix_cache_tokens_reused_total", lambda: pc.tokens_reused_total)
        self.stats.add_gauge("prefix_cache_cow_copies_total", lambda: pc.cow_copies_total)
        self.stats.add_gauge("prefix_cache_swaps_in_total", lambda: pc.swaps_in_total)
        self.stats.add_gauge("prefix_cache_swaps_out_total", lambda: pc.swaps_out_total)
        self.stats.add_gauge("prefix_cache_host_bytes", lambda: pc.host_bytes)
        self.stats.add_gauge("prefix_cache_resident_blocks", lambda: pc.resident_blocks)
        self.stats.add_gauge("prefix_cache_offloaded_blocks", lambda: pc.offloaded_blocks)
        self.goodput = GoodputStats()
        self.goodput.register_gauges(self.stats)
        self.slo = SLOMonitor(slo_objectives, clock=self.clock)
        self.slo.register_gauges(self.stats)
        self.stats.add_gauge("mfu", engine.mfu)
        self.stats.add_gauge("model_tflops_total", lambda: engine.total_flops() / 1e12)
        self.stats.add_gauge(
            "achieved_tflops",
            lambda: engine.total_flops() / max(1e-9, engine.total_device_time_s()) / 1e12,
        )
        self.stats.add_gauge("retraces_blamed", engine.programs.total_retraces)
        # a new step signature's blame rides the flight ring next to the
        # step that met it
        engine.programs.on_retrace = self._note_retrace
        # predicted-vs-measured step times (GET /v2/debug/predictions)
        led = engine.ledger
        self.stats.add_gauge("perf_prediction_pairs", lambda: led.pairs_total)
        self.stats.add_gauge("perf_prediction_error_p50",
                             lambda: led.error_summary()["abs_err_p50"])
        self.stats.add_gauge("perf_prediction_error_max",
                             lambda: led.error_summary()["abs_err_max"])
        self.stats.add_gauge("perf_drift_alarms", lambda: led.alarms_total)
        led.on_alarm = self._note_drift
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
        self.recovery_stats.register_gauges(self.stats)
        # constrained decoding: grammar-cache and masked-step counters (a
        # GrammarCache built with this object counts its compiles here)
        self.constrained_stats = ConstrainedStats()
        self.constrained_stats.register_gauges(self.stats)
        self.journal = GenerationJournal()
        self.supervisor = EngineSupervisor(self, recovery)
        self.watchdog = StepWatchdog(self, watchdog)
        self._heartbeat = None
        self._hb_seq = 0
        # the request popped for admission but not yet slot-resident,
        # visible to the watchdog's deadline reaper while its prefill runs;
        # its blocks give cache_report a provisional residency row
        self._admitting: Optional[Request] = None
        self._admitting_blocks: Optional[List[int]] = None

    # ------------------------------------------------------------- submit
    def submit(
        self,
        prompt: Sequence[int],
        sampling: Optional[SamplingParams] = None,
        deadline_s: Optional[float] = None,
        speculation: Optional[SpeculationConfig] = None,
        transport: Optional[str] = None,
        priority: Optional[str] = None,
        grammar=None,
        response_format: Optional[Dict] = None,
        journey: Optional[JourneyContext] = None,
    ) -> GenerationHandle:
        """Enqueue one request (priority-ordered, FCFS within a class).
        Raises OverloadedError (a QueueFullError carrying reason /
        priority / retry_after_s) on backpressure, limiter throttling or
        degradation shedding; InfeasibleError when the roofline-predicted
        TTFT already exceeds the deadline; CircuitOpenError while the
        breaker holds traffic; ShuttingDownError while draining or after
        ``stop()``; DeadlineExceededError for an already-expired budget;
        ValueError for a prompt that can never be served. A full queue
        sheds the youngest fresh queued request of the LOWEST class
        strictly below the newcomer's before rejecting the newcomer.
        ``speculation`` turns on (exact) speculative decoding for this
        request; None falls back to the scheduler's default policy.
        ``transport`` annotates the trace ("http"); ``priority`` is one of
        ``Priority.ORDER`` (default standard). ``grammar`` is a compiled
        constrained-decoding TokenDFA (see ``generation/constrained/``),
        checked against the engine's vocabulary; ``response_format`` is
        the wire spec it came from. ``journey`` is a context handed in
        from ingress (it keeps its id and parents onto the ingress span);
        without one, the journey roots here."""
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
            self.stats.incr("expired")
            raise DeadlineExceededError("deadline already expired at submit")
        priority = Priority.parse(priority)
        rank = Priority.rank(priority)
        ctl = self.overload
        # chaos hook: force admission-path failures (typically a typed
        # OverloadedError) to drive the limiter/shed paths
        faults.inject(faults.SERVING_ADMISSION, (priority, len(self._queue)))
        if ctl.degraded_reject(priority):
            raise ctl.overload_error(
                f"degraded: shedding {priority} traffic (ladder level {ctl.ladder.level})",
                "degraded", priority,
            )
        if deadline_s is not None:
            predicted = ctl.infeasible(len(prompt), deadline_s)
            if predicted is not None:
                raise ctl.infeasible_error(priority, predicted, deadline_s)
        shed: List = []  # (victim, error) pairs, settled OUTSIDE the lock
        with self._lock:
            # breaker FIRST, before any shed planning: a submit the breaker
            # refuses must never destroy queued work. ready(), not allow():
            # submit only enqueues; the half-open probe slot is claimed by
            # the admission that calls the device
            if not self.breaker.ready():
                self.stats.incr("rejected")
                raise CircuitOpenError("generation circuit open")
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
                          drafter=drafter, priority=priority, grammar=grammar,
                          response_format=response_format)
            req.submitted_at = self.clock()
            if self.obs_enabled:
                req.trace = RequestTrace(
                    req.id, clock=self.clock, progress_every=self.trace_progress_every,
                )
                req.trace_ring = self.trace_ring
                req.slo_sink = self._slo_record
                req.trace.mark_accept(
                    prompt_len=len(prompt), deadline_s=deadline_s,
                    speculative=bool(spec is not None and spec.enabled),
                )
                if transport is not None:
                    req.trace.mark_transport(transport)
                if self.journeys is not None:
                    ctx = journey if journey is not None else self.journeys.mint()
                    ctx.recorder = self.journeys
                    req.journey = ctx
                    req.trace.journey_id = ctx.journey_id
                    ctx.hop("submit", request_id=req.id, prompt_len=len(prompt),
                            priority=priority, transport=transport)
            # the sequence can never outgrow max_seq_len NOR the TOTAL
            # cache: a sequence needing more blocks than exist would
            # preempt itself forever at the head of the queue
            cache_room = (
                self.engine.allocator.num_total * self.engine.cache_config.block_size
                - len(prompt)
            )
            req.max_new = min(sampling.max_new_tokens, room, cache_room)
            # degrade level 3+: clamp NEW admissions' budgets per class
            cap = ctl.max_new_cap(priority)
            if cap is not None:
                req.max_new = min(req.max_new, max(1, cap))
            # overload gates, planned BEFORE any victim is touched: the
            # whole shed set (one for queue space when full, at most one
            # more when queued lower-priority work holds the limiter slot)
            # is checked first, so a newcomer the gates refuse anyway never
            # destroys queued work. Victims' limiter slots release here,
            # under the lock; their handles settle after it drops
            need = 1 if len(self._queue) >= self.max_queue else 0
            freed = need
            if not ctl.limiter.can_admit(priority, freed=freed):
                freed += 1  # one extra shed, for the limiter slot itself
                if not ctl.limiter.can_admit(priority, freed=freed):
                    raise ctl.overload_error(
                        "admission throttled by the adaptive concurrency "
                        f"limit ({ctl.limiter.limit:.0f})",
                        "limiter", priority,
                    )
            if freed:
                victims = self._shed_victims_locked(rank, freed)
                if len(victims) < freed:
                    if need and not victims:
                        raise ctl.overload_error(
                            f"generation queue full ({self.max_queue})",
                            "queue_full", priority,
                        )
                    raise ctl.overload_error(
                        "admission throttled by the adaptive concurrency "
                        f"limit ({ctl.limiter.limit:.0f})",
                        "limiter", priority,
                    )
                reason = "queue_full" if need else "limiter"
                detail = (
                    f"queue full at {self.max_queue}" if need
                    else f"adaptive limit {ctl.limiter.limit:.0f}"
                )
                for victim in victims:
                    self._queue.remove(victim)
                    release, victim.overload_release = victim.overload_release, None
                    if release is not None:
                        release()
                    shed.append((victim, ctl.overload_error(
                        f"shed for a higher-priority admission ({detail})",
                        reason, victim.priority, shed=True,
                    )))
            if not ctl.limiter.try_acquire(priority):
                # unreachable by construction (can_admit held under this
                # lock and inflight only shrinks concurrently); typed anyway
                raise ctl.overload_error(
                    "admission throttled by the adaptive concurrency "
                    f"limit ({ctl.limiter.limit:.0f})",
                    "limiter", priority,
                )
            req.overload_release = ctl.limiter.release
            self._queue_insert_locked(req)
        # settle shed victims OUTSIDE the lock: a done-callback that
        # re-enters the scheduler must not deadlock on _lock
        for victim, err in shed:
            victim.handle._fail(err)
        self.stats.incr("admitted")
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
                self.stats.incr("failed")
        for state in list(self._running.values()):
            self._release(state)
            if state.req.handle._fail(err):
                self.stats.incr("failed")

    def _fail_running_engine_dead(self, err: EngineFailedError) -> None:
        """Restart budget exhausted: every slot-resident stream is lost to
        this engine and fails with the typed EngineFailedError. The
        engine is reset, so slot/allocator bookkeeping restarts from
        empty rather than freeing stale block ids into the fresh list.

        With a ``failover_sink`` installed (fleet mode) the streams are
        not lost: every live request (slot-resident, replay-requeued
        mid-stream, and fresh queued) leaves this scheduler entirely
        (journal drained, slots cleared, queue emptied) and goes to the
        sink, which journal-replays it onto a surviving replica
        (``adopt()``). The requests fully exit this scheduler's
        bookkeeping before the sink runs, so nothing is emitted twice."""
        self.journal.drain()
        states = sorted(self._running.values(), key=lambda s: s.admitted_seq)
        self._reset_slots()
        self.engine.reset()
        live = []
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
                self.stats.incr("completed")
            else:
                live.append(state.req)
        sink = self.failover_sink
        if sink is not None:
            with self._lock:
                queued, self._queue = list(self._queue), deque()
            try:
                sink(live + [r for r in queued if not r.handle.done()], err)
                return
            except Exception:
                # the fleet must never make a dying engine worse: put the
                # taken queue back (ahead of anything submitted meanwhile)
                # and fall through to the single-engine terminal semantics
                with self._lock:
                    for req in reversed(queued):
                        self._queue.appendleft(req)
        for req in live:
            if req.handle._fail(err):
                self.stats.incr("failed")
        # replay-requeued MID-STREAM requests are as lost as the
        # slot-resident ones; fresh queued requests stay held
        with self._lock:
            keep: deque = deque()
            for req in self._queue:
                if req.n_generated > 0:
                    if req.handle._fail(err):
                        self.stats.incr("failed")
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
                self.stats.incr("completed")
                continue
            req.prompt = req.original_prompt + list(req.generated)
            # the journal IS the grammar state: rebuilt at re-admission
            req.mask_state = None
            req.replays += 1
            req.trace.note_replay()
            req.journey.hop("replay", n_generated=req.n_generated, reason="engine_restart")
            replayed += req.n_generated
            requeue.append(req)
        with self._lock:
            for req in reversed(requeue):
                self._queue.appendleft(req)
        if replayed:
            self.recovery_stats.incr("replayed_tokens", replayed)
        self._wake.set()

    def steal_queue(self) -> List[Request]:
        """Fleet rescue: atomically take every QUEUED request (never
        slot-resident this life, or held behind the breaker) off this
        scheduler, for adoption elsewhere. Slot-resident streams are not
        stealable (the loop thread owns them): they finish, fail over
        through the supervisor, or expire."""
        with self._lock:
            stolen, self._queue = list(self._queue), deque()
        return [r for r in stolen if not r.handle.done()]

    def adopt(self, req: Request, *, front: bool = True, imported=None) -> None:
        """Journal-replay admission of a stream this scheduler did not
        submit: a warm restart's re-admission (``serving/durable.py``) or
        a fleet failover from a dead sibling replica. The replay state IS
        the request object (original prompt, every emitted token, the
        seeded sampling stream, speculation config), so the
        recompute-prefill path resumes the stream byte-exactly (fleet
        replicas come from one factory). Bypasses the max_queue bound and
        the breaker on purpose: the stream was admitted once already.
        ``front`` requeues it ahead of fresh work.

        ``imported`` (disaggregated serving) attaches a CRC-stamped
        :class:`~.prefix.KVHandoffPayload`: admission imports the
        prefilled blocks instead of recompute-prefilling, and any import
        failure falls back to the recompute path, so a handoff can
        degrade but never corrupt a stream."""
        req.imported_kv = imported
        req.prompt = req.original_prompt + list(req.generated)
        req.mask_state = None  # rebuilt from `generated` at admission
        # mirror submit()'s can-never-be-admitted checks, or the adopted
        # stream wedges the queue's head forever
        room = self.engine.max_seq_len - len(req.prompt)
        cache_room = (
            self.engine.allocator.num_total * self.engine.cache_config.block_size
            - len(req.prompt)
        )
        if (
            len(req.prompt) > self.engine.buckets[-1]
            or room < 1
            or self.engine.cache_config.blocks_for(len(req.prompt) + 1)
            > self.engine.allocator.num_total
        ):
            if req.handle._fail(ValueError(
                f"adopted stream length {len(req.prompt)} can never be admitted on this "
                f"engine (max bucket {self.engine.buckets[-1]}, max_seq_len "
                f"{self.engine.max_seq_len}, cache blocks {self.engine.allocator.num_total})"
            )):
                self.stats.incr("failed")
            return
        # re-clamp the budget against THIS engine's geometry
        req.max_new = min(req.max_new, req.n_generated + room, req.n_generated + cache_room)
        if req.n_generated > 0 and imported is None:
            # a recompute adoption replays the stream; an imported handoff
            # is the disaggregated steady state and counts only if the
            # import is later rejected (see _admit_imported)
            req.replays += 1
            req.trace.note_replay()
            self.recovery_stats.incr("replayed_tokens", req.n_generated)
        # terminal observability lands where the stream completes
        if req.trace_ring is not None:
            req.trace_ring = self.trace_ring
        if req.slo_sink is not None:
            req.slo_sink = self._slo_record
        if req.journey is not NULL_JOURNEY:
            # from here on the hops land in THIS scheduler's ring (or
            # nowhere with journeys off: the context stays intact)
            req.journey.recorder = self.journeys
            req.journey.hop("adopt", replica=self.fault_scope, imported=imported is not None,
                            front=front, n_generated=req.n_generated)
        # the stream counts against this limiter, forced past the limit: it
        # must never be dropped for headroom it cleared before
        release, req.overload_release = req.overload_release, None
        if release is not None:
            try:
                release()
            except Exception:
                pass
        self.overload.limiter.acquire_forced()
        req.overload_release = self.overload.limiter.release
        with self._lock:
            if front:
                self._queue.appendleft(req)
            else:
                self._queue.append(req)
        self._wake.set()

    def _reset_slots(self) -> None:
        """Post-``engine.reset()`` slot bookkeeping: every slot empty and
        every outstanding block table invalid wholesale (no per-block
        frees after the allocator's reset)."""
        self._running.clear()
        self._free_slots = list(range(self.engine.max_batch_slots - 1, -1, -1))

    def _quarantine(self, state: _Running, err: BaseException) -> None:
        """Fail ONE poisoned request and keep the batch. The flight
        recorder's trailing window rides the error out as the
        postmortem."""
        req = state.req
        req.trace.event(
            "quarantine", step=getattr(err, "step", None),
            reason=getattr(err, "reason", type(err).__name__),
        )
        if getattr(err, "flight_snapshot", None) is None:
            try:
                err.flight_snapshot = self.flight.incident(
                    "quarantine", request_id=req.id, error=repr(err)[:200],
                )
            except Exception:
                pass  # exceptions with __slots__ cannot carry the dump
        self._release(state)
        if req.handle._fail(err):
            self.stats.incr("failed")
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

    # ------------------------------------------- capacity / SLO reporting
    def _note_retrace(self, name: str, blame: str) -> None:
        """Program-registry hook: a new signature's blame lands on the
        flight ring in order with the step that met it."""
        self.flight.record_event("retrace", program=name, blame=blame)

    def _note_drift(self, alarm: Dict) -> None:
        """Truth-ledger drift hook: the alarm lands on the flight ring
        next to the steps that proved it."""
        self.flight.record_event("drift", program=alarm["key"], blame=alarm["blame"])

    def _slo_record(self, req: Request) -> None:
        """Terminal SLO/goodput sink (once per request, from the settle
        winner). A token is good only when its request COMPLETED in its
        deadline; the SLO windows see every outcome."""
        tr = req.trace
        in_deadline = req.deadline is None or (
            tr.t_finish is not None and tr.t_finish <= req.deadline
        )
        self.goodput.record(req.n_generated, good=(tr.outcome == "completed" and in_deadline))
        self.slo.observe(tr.outcome or "unknown", ttft_s=tr.ttft_s, tpot_s=tr.tpot_s)

    def cache_report(self) -> Dict:
        """The ``GET /v2/debug/cache`` payload: allocator state, the
        per-request block residency and the prefix cache's snapshot. The
        free count is read FIRST, then the running snapshot, then the
        admission in flight (deduped by request id in the report): a
        request finishing mid-scrape can make the table undercount
        ``used``, never claim freed blocks."""
        free = self.engine.allocator.num_free
        running = list(self._running.values())
        adm_req, adm_blocks = self._admitting, self._admitting_blocks
        return self.capacity.report(
            running, queue_depth=len(self._queue),
            admitting=(adm_req, adm_blocks) if adm_req is not None and adm_blocks else None,
            free=free, prefix=self.engine.prefix_cache.snapshot(),
        )

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
        req = state.req
        self.stats.latency.record(max(0.0, self.clock() - req.submitted_at))
        tpot = req.trace.tpot_s
        if tpot is not None:
            self.stats.observe("tpot", tpot, exemplar=req.journey.journey_id)
        req.handle._finish(list(req.generated))
        self.stats.incr("completed")

    def _expire(self) -> None:
        now = self.clock()
        with self._lock:
            keep: deque = deque()
            for req in self._queue:
                if req.handle.done():
                    pass  # reaped by the watchdog during a stall; just drop
                elif req.cancelled:
                    if req.handle._fail(ShuttingDownError("request cancelled")):
                        self.stats.incr("cancelled")
                elif req.deadline is not None and now >= req.deadline:
                    if req.handle._fail(DeadlineExceededError("deadline expired while queued")):
                        self.stats.incr("expired")
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
                    self.stats.incr("cancelled")
            elif req.deadline is not None and now >= req.deadline:
                self._release(state)
                if req.handle._fail(DeadlineExceededError("deadline expired mid-generation")):
                    self.stats.incr("expired")

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
        self.capacity.note_preempt(len(state.blocks))
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
        req.trace.note_preempt()
        with self._lock:
            self._queue.appendleft(req)

    def _preempt_youngest(self, exclude: Optional[_Running] = None) -> bool:
        """Evict a running sequence for recompute: the youngest member of
        the LOWEST priority class present (vLLM's LIFO recompute victim,
        priority-ordered). ``exclude`` is the sequence trying to grow: it
        is never the victim, and neither is anything that outranks it
        (growing a best-effort stream must not evict an interactive one).
        Returns False when there is none: the caller then preempts the
        grower itself."""
        victims = [s for s in self._running.values() if s is not exclude]
        if exclude is not None:
            victims = [s for s in victims if s.req.priority_rank >= exclude.req.priority_rank]
        if not victims:
            return False
        self._preempt_self(max(victims, key=lambda s: (s.req.priority_rank, s.admitted_seq)))
        return True

    def _queue_insert_locked(self, req: Request) -> None:
        """Priority-ordered enqueue: ahead of the first FRESH queued
        request of a strictly lower class, FIFO within a class. Resumed
        work (preempted or journal-replayed, requeued at the front) keeps
        absolute precedence: a new interactive request must not starve a
        mid-stream resume whose client already holds tokens."""
        q = self._queue
        for i, cand in enumerate(q):
            if cand.n_generated > 0 or cand.preemptions > 0 or cand.replays > 0:
                continue
            if cand.priority_rank > req.priority_rank:
                q.insert(i, req)
                return
        q.append(req)

    @staticmethod
    def _fresh(req: Request) -> bool:
        """Never admitted (so never streamed a token): a shed candidate."""
        return (req.n_generated == 0 and req.preemptions == 0 and req.replays == 0
                and not req.handle.done())

    def _shed_victims_locked(self, rank: int, n: int) -> List[Request]:
        """Up to ``n`` shed victims for a newcomer of ``rank``: fresh
        queued requests of classes strictly below the newcomer's, lowest
        class first, youngest first within a class."""
        cands = [
            (cand.priority_rank, idx, cand)
            for idx, cand in enumerate(self._queue)
            if cand.priority_rank > rank and self._fresh(cand)
        ]
        cands.sort(key=lambda t: (t[0], t[1]), reverse=True)
        return [cand for _, _, cand in cands[:n]]

    def _shed_queued_best_effort(self) -> None:
        """Degrade level 4: every fresh queued best-effort request fails
        typed (reason "degraded"); resumed best-effort streams keep their
        place."""
        be = Priority.RANK[Priority.BEST_EFFORT]
        with self._lock:
            victims = [r for r in self._queue if r.priority_rank == be and self._fresh(r)]
            for r in victims:
                self._queue.remove(r)
        for r in victims:
            r.handle._fail(self.overload.overload_error(
                f"degraded: best-effort shed at ladder level {self.overload.ladder.level}",
                "degraded", r.priority, shed=True,
            ))

    def _note_degrade(self, old: int, new: int, pressure: float) -> None:
        """Ladder-transition hook: each level change is a flight event."""
        self.flight.record_event("degrade", level=new, prev=old, pressure=round(pressure, 3))

    def _overload_tick(self) -> None:
        """One overload-control iteration (limiter AIMD + ladder), plus
        the ladder's level-4 action: shed queued best-effort work."""
        self.overload.tick()
        if self.overload.ladder.shed_best_effort():
            self._shed_queued_best_effort()

    def _admit(self) -> bool:
        """Priority-ordered, cache-capacity-aware admission of the
        queue's head, with prefix reuse. Returns True if the head was
        admitted (prefilled) or failed."""
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
                req.trace.event("quarantine", step="mask", reason="mask_advance")
                err.flight_snapshot = self.flight.incident(
                    "quarantine", request_id=req.id, step="mask", reason="mask_advance",
                )
                if req.handle._fail(err):
                    self.stats.incr("failed")
                    self.recovery_stats.incr("quarantined")
                return True
        if req.imported_kv is not None:
            # disaggregated decode pool: the prompt's KV arrived over the
            # handoff wire; import it instead of prefilling
            return self._admit_imported(req)
        # radix planning is its own anatomy phase (prefix_plan)
        t_p0 = time.perf_counter()
        plan = engine.prefix_plan(req.prompt)
        t_p1 = time.perf_counter()
        self._span("prefix_plan", t_p0, t_p1)
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
            # admission-wait blame: when the head first stalled on blocks
            # and how many it is short; the eventual admit stamps "queued
            # Nms waiting for K block(s)" on its trace
            if self.obs_enabled and req.cache_wait_start is None:
                req.cache_wait_start = self.clock()
            req.cache_wait_short = need - engine.allocator.num_free
            return False
        with self._lock:
            if not self._queue or self._queue[0] is not req or not self._free_slots:
                # the head changed while blocks were gathered (a fleet's
                # steal_queue / adopt mutate the queue from other
                # threads): hand the blocks back, retry next iteration
                engine.allocator.free(blocks)
                return False
            self._queue.popleft()
            slot = self._free_slots.pop()
        if req.cache_wait_start is not None:
            wait_s = max(0.0, self.clock() - req.cache_wait_start)
            blame = self.capacity.note_admission_wait(wait_s, req.cache_wait_short)
            req.trace.event("cache_wait", wait_s=wait_s, blocks_short=req.cache_wait_short,
                            blame=blame)
            req.cache_wait_start = None
        self._span("admit", t_p1, time.perf_counter())
        t_q0 = time.perf_counter()
        with self._stamped():
            prep = engine.prepare_prefix(req.prompt, plan, blocks)
        t_q1 = time.perf_counter()
        self._span("prefix_plan", t_q0, t_q1)
        if prep is None:
            # a failed swap-in could not be replaced: everything was
            # handed back; requeue the head and retry next iteration
            self._free_slots.append(slot)
            with self._lock:
                self._queue.appendleft(req)
            return False
        table, shared_idx, entries, prefix_len = prep
        # blocks first, then the request: cache_report treats a set
        # _admitting as implying its (private) blocks are readable
        self._admitting_blocks = [b for i, b in enumerate(table) if i not in shared_idx]
        self._admitting = req
        t_dev = time.perf_counter()
        self._span("admit", t_q1, t_dev)
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
            self._admitting_blocks = None
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
                self.stats.incr("failed")
            return True  # did work (and must not spin on the same head)
        t_dev_end = time.perf_counter()
        # the prefill's dispatch/execute/readback spans join the
        # iteration's anatomy timeline
        execute_s = self._engine_spans()
        if not bool(engine.last_finite[0]):
            # poisoned prompt: a single-sequence step needs no bisection
            self._admitting = None
            self._admitting_blocks = None
            engine.release_admission(table, shared_idx, entries)
            self._free_slots.append(slot)
            err = PoisonedRequestError(
                f"request {req.id} produced non-finite logits at prefill",
                request_id=req.id, step="prefill", reason="nan_logits",
            )
            req.trace.event("quarantine", step="prefill", reason="nan_logits")
            err.flight_snapshot = self.flight.incident(
                "quarantine", request_id=req.id, step="prefill", reason="nan_logits",
            )
            if req.handle._fail(err):
                self.stats.incr("failed")
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
        # cleared only after the slot is registered: the blocks stay
        # visible to cache_report for the whole admission
        self._admitting = None
        self._admitting_blocks = None
        if self.supervisor.failed:  # a dead engine just served a prefill
            self.supervisor.note_engine_recovered()
        self.journal.record(req, state.admitted_seq)
        if req.handle.done():  # the watchdog reaped it while the prefill ran
            self._release(state)
            return True
        was_first = req.n_generated == 0
        now = self.clock()
        req.trace.mark_admit(slot=slot, prompt_len=len(req.prompt),
                             preemptions=req.preemptions, replays=req.replays)
        req.journey.hop("admit", slot=slot, prompt_len=len(req.prompt),
                        replica=self.fault_scope, preemptions=req.preemptions,
                        replays=req.replays)
        if self.obs_enabled and was_first and req.preemptions == 0 and req.replays == 0:
            # first-life admission only: a recompute re-admission is a
            # scheduling event, not client-visible queueing
            self.stats.observe("queue_time", max(0.0, now - req.submitted_at),
                               exemplar=req.journey.journey_id)
        self._emit_token(state, token)
        req.trace.note_tokens(1, "prefill")
        req.journey.hop("prefill", prompt_len=len(req.prompt), prefix_reused=prefix_len,
                        replica=self.fault_scope)
        if self.obs_enabled and was_first:
            self.stats.observe("ttft", max(0.0, now - req.submitted_at),
                               exemplar=req.journey.journey_id)
        self.flight.record_step(
            "prefill",
            phases={"prefix_plan": (t_p1 - t_p0) + (t_q1 - t_q0), "device": t_dev_end - t_dev},
            execute_s=execute_s, request_id=req.id, prompt_len=len(req.prompt),
            occupancy=len(self._running), queue_depth=len(self._queue),
            blocks_free=engine.allocator.num_free, prefix_reused=prefix_len,
        )
        self.token_rate.record(1)
        if req.finished():
            self._finish(state)
        elif self.handoff_sink is not None:
            self._hand_off(state)
        self._span("admit", t_dev_end, time.perf_counter())
        return True

    def _hand_off(self, state: _Running) -> None:
        """Disaggregated prefill pool: this replica's job ends at the
        first token. Pack the prompt's KV into the CRC-stamped wire
        format while the blocks are still resident, hand the slot back,
        and ship (request, payload) to the handoff supervisor; the
        stream continues on the decode pool."""
        req = state.req
        with self._stamped():
            payload = self.engine.pack_kv_blocks(state.blocks, state.cached_len)
        self._release(state)
        req.trace.event("kv_handoff_pack", n_blocks=len(payload.blocks),
                        payload_bytes=payload.nbytes)
        req.journey.hop("kv_handoff_pack", n_blocks=len(payload.blocks),
                        payload_bytes=payload.nbytes, replica=self.fault_scope)
        try:
            self.handoff_sink(req, payload)
        except Exception as e:
            # the sink must never kill the loop: a sink crash fails the
            # stream typed instead of losing it silently
            if req.handle._fail(e):
                self.stats.incr("failed")

    def _admit_imported(self, req: Request) -> bool:
        """Disaggregated decode-pool admission: commit a handed-off
        prompt's KV blocks into this engine's cache (every block
        CRC-verified before any device write) and seat the stream
        directly in a decode slot, with no prefill step. Any failure
        (injected fault, CRC mismatch, geometry mismatch) rejects the
        import and falls back to the recompute-prefill path, which
        replays the stream byte-exactly from the request object. The
        frontier was drained before this admission (a queued request
        with a free slot is a non-steady event), and the write runs on
        the stream the next step runs on, so no step in flight reads the
        blocks and the next one sees them written."""
        payload = req.imported_kv
        engine = self.engine
        t0 = time.perf_counter()
        need = engine.cache_config.blocks_for(payload.n_positions + 1)
        blocks = engine.allocator.allocate(need)
        if blocks is None:
            with self._stamped():
                reclaimed = engine.reclaim_cached(need - engine.allocator.num_free)
            if reclaimed:
                blocks = engine.allocator.allocate(need)
        if blocks is None:
            if self.obs_enabled and req.cache_wait_start is None:
                req.cache_wait_start = self.clock()
            req.cache_wait_short = need - engine.allocator.num_free
            return False
        with self._lock:
            if not self._queue or self._queue[0] is not req or not self._free_slots:
                engine.allocator.free(blocks)
                return False
            self._queue.popleft()
            slot = self._free_slots.pop()
        try:
            faults.inject(faults.GENERATION_KV_IMPORT, (req.id, len(payload.blocks)))
            bs = engine.cache_config.block_size
            if payload.block_size != bs:
                raise ValueError(
                    f"handoff block size {payload.block_size} != this engine's {bs}")
            n_import = engine.cache_config.blocks_for(payload.n_positions)
            if len(payload.blocks) < n_import:
                raise ValueError("handoff payload is missing blocks")
            wire = payload.blocks[:n_import]
            for pb in wire:
                if not pb.verify():
                    raise ValueError("imported KV block failed CRC verification")
            # every block verified BEFORE any device write, then one
            # upload and one indexed write commit the whole payload
            with self._stamped():
                engine.import_kv_blocks(blocks[:n_import], wire)
        except Exception as e:
            # reject the import: hand everything back and requeue for the
            # recompute path (the replay adopt() did not count)
            req.imported_kv = None
            engine.allocator.free(blocks)
            with self._lock:
                self._free_slots.append(slot)
                self._queue.appendleft(req)
            self.recovery_stats.incr("kv_imports_rejected")
            if req.n_generated > 0:
                req.replays += 1
                req.trace.note_replay()
                self.recovery_stats.incr("replayed_tokens", req.n_generated)
            req.trace.event("kv_import_rejected", reason=type(e).__name__,
                            n_blocks=len(payload.blocks))
            return True
        req.imported_kv = None
        self.recovery_stats.incr("kv_imports")
        state = _Running(req, slot, blocks, cached_len=payload.n_positions,
                         admitted_seq=next(self._admitted_seq))
        self._running[slot] = state
        self.journal.record(req, state.admitted_seq)
        if req.handle.done():  # reaped while the blocks were in flight
            self._release(state)
            return True
        req.trace.mark_admit(slot=slot, prompt_len=len(req.prompt),
                             preemptions=req.preemptions, replays=req.replays)
        req.trace.event("kv_import", n_blocks=len(payload.blocks),
                        n_positions=payload.n_positions, payload_bytes=payload.nbytes)
        req.journey.hop("admit", slot=slot, prompt_len=len(req.prompt),
                        replica=self.fault_scope, imported=True,
                        n_blocks=len(payload.blocks))
        self.flight.record_step(
            "kv_import", phases={"admit": time.perf_counter() - t0},
            request_id=req.id, prompt_len=len(req.prompt),
            occupancy=len(self._running), queue_depth=len(self._queue),
            blocks_free=engine.allocator.num_free,
        )
        self._span("admit", t0, time.perf_counter())
        return True

    def _emit_token(self, state: _Running, token: int) -> None:
        state.req.generated.append(int(token))
        state.req.handle._emit(int(token))
        # durable serving: the journal buffers the token delta (a no-op on
        # the base journal); the write happens once per iteration in
        # journal.flush_step()
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
            # degrade ladder: level 1 caps the window, level 2 disables
            # drafting — exact either way (any k, 0 included, emits the
            # same greedy stream)
            cap = self.overload.spec_cap()
            if cap is not None:
                state.step_k = min(state.step_k, cap)

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
        # the failing step goes on the flight ring before any quarantine
        # or restart incident freezes its snapshot
        self._flight_step()
        self.flight.record_event(
            "nan_blame", step=kind, request_ids=[s.req.id for s in blamed], live=len(live),
        )
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
        t_c0 = time.perf_counter()
        order = sorted(self._running.values(), key=lambda s: s.slot)
        step, probe = self._decode_step_fns(order)
        self._span("schedule", t_c0, time.perf_counter())
        info = self._step_info
        info["kind"] = "decode"
        t_dev = time.perf_counter()
        out = self.supervisor.run_step("decode", step, order, probe)
        self._step_phases["device"] = time.perf_counter() - t_dev
        if out is None:
            info["handled_failure"] = True
            return True  # failure handled: quarantined or journal-replayed
        info["execute_s"] = self._engine_spans()
        if self._quarantine_nan("decode", order):
            info["handled_failure"] = True
            return True
        t_book = time.perf_counter()
        n_live, _ = self._scatter_decode(order, out)
        self._span("bookkeep", t_book, time.perf_counter())
        info["emitted"] = n_live
        self.token_rate.record(n_live)
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
            state.req.trace.note_tokens(1, "decode")
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
        t_b0 = time.perf_counter()
        out = self.engine.consume_decode(f.handle)
        # completion stamp: the successor only starts device work now, so
        # its heartbeat age and execute span are measured from here
        nf = self._pipe
        if nf is not None:
            self._heartbeat = (nf.hb_seq, self.clock())
            nf.handle.t_started = time.perf_counter()
        else:
            self._heartbeat = None
        ph = self._step_phases
        ph["device"] = ph.get("device", 0.0) + (time.perf_counter() - t_b0)
        self._step_info["execute_s"] = self._step_info.get("execute_s", 0.0) + self._engine_spans()
        if self.supervisor._consume_stall(f.seq0):
            # the watchdog tripped while this chain was in flight: the
            # late result is stale; discard everything and replay (the
            # iteration stays out of the anatomy's hot window)
            self._step_info["handled_failure"] = True
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
                self._step_info["handled_failure"] = True
                return None
        t_book = time.perf_counter()
        n_live, finish = self._scatter_decode(f.states, out, defer_finish=True)
        self.token_rate.record(n_live)
        if finish:
            # the successor may still be writing into the finishing
            # streams' blocks: drain it (bookkept; its tokens for finished
            # slots are skipped) before any release
            if self._pipe is not None:
                self._drain_frontier("finish")
            for st in finish:
                if self._running.get(st.slot) is st and not st.req.handle.done():
                    self._finish(st)
        self._span("bookkeep", t_book, time.perf_counter())
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
        self._step_spans.append(("dispatch", handle.t0, handle.t_disp))
        ph = self._step_phases
        ph["dispatch"] = ph.get("dispatch", 0.0) + (handle.t_disp - handle.t0)
        return _Frontier(handle, list(live), positions, active, temps, top_ks, seeds,
                         counts, tables, sig, seq, seq0)

    def _pipeline_failure(self, e: BaseException, since_seq: int) -> None:
        """A pipelined dispatch or consume failed. Discard what is in
        flight, then give the failed step the sequential treatment from
        the point after its first failure (``supervisor.resume_step``). A
        ``donate`` engine goes straight to reset + journal replay."""
        self.flight.record_event("pipeline_failure", error=repr(e)[:200])
        self._discard_frontier()
        self._step_info["handled_failure"] = True
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
        self._step_info["execute_s"] = self._engine_spans()
        if self._quarantine_nan("decode", order):
            return
        n_live, _ = self._scatter_decode(order, out)
        self.token_rate.record(n_live)
        self._step_info["handled_failure"] = False
        self._step_info["emitted"] = n_live

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
        info = self._step_info
        t_s0 = time.perf_counter()
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
            info["kind"] = "decode"
            self._pipe = None
            self._span("schedule", t_s0, time.perf_counter())
            try:
                n = self._consume_and_finish(f)
            except Exception as e:
                self._pipeline_failure(e, f.seq0)
                return True
            if n is not None:
                info["emitted"] = n
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
                self._span("schedule", t_s0, time.perf_counter())
                if f is not None:
                    info["kind"] = "decode"
                    self._drain_frontier("pressure")
                    return True
                return None
        self._span("schedule", t_s0, time.perf_counter())
        info["kind"] = "decode"
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
            info["emitted"] = 0  # warm-up: its tokens arrive next iteration
            return True
        try:
            n = self._consume_and_finish(f)
        except Exception as e:
            self._pipeline_failure(e, f.seq0)
            return True
        if n is not None:
            info["emitted"] = n
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
            self.capacity.note_trim(len(extra))

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
        info = self._step_info
        info["kind"] = "verify"
        t_c0 = time.perf_counter()
        order = sorted(self._running.values(), key=lambda s: s.slot)
        last, start, tables, _active, temps, top_ks, seeds, counts = self._collect_slots(order)
        t_draft = time.perf_counter()
        self._span("schedule", t_c0, t_draft)
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
                    self.stats.incr("drafter_errors")
            if req.mask_state is not None and draft:
                # a grammar-banned draft token would be rejected by the
                # masked target anyway: cut to the longest legal prefix
                draft = req.mask_state.filter_draft(draft, req.sampling.eos_id)
            window[i, 1: 1 + len(draft)] = draft
            n_draft[i] = len(draft)
        self._span("draft", t_draft, time.perf_counter())
        info["drafted"] = int(np.maximum(n_draft, 0).sum())
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

        t_dev = time.perf_counter()
        result = self.supervisor.run_step("verify", step, order, probe)
        self._step_phases["device"] = time.perf_counter() - t_dev
        if result is None:
            info["handled_failure"] = True
            return True  # failure handled: quarantined or journal-replayed
        info["execute_s"] = self._engine_spans()
        out, n_emitted = result
        if self._quarantine_nan("verify", order):
            info["handled_failure"] = True
            return True
        t_book = time.perf_counter()
        n_accepted = 0
        n_live_tokens = 0
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
            n_accepted += accepted
            req.update_speculation(proposed=proposed, accepted=accepted)
            req.trace.note_speculation(proposed, accepted)
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
            self.spec_stats.record_window(proposed=proposed, accepted=accepted, emitted=emitted)
            req.trace.note_tokens(emitted, "verify")
            state.cached_len += emitted
            self._trim_blocks(state)
            n_live_tokens += emitted
            if req.finished():
                self._finish(state)
        self._span("bookkeep", t_book, time.perf_counter())
        info["accepted"] = n_accepted
        info["emitted"] = n_live_tokens
        self.token_rate.record(n_live_tokens)
        return True

    def _span(self, name: str, t0: float, t1: float) -> None:
        """Record one host span of THIS iteration: perf_counter stamps for
        the anatomy profiler, its duration added to the flight record's
        phases. Loop thread only."""
        self._step_spans.append((name, t0, t1))
        ph = self._step_phases
        ph[name] = ph.get(name, 0.0) + (t1 - t0)

    def _engine_spans(self) -> float:
        """Adopt the engine's last step's dispatch/block/execute/readback
        spans into this iteration's anatomy spans (the flight phases keep
        their "device" total). Returns the step's execute seconds."""
        spans = self.engine.last_step_spans
        self._step_spans.extend(spans)
        return sum(s1 - s0 for name, s0, s1 in spans if name == "execute")

    def _flight_step(self) -> None:
        """Write THIS iteration's flight record (once per step): normally
        at the end of ``step()``, early when NaN blame is about to freeze
        an incident snapshot, so the failing step is on the ring its own
        postmortem is cut from."""
        if self._step_recorded or not self.flight.enabled:
            return
        self._step_recorded = True
        info = dict(self._step_info)
        self.flight.record_step(
            info.pop("kind", "admit"),
            phases=dict(self._step_phases),
            occupancy=len(self._running),
            queue_depth=len(self._queue),
            blocks_free=self.engine.allocator.num_free,
            **info,
        )

    # ---------------------------------------------------------------- step
    def step(self) -> bool:
        """One scheduling iteration. With overlap on, a steady iteration
        pipelines dispatch/consume; otherwise (and after any frontier
        drain): expire, quarantine parked grammar errors, admit
        (join-mid-flight), plan speculation,
        grow/preempt, then decode — or verify, when any running request
        speculates. Returns True if any work happened. A working iteration
        writes one flight record and one step-anatomy observation (a
        handled failure stays out of the anatomy's hot window); every
        iteration then flushes the journal's group commit, integrates the
        cache's time at pressure and ticks the overload controller.

        With a ``fault_scope`` (a fleet replica) the whole iteration runs
        inside that injection scope (the pipeline's dispatch and its
        consume, which happen in step() calls, and the supervisor's
        recovery path), so chaos plans can target this replica alone."""
        if self.fault_scope is None:
            return self._step_impl()
        with faults.scope(self.fault_scope):
            return self._step_impl()

    def _step_impl(self) -> bool:
        self._step_phases = {}
        info = self._step_info = {}
        self._step_spans = []
        self._step_recorded = False
        t0 = time.perf_counter()
        if self.overlap:
            r = self._try_pipeline()
            if r is not None:
                if r:
                    self._flight_step()
                    self.anatomy.observe_step(
                        info.get("kind", "decode"), self._step_spans, t0, time.perf_counter(),
                        tokens=int(info.get("emitted", 0)),
                        hot=not info.get("handled_failure", False),
                    )
                # the WAL's group commit runs while the dispatched step
                # executes (a no-op on the base journal)
                self.journal.flush_step()
                self.capacity.tick()
                self._overload_tick()
                return r
        self._expire()
        self._sweep_mask_errors()
        t1 = time.perf_counter()
        self._span("schedule", t0, t1)
        admitted = 0
        while self._admit():
            admitted += 1
        t2 = time.perf_counter()
        self._plan_speculation()
        self._grow()
        self._span("schedule", t2, time.perf_counter())
        if admitted:
            info["admitted"] = admitted
        speculating = any(s.step_k > 0 for s in self._running.values())
        stepped = self._verify_once() if speculating else self._decode_once()
        did = stepped or admitted > 0
        if did:
            self._flight_step()
            self.anatomy.observe_step(
                info.get("kind", "admit"), self._step_spans, t0, time.perf_counter(),
                tokens=int(info.get("emitted", 0)) + admitted,
                hot=not info.get("handled_failure", False),
            )
        # durable group commit: one write for every journal record this
        # iteration buffered (admits, token deltas, ends)
        self.journal.flush_step()
        # time at pressure integrates AFTER the step's allocations; the
        # overload controller ticks on the fresh pressure flag
        self.capacity.tick()
        self._overload_tick()
        return did
