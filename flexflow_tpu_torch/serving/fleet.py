"""Fleet serving tier (port of ``flexflow_tpu/serving/fleet.py``): N
generation-engine replicas behind a cache-aware router, with drain /
replace / failover, and the disaggregated prefill and decode pools joined
by the CRC-stamped KV handoff.

A :class:`Fleet` owns N replicas, each a full :class:`GenerationModel`
with its own continuous-batching scheduler (its own loop thread under
``start()``), supervisor, circuit breaker, step watchdog and flight
ring, and three cooperating pieces:

* :class:`FleetRouter` places each request by **prefix affinity**
  (resident-block overlap against each replica's radix prefix index,
  plus block-aligned overlap with prompts already queued or running
  there) and **least-loaded score** (queue depth, slot occupancy, free
  KV blocks, TTFT error-budget burn). Affinity only breaks load ties
  (within ``TIE_MARGIN``). A DRAINING or breaker-OPEN replica is never a
  candidate, a saturated one is spilled past (``would_admit``), and
  decisions are counted by reason (``router_decisions_total{reason}``).
* the **fleet supervisor** (:meth:`Fleet.check`, a monitor thread under
  ``start()``, manual calls on virtual clocks) turns health signals into
  lifecycle transitions: a watchdog trip, a breaker held open or a
  quarantine storm drains the replica; a finished (or timed-out) drain
  replaces it with a fresh replica warmed BEFORE it takes traffic (its
  step graphs are captured by the warmup); an exhausted restart budget
  fails its streams over, then replaces it.
* **cross-replica journal-replay failover**: every replica scheduler
  carries a ``failover_sink``; when its supervisor gives up, the live
  streams leave the dead scheduler entirely and the fleet re-admits each
  one on a survivor through ``ContinuousBatchingScheduler.adopt()``. The
  journal state is the request object, engine-agnostic, so the
  recompute-prefill path resumes every stream byte-exactly. Requests
  with no eligible survivor wait in a fleet pending queue and ride onto
  the replacement replica.

With a ``durability_root`` every replica slot journals into its own WAL
directory (``slot-N``): a replacement inherits the slot, a failed-over
stream is retired from the dead replica's journal with END("migrated"),
a fleet built after process death warm-restarts every slot, and
:meth:`Fleet.rolling_restart` swaps the replicas one at a time with no
capacity dip. The fleet's router records its own journey lane
(``{rid_prefix}router``), so one request's journey stitches across the
router, the replicas it ran on and the handoff.

:class:`DisaggregatedFleet` is two fleets, a prefill pool and a decode
pool: a prefill replica emits the first token, packs the prompt's KV
into a :class:`~flexflow_tpu_torch.generation.prefix.KVHandoffPayload`
(one gather and one copy to the host) and hands the stream to the
:class:`HandoffManager`, which verifies every block's CRC and adopts the
stream onto the least-loaded decode replica (``adopt(imported=...)``,
one upload and one indexed cache write); any failure degrades to a
recompute replay on the decode pool, never to a corrupted stream.

``Fleet(n=1)`` duck-types :class:`GenerationModel` (same
submit/stats/health surface, same typed errors), so callers migrate by
swapping the constructor; :meth:`InferenceServer.register_generation`
takes either fleet. All replicas of one process share one device: each
steps on its own thread and replays its own captured step graphs on the
current stream; a replacement captures its graphs (capture is
thread-local) while the survivors keep replaying theirs.
"""
from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..generation.engine import GenerationEngine, SamplingParams
from ..generation.prefix import KVHandoffPayload, PackedBlock
from ..generation.recovery import EngineFailedError
from ..generation.scheduler import GenerationHandle, Request
from ..obs import FlightRecorder, JourneyRecorder
from ..runtime import faults
from .generation import GenerationModel
from .overload import AutoscaleAdvisor, OverloadConfig, Priority
from .resilience import (
    CircuitOpenError,
    DeadlineExceededError,
    OverloadedError,
    ShuttingDownError,
)
from .stats import FleetStats, Histogram


class ReplicaState:
    """Replica lifecycle states (strings, so reports stay JSON-plain)."""

    ACTIVE = "active"      # eligible for routing
    DRAINING = "draining"  # finishing residents; no new placements
    RETIRING = "retiring"  # replaced, but still finishing residents
    DEAD = "dead"          # engine declared failed; streams failed over


class Replica:
    """One fleet member: id + GenerationModel + lifecycle state."""

    def __init__(self, rid: str, model: GenerationModel, slot: int = -1):
        self.id = rid
        self.model = model
        # durable serving: the stable WAL-directory slot
        # this replica occupies (its replacement inherits it, so the
        # journal survives the swap); -1 when the fleet has no
        # durability_root
        self.slot = slot
        # a rolling restart owns this replica's drain->replace cycle;
        # the supervisor's DRAINING auto-replace must keep its hands off
        self.restarting = False
        self.state = ReplicaState.ACTIVE
        self.since = 0.0  # last state-transition time (fleet clock)
        # health-signal edge detection for the fleet supervisor
        self.seen_watchdog_trips = 0
        self.breaker_open_checks = 0  # consecutive checks observed OPEN
        # quarantine-storm detection: quarantines since the last
        # completed request on this replica
        self.seen_completed = 0
        self.seen_quarantined = 0
        self.quarantine_streak = 0
        self.drain_started: Optional[float] = None

    @property
    def scheduler(self):
        return self.model.scheduler

    @property
    def engine(self) -> GenerationEngine:
        return self.model.engine

    def eligible(self) -> bool:
        """May the router place NEW traffic here? Active, breaker not
        holding traffic, and not shutting down."""
        return (
            self.state == ReplicaState.ACTIVE
            and self.model.breaker.ready()
            and not self.scheduler._draining
            and not self.scheduler._stopped
        )


class FleetRouter:
    """Cache-aware placement: least-loaded wins under skew; prefix
    affinity breaks ties among near-equally loaded replicas."""

    # load-score ties within this margin are broken by prefix affinity
    # (one queued/running request = 1.0, so affinity never outvotes a
    # whole request of load imbalance)
    TIE_MARGIN = 0.5
    PREFIX_CAP = 256  # tokens of prefix compared/remembered per prompt

    def __init__(self, fleet: "Fleet", stats: FleetStats):
        self.fleet = fleet
        self.stats = stats

    # ------------------------------------------------------------ scoring
    def load_score(self, replica: Replica) -> float:
        """Smaller = less loaded. Inputs are the telemetry every replica
        already maintains: queue depth + slot occupancy (unit weight
        each), KV-block pressure (0..1), and the replica's fast-window
        TTFT burn (capped — a replica burning its latency budget sheds
        load even when its queue looks short)."""
        s = replica.scheduler
        alloc = s.engine.allocator
        load = float(len(s._queue) + len(s._running))
        load += 1.0 - alloc.num_free / max(1, alloc.num_total)
        load += 0.25 * min(2.0, self._ttft_burn(s))
        return load

    @staticmethod
    def _ttft_burn(scheduler) -> float:
        burn = 0.0
        try:
            for obj in scheduler.slo.objectives:
                if "ttft" in obj.name:
                    burn = max(burn, scheduler.slo.burn_rate(obj.name, "fast"))
        except Exception:
            pass  # routing must never die of an SLO accounting race
        return burn

    def affinity(self, replica: Replica, prompt: Sequence[int]) -> int:
        """Reusable-KV overlap (tokens) between ``prompt`` and the
        replica: the radix prefix index's actual matched run (resident
        or host-tier blocks the engine would reuse instead of
        prefilling), plus the block-aligned common prefix with prompts
        already queued or running there — KV that will be cached by the
        time this request admits. Replaces the old recently-routed
        string comparison, which scored KV that might be long evicted
        and counted sub-block overlap no engine can reuse. Reads live
        structures owned by other threads (the loop thread mutates
        _running; the index mutates at admissions), so a mid-iteration
        mutation degrades to zero affinity rather than failing the
        route."""
        try:
            engine = replica.engine
            best = engine.prefix_cache.probe(prompt[: self.PREFIX_CAP])
            bs = engine.cache_config.block_size
            cap = max(0, len(prompt) - 1)
            sched = replica.scheduler
            pending = [r.original_prompt for r in list(sched._queue)]
            pending += [
                st.req.original_prompt for st in list(sched._running.values())
            ]
            for p in pending:
                n = 0
                for a, b in zip(p[: self.PREFIX_CAP], prompt):
                    if a != b:
                        break
                    n += 1
                best = max(best, min((n // bs) * bs, cap))
        except RuntimeError:
            return 0
        return best

    @staticmethod
    def _would_admit(replica: Replica, priority: str) -> bool:
        """Overload-gate probe for one replica (serving/overload.py):
        would its scheduler admit this priority class right now? A
        mid-iteration race degrades to True — the replica's own submit
        still answers with the typed rejection."""
        try:
            return replica.scheduler.overload.would_admit(priority)
        except Exception:
            return True

    # ------------------------------------------------------------ routing
    def route(
        self, prompt: Sequence[int], priority: str = Priority.STANDARD,
    ) -> Tuple[Replica, str]:
        """Pick the replica for one request; returns (replica, reason).
        Saturated replicas (their overload controller would refuse this
        priority) are SPILLED past: placement falls to whichever
        eligible replicas still admit, and only when every eligible
        replica is saturated does the fleet shed — the typed
        OverloadedError, counted as a fleet shed. Raises
        CircuitOpenError when no replica is eligible at all (fleet
        brownout) — except the single-replica fleet, which delegates to
        its lone replica so submit raises exactly the bare
        GenerationModel's typed error (parity)."""
        reps = self.fleet._replicas_snapshot()
        faults.inject(faults.FLEET_ROUTE, (list(prompt), [r.id for r in reps]))
        cands = [r for r in reps if r.eligible()]
        if not cands:
            if len(reps) == 1:
                # n=1 parity: the lone replica's own submit raises the
                # right typed error (CircuitOpen / ShuttingDown)
                self.stats.note_decision("only_candidate")
                return reps[0], "only_candidate"
            self.stats.note_decision("no_candidate")
            raise CircuitOpenError(
                "fleet brownout: no eligible replica "
                f"({', '.join(f'{r.id}={r.state}' for r in reps)})"
            )
        admitting = [r for r in cands if self._would_admit(r, priority)]
        spilled = len(admitting) < len(cands)
        if not admitting:
            if len(reps) == 1:
                # n=1 parity: the lone replica's submit raises its own
                # typed OverloadedError with the real reason
                self.stats.note_decision("only_candidate")
                return reps[0], "only_candidate"
            # fleet-wide shed: EVERY eligible replica is saturated, so
            # spilling has nowhere left to go. The reason reflects the
            # actual mechanism: "degraded" when every replica's ladder
            # is shedding this class, "limiter" otherwise.
            self.stats.note_decision("fleet_shed")
            self.fleet.fleet_stats.incr("sheds")
            try:
                degraded = all(
                    r.scheduler.overload.degraded_reject(priority)
                    for r in cands
                )
                retry_after = max(
                    r.scheduler.overload.retry_after_s() for r in cands
                )
            except Exception:
                degraded, retry_after = False, 1.0
            raise OverloadedError(
                f"fleet saturated: no eligible replica admits {priority} "
                f"traffic ({', '.join(r.id for r in cands)})",
                reason="degraded" if degraded else "limiter",
                priority=priority, retry_after_s=retry_after,
            )
        cands = admitting
        if len(cands) == 1:
            choice, reason = cands[0], ("spill" if spilled else "only_candidate")
        else:
            loads = {r.id: self.load_score(r) for r in cands}
            best = min(loads.values())
            near = [r for r in cands if loads[r.id] <= best + self.TIE_MARGIN]
            if len(near) > 1:
                affs = {r.id: self.affinity(r, prompt) for r in near}
                amax = max(affs.values())
                if amax > 0:
                    choice = min(
                        (r for r in near if affs[r.id] == amax),
                        key=lambda r: (loads[r.id], r.id),
                    )
                    reason = "affinity"
                else:
                    choice = min(near, key=lambda r: (loads[r.id], r.id))
                    reason = "least_loaded"
            else:
                choice, reason = near[0], "least_loaded"
        if spilled:
            # placement succeeded only because a saturated replica was
            # passed over — count the spill, whatever broke the tie
            reason = "spill"
        self.stats.note_decision(reason)
        return choice, reason

    def place_failover(self, replicas: List[Replica]) -> Optional[Replica]:
        """Survivor choice for a migrated stream: least-loaded eligible
        replica (affinity is meaningless — the stream's KV blocks died
        with its engine)."""
        cands = [r for r in replicas if r.eligible()]
        if not cands:
            return None
        return min(cands, key=lambda r: (self.load_score(r), r.id))


class _FleetBreakerView:
    """Duck-typed breaker for server-level readiness: the fleet is
    'open' only when NO replica can take traffic."""

    def __init__(self, fleet: "Fleet"):
        self._fleet = fleet

    def ready(self) -> bool:
        return any(r.eligible() for r in self._fleet._replicas_snapshot())

    @property
    def state(self) -> str:
        return "closed" if self.ready() else "open"


class _MergedTraceRing:
    """Read-only merged view over every replica's trace ring (the
    fleet-level ``GET /v2/debug/traces`` surface)."""

    def __init__(self, fleet: "Fleet"):
        self._fleet = fleet

    def _rings(self):
        return [r.model.trace_ring for r in self._fleet._replicas_snapshot()]

    @property
    def capacity(self) -> int:
        return sum(r.capacity for r in self._rings())

    def __len__(self) -> int:
        return sum(len(r) for r in self._rings())

    def recent(self, n: int = 32):
        traces = [t for ring in self._rings() for t in ring.recent(n)]
        traces.sort(key=lambda t: t.t_finish or 0, reverse=True)
        return traces[:n]

    def get(self, request_id: int):
        for ring in self._rings():
            tr = ring.get(request_id)
            if tr is not None:
                return tr
        return None


class _FleetAggregateStats:
    """``/v2/stats`` view of a multi-replica fleet: per-replica
    snapshots plus summed admission counters and load gauges (the
    per-replica Prometheus families carry everything else)."""

    _SUM_GAUGES = ("queue_depth", "running", "tokens_generated", "preemptions")

    def __init__(self, fleet: "Fleet"):
        self._fleet = fleet

    def snapshot(self) -> Dict:
        from .stats import ServingStats

        per = {
            r.id: r.model.stats.snapshot()
            for r in self._fleet._replicas_snapshot()
        }
        folded = self._fleet._folded_snapshot()
        out: Dict = {}
        for c in ServingStats.COUNTERS:
            out[c] = sum(int(p.get(c) or 0) for p in per.values())
            out[c] += int(folded.get(c) or 0)
        for g in self._SUM_GAUGES:
            out[g] = sum(p.get(g) or 0 for p in per.values())
        out["fleet"] = self._fleet.fleet_stats.snapshot()
        out["fleet"]["replicas_by_state"] = self._fleet.states()
        out["fleet"]["pending"] = len(self._fleet._pending)
        out["replicas"] = per
        return out


class Fleet:
    """N warm generation replicas behind a cache-aware router, with a
    supervisor owning the drain / replace / failover lifecycle.

    ``engine_factory`` builds one fresh :class:`GenerationEngine` per
    replica (initial fleet AND replacements) — replicas are homogeneous
    by construction, which is what makes cross-replica journal replay
    exact. ``scheduler_kwargs`` are passed to every replica's
    continuous-batching scheduler (clock/breaker/recovery/watchdog —
    pass factories for per-replica objects exactly as with the batcher;
    plain values like ``recovery=RecoveryPolicy(...)`` are fine).

    Duck-types :class:`GenerationModel` so ``InferenceServer.
    register_generation`` and existing callers work unchanged; with
    ``n=1`` the delegation is total (same stats object, same breaker,
    same typed errors, no extra step signatures).
    """

    def __init__(
        self,
        engine_factory: Callable[[], GenerationEngine],
        n: int = 1,
        *,
        name: str = "generator",
        clock: Callable[[], float] = time.monotonic,
        warmup: bool = True,
        warm_prompt: Sequence[int] = (1, 2, 3, 1, 2, 3),
        warm_tokens: int = 3,
        auto_replace: bool = True,
        drain_timeout_s: float = 60.0,
        poll_s: float = 0.25,
        max_spawn_retries: int = 3,
        quarantine_streak_limit: int = 3,
        observability: bool = True,
        scheduler_kwargs: Optional[dict] = None,
        rid_prefix: str = "r",
        handoff_sink: Optional[Callable] = None,
        durability_root: Optional[str] = None,
        durability_fsync: bool = True,
        durability_wall_clock: Callable[[], float] = time.time,
    ):
        if n < 1:
            raise ValueError("a fleet needs at least one replica")
        self.engine_factory = engine_factory
        # disaggregated serving (DisaggregatedFleet): a distinct replica
        # id namespace per pool (chaos scopes target ONE pool's replica)
        # and the handoff sink installed on every spawned replica's
        # scheduler — replacements included, so a replaced prefill
        # replica keeps handing off
        self.rid_prefix = rid_prefix
        self.handoff_sink = handoff_sink
        # durable serving: one WAL directory per replica
        # SLOT under this root; a replacement replica inherits its
        # predecessor's slot directory, so a fleet restarted after
        # process death warm-restarts every slot's journal
        self.durability_root = durability_root
        self.durability_fsync = durability_fsync
        self.durability_wall_clock = durability_wall_clock
        self.name = name
        self.clock = clock
        self.warmup = warmup
        self.warm_prompt = list(warm_prompt)
        self.warm_tokens = warm_tokens
        self.auto_replace = auto_replace
        self.drain_timeout_s = drain_timeout_s
        self.poll_s = poll_s
        self.max_spawn_retries = max_spawn_retries
        self.quarantine_streak_limit = quarantine_streak_limit
        self._scheduler_kwargs = dict(scheduler_kwargs or {})
        self._scheduler_kwargs.setdefault("clock", clock)
        self._scheduler_kwargs.setdefault("observability", observability)
        self.fleet_stats = FleetStats()
        # fleet lifecycle ring: route/drain/replace/failover/migrate
        # events with dual-clock stamps, surfaced on GET /v2/fleet
        self.fleet_flight = FlightRecorder(
            capacity=256, enabled=observability, sched_clock=clock
        )
        self._lock = threading.RLock()
        self._pending: deque = deque()  # requests awaiting ANY replica; guarded-by: _lock
        # counters folded in from retired replicas AND fleet-pending
        # terminal outcomes, so the aggregate /v2/stats view stays
        # cumulative across replacements and never under-reports
        # failures that happened outside any replica
        self._folded_counters: Dict[str, int] = {}  # guarded-by: _lock
        self._rid = itertools.count()
        self._spawn_fail_streak = 0
        self._draining = False
        self._stopped = False
        self._started = False
        self._monitor: Optional[threading.Thread] = None
        self._monitor_stop = threading.Event()
        self.router = FleetRouter(self, self.fleet_stats)
        # fleet-wide journeys: the router's own span lane. A journey
        # minted here (no HTTP ingress in front: a caller driving the
        # fleet directly) still records its routing decision before the
        # replica's submit hop. Gated exactly like each replica's
        # recorder so journeys-off fleets stay inert.
        _j = self._scheduler_kwargs.get("journeys")
        self.journeys = (
            JourneyRecorder(lane=f"{rid_prefix}router", clock=clock)
            if observability and (_j is None or bool(_j)) else None
        )
        # autoscaling signal: sustained limiter saturation across every
        # eligible replica -> want-more; sustained fleet-wide idleness ->
        # want-fewer. Published on GET /v2/fleet/autoscale and as the
        # flexflow_serving_autoscale_* gauges. Hold times come from the
        # same typed OverloadConfig that tunes each replica's limiter
        # and ladder (scheduler_kwargs["overload"]): one tuning surface.
        self.autoscale = AutoscaleAdvisor.from_config(
            self._scheduler_kwargs.get("overload") or OverloadConfig(),
            clock=clock,
        )
        # replaced-but-still-busy replicas: out of the routing set, kept
        # stepping until their residents finish (or expire), then torn
        # down — a drain timeout must never abort live streams
        self._retiring: List[Replica] = []  # guarded-by: _lock
        # journey lanes of torn-down replicas (bounded): a failed-over
        # stream's pre-crash hops live ONLY in the dead replica's span
        # ring — dropping it with the replica would leave a gap in
        # every stitched journey that crossed the failover
        self._dead_journeys: deque = deque(maxlen=8)  # guarded-by: _lock
        self._dead_spools: deque = deque(maxlen=8)    # guarded-by: _lock
        # initial spawns warm-restart their slot journals: a fleet
        # coming back after process death replays every unfinished
        # stream the dead process journaled
        self.replicas: List[Replica] = [  # guarded-by: _lock
            self._spawn(slot=i, warm_restart=True) for i in range(n)
        ]

    # ----------------------------------------------------------- replicas
    def _replicas_snapshot(self) -> List[Replica]:
        with self._lock:
            return list(self.replicas)

    def _spawn(self, slot: int = -1, warm_restart: bool = False) -> Replica:
        """Build + warm one replica. The ``fleet.replica_spawn`` fault
        site fires BEFORE the factory so chaos tests can fail a
        replacement; warmup runs the steady-state step programs (the
        fixed-shape decode, the warm prompt's prefill bucket and, when
        the fleet speculates by default, the verify step; on a GPU their
        CUDA graphs are captured here) so the replica's first real
        request never captures.

        With a ``durability_root``, the replica attaches a WAL under
        its slot directory; ``warm_restart=True`` (initial fleet
        bring-up, rolling restarts) additionally replays the slot's
        journal. Auto-replacements skip the replay: their predecessor
        is (or was) alive in-process — its streams failed over or are
        still finishing on a retiring engine, and an END("migrated")
        record retired each moved stream from the journal already."""
        rid = f"{self.rid_prefix}{next(self._rid)}"
        faults.inject(faults.FLEET_REPLICA_SPAWN, rid)
        engine = self.engine_factory()
        if self.warmup:
            engine.generate(
                [list(self.warm_prompt)],
                SamplingParams(max_new_tokens=self.warm_tokens),
                speculation=self._scheduler_kwargs.get("speculation"),
                draft_params=self._scheduler_kwargs.get("draft_params"),
            )
        kwargs = dict(self._scheduler_kwargs)
        for key in ("breaker", "retry"):
            # stateful per-replica objects must not be shared: pass them
            # as zero-arg factories (same convention as make_batcher)
            if callable(kwargs.get(key)):
                kwargs[key] = kwargs[key]()
        model = GenerationModel(
            engine, name=self.name, fault_scope=rid, **kwargs
        )
        if self.durability_root is not None and slot >= 0:
            from .durable import DurabilityConfig  # late: optional tier

            model.enable_durability(DurabilityConfig(
                wal_dir=os.path.join(self.durability_root, f"slot-{slot}"),
                fsync=self.durability_fsync,
                wall_clock=self.durability_wall_clock,
            ))
            if warm_restart:
                restart = model.durable.warm_restart()
                if restart["replayed_streams"] or restart["torn_records"]:
                    self.fleet_flight.record_event(
                        "warm_restart", replica=rid, slot=slot,
                        replayed=restart["replayed_streams"],
                        tokens=restart["replayed_tokens"],
                        torn=restart["torn_records"],
                    )
        rep = Replica(rid, model, slot=slot)
        rep.since = self.clock()
        model.scheduler.failover_sink = (
            lambda reqs, cause, _rep=rep: self._on_replica_failed(_rep, reqs, cause)
        )
        if self.handoff_sink is not None:
            model.scheduler.handoff_sink = (
                lambda req, payload, _rep=rep:
                    self.handoff_sink(req, payload, _rep)
            )
        if self._started:
            model.start()
        return rep

    def states(self) -> Dict[str, int]:
        out = {s: 0 for s in (ReplicaState.ACTIVE, ReplicaState.DRAINING, ReplicaState.DEAD)}
        with self._lock:
            members = list(self.replicas) + list(self._retiring)
        for r in members:
            out[r.state] = out.get(r.state, 0) + 1
        return out

    # ------------------------------------------------------------ journeys
    def journey_recorders(self) -> List:
        """Every live span lane this fleet owns — the router's plus one
        per replica (retiring included: their spans are still the only
        live copy of hops on streams that finished there). The debug
        endpoints hand these to a JourneyIndex at query time."""
        out = [self.journeys] if self.journeys is not None else []
        with self._lock:
            members = list(self.replicas) + list(self._retiring)
            dead = list(self._dead_journeys)
        for r in members:
            rec = getattr(r.model, "journeys", None)
            if rec is not None:
                out.append(rec)
        out.extend(dead)
        return out

    def journey_spools(self) -> List:
        """Every replica's on-disk span spool (durable fleets only) —
        the joinable record of pre-crash hops."""
        out = []
        with self._lock:
            members = list(self.replicas) + list(self._retiring)
            dead = list(self._dead_spools)
        for r in members:
            spool = getattr(r.model, "journey_spool", None)
            if spool is not None:
                out.append(spool)
        # same slot directory across restarts: the successor's spool
        # covers the same segments, and _collect dedups by span id
        out.extend(s for s in dead if s not in out)
        return out

    # ------------------------------------------------------------- submit
    def submit(
        self,
        prompt: Sequence[int],
        sampling: Optional[SamplingParams] = None,
        deadline_s: Optional[float] = None,
        speculation=None,
        transport: Optional[str] = None,
        priority: Optional[str] = None,
        journey=None,
        response_format: Optional[Dict] = None,
    ) -> GenerationHandle:
        """Route + enqueue one request. Typed rejections mirror the
        single-model path (OverloadedError / QueueFullError /
        CircuitOpenError / ShuttingDownError / DeadlineExceededError),
        plus CircuitOpenError for a fleet-wide brownout and
        OverloadedError when every eligible replica is saturated (the
        router spills by priority first; the fleet-wide shed is the
        last resort). ``response_format`` compiles on the chosen
        replica, as on a bare GenerationModel."""
        if self._draining or self._stopped:
            raise ShuttingDownError("fleet draining")
        priority = Priority.parse(priority)
        replica, reason = self.router.route(prompt, priority)
        if journey is None and self.journeys is not None:
            # no ingress in front of this fleet: the journey roots at
            # the router so the routing decision is still a hop
            journey = self.journeys.mint()
        if journey is not None:
            journey.hop("route", replica=replica.id, reason=reason)
        handle = replica.model.submit(
            prompt, sampling, deadline_s=deadline_s,
            speculation=speculation, transport=transport, priority=priority,
            journey=journey, response_format=response_format,
        )
        handle.trace.event("route", replica=replica.id, reason=reason)
        self.fleet_flight.record_event(
            "route", replica=replica.id, reason=reason,
            request_id=handle._request.id,
        )
        return handle

    def generate(
        self,
        prompt: Sequence[int],
        sampling: Optional[SamplingParams] = None,
        timeout: Optional[float] = None,
        speculation=None,
    ) -> List[int]:
        """Blocking single-request generation (deadline = timeout)."""
        handle = self.submit(
            prompt, sampling, deadline_s=timeout, speculation=speculation
        )
        return handle.result(timeout=timeout)

    # ----------------------------------------------------------- failover
    def _on_replica_failed(
        self, replica: Replica, requests: List[Request], cause: BaseException
    ) -> None:
        """failover_sink for one replica (runs on ITS loop thread inside
        the supervisor's give-up, after the requests fully left the dead
        scheduler): mark the replica DEAD and journal-replay every live
        stream onto survivors. Never raises — an unplaceable request
        waits in the fleet pending queue for the replacement replica."""
        with self._lock:
            replica.state = ReplicaState.DEAD
            replica.since = self.clock()
        self.fleet_stats.incr("failovers")
        self.fleet_flight.record_event(
            "failover", replica=replica.id, streams=len(requests),
            error=repr(cause)[:200],
        )
        # retire the moved streams from the dead replica's WAL first:
        # their live state travels with the Request objects, and an
        # END("migrated") keeps a later warm restart over this slot
        # from replaying streams that finished elsewhere
        self._durable_migrate(replica, requests)
        self._place(requests)

    def _durable_migrate(self, replica: Replica, requests: List[Request]) -> None:
        """Journal END("migrated") for streams leaving ``replica`` for
        another owner, and commit. Best-effort: durability must never
        make a failover worse."""
        dur = getattr(replica.model, "durable", None)
        if dur is None or not requests:
            return
        try:
            for req in requests:
                dur.journal.end_stream(req, "migrated")
            dur.sync()
        except Exception:
            pass

    def _place(self, requests: List[Request]) -> None:
        """Admit journal-replayed requests onto eligible replicas.
        Mid-stream requests (clients already hold tokens) go to the
        FRONT of their survivor's queue in original order; fresh ones
        to the back. Unplaceable requests wait in the fleet pending
        queue (drained onto the next replica to come up). Never raises,
        and guards PER REQUEST: a failure placing one request pends
        that request alone — an already-adopted stream must never be
        re-pended, or two schedulers would own (and emit into) it."""
        mid = [r for r in requests if r.n_generated > 0]
        fresh = [r for r in requests if r.n_generated == 0]
        unplaced: List[Request] = []
        for req in list(reversed(mid)) + fresh:
            if req.handle.done():
                continue
            try:
                survivor = self.router.place_failover(self._replicas_snapshot())
                if survivor is None:
                    unplaced.append(req)
                    continue
                survivor.scheduler.adopt(req, front=(req.n_generated > 0))
            except Exception:
                # adopt's enqueue is its final mutation, so a raise
                # means the request did NOT land on the survivor
                unplaced.append(req)
                continue
            self.fleet_stats.incr("migrated_streams")
            try:
                req.journey.hop(
                    "failover", to_replica=survivor.id,
                    mid_stream=req.n_generated > 0,
                )
                req.trace.event("failover", to_replica=survivor.id)
                self.fleet_flight.record_event(
                    "migrate", request_id=req.id, to_replica=survivor.id,
                    mid_stream=req.n_generated > 0,
                )
            except Exception:
                pass  # telemetry must not disturb an adopted stream
        if unplaced:
            with self._lock:
                # preserve original relative order in pending
                for req in requests:
                    if req in unplaced:
                        self._pending.append(req)

    # --------------------------------------------------------- supervisor
    def drain(self, replica: Replica, reason: str = "manual") -> None:
        """Stop admitting to ``replica``; residents finish on it (the
        scheduler keeps stepping). The supervisor replaces it once idle
        or after ``drain_timeout_s``."""
        with self._lock:
            if replica.state != ReplicaState.ACTIVE:
                return
            replica.state = ReplicaState.DRAINING
            replica.since = self.clock()
            replica.drain_started = self.clock()
        self.fleet_stats.incr("drains")
        self.fleet_flight.record_event("drain", replica=replica.id, reason=reason)

    def rolling_restart(
        self,
        *,
        drain_wait_s: Optional[float] = None,
        pump: Optional[Callable[[], None]] = None,
    ) -> Dict:
        """Zero-downtime rolling restart (durable serving):
        one replica at a time, drain -> checkpoint the WAL watermark ->
        respawn on the same slot -> warm-restart the slot journal ->
        warm gate -> swap. The router never sees a gap: every other
        replica stays ACTIVE throughout, the victim only leaves the
        routing set after its successor passed the gate, and no stream
        is ever aborted — drained streams finish in the wait window,
        queued leftovers re-place onto peers (END("migrated")
        journaled), and rare still-resident streams keep finishing on
        the RETIRING old engine.

        ``pump`` drives progress on virtual-clock fleets (called in
        place of sleeping — typically ``fleet.step`` plus a clock
        advance); live fleets poll at ``poll_s``. The warm gate
        re-runs the warmup probe on the successor and requires ZERO new
        step signatures (skipped when the fleet itself runs ``warmup=False``);
        a gate or spawn failure restores the old replica to ACTIVE and
        aborts the remaining rotation — never a capacity dip."""
        budget = self.drain_timeout_s if drain_wait_s is None else drain_wait_s
        report: Dict = {"ok": True, "replicas": []}
        for rep in self._replicas_snapshot():
            if rep.state == ReplicaState.DEAD:
                continue  # the auto-replace path owns dead replicas
            entry: Dict = {"replica": rep.id, "slot": rep.slot}
            rep.restarting = True
            try:
                self.drain(rep, reason="rolling_restart")
                waited = 0.0
                while rep.scheduler.has_work() and waited < budget:
                    if pump is not None:
                        pump()
                    else:
                        time.sleep(self.poll_s)
                    waited += self.poll_s
                stolen = rep.scheduler.steal_queue()
                if stolen:
                    self._durable_migrate(rep, stolen)
                    self._place(stolen)
                residents = rep.scheduler.has_work()
                dur = getattr(rep.model, "durable", None)
                if dur is not None:
                    # commit every END before the successor scans the
                    # slot journal, and checkpoint the commit frontier
                    dur.sync()
                    self.fleet_flight.record_event(
                        "wal_watermark", replica=rep.id,
                        **dur.wal.watermark(),
                    )
                entry["drained"] = not residents
                entry["migrated"] = len(stolen)
                try:
                    # replay the slot journal only when the old replica
                    # is fully idle — a retiring replica still OWNS its
                    # residents, and two schedulers must never emit
                    # into one stream
                    new = self._spawn(slot=rep.slot,
                                      warm_restart=not residents)
                except Exception as e:
                    self.fleet_stats.incr("spawn_failures")
                    self.fleet_flight.record_event(
                        "rolling_restart_abort", replica=rep.id,
                        error=repr(e)[:200],
                    )
                    entry["error"] = f"spawn failed: {e!r}"[:200]
                    self._restore_active(rep)
                    report["ok"] = False
                    report["replicas"].append(entry)
                    break
                if self.warmup and not self._warm_gate(new, entry):
                    self._teardown(new)
                    self._restore_active(rep)
                    self.fleet_flight.record_event(
                        "rolling_restart_abort", replica=rep.id,
                        new=new.id, reason="warm_gate",
                    )
                    report["ok"] = False
                    report["replicas"].append(entry)
                    break
                ndur = getattr(new.model, "durable", None)
                if ndur is not None:
                    ndur.stats.incr("rolling_restarts")
                    entry["replayed_streams"] = (
                        ndur.stats.counts()["replayed_streams"]
                    )
                with self._lock:
                    try:
                        idx = self.replicas.index(rep)
                    except ValueError:
                        idx = None
                    if idx is None:
                        self.replicas.append(new)
                    else:
                        self.replicas[idx] = new
                self.fleet_stats.incr("replaced")
                self.fleet_flight.record_event(
                    "rolling_restart", old=rep.id, new=new.id,
                    slot=rep.slot, drained=not residents,
                )
                if residents:
                    rep.state = ReplicaState.RETIRING
                    rep.since = self.clock()
                    with self._lock:
                        self._retiring.append(rep)
                else:
                    self._teardown(rep)
                self._drain_pending()
            finally:
                rep.restarting = False
            report["replicas"].append(entry)
        return report

    def _restore_active(self, rep: Replica) -> None:
        """Rolling-restart abort: put the drained victim back into the
        routing set — a failed rotation must degrade to the status quo,
        never to lost capacity."""
        with self._lock:
            if rep.state == ReplicaState.DRAINING:
                rep.state = ReplicaState.ACTIVE
                rep.since = self.clock()
                rep.drain_started = None

    def _warm_gate(self, rep: Replica, entry: Dict) -> bool:
        """The respawned replica must hold the zero-steady-state-
        capture invariant: re-run the warmup probe and require zero new
        step signatures (``trace_counts``; on a GPU, graph captures)
        before the router may see it."""
        base = sum(rep.engine.trace_counts.values())
        try:
            rep.engine.generate(
                [list(self.warm_prompt)],
                SamplingParams(max_new_tokens=self.warm_tokens),
                speculation=self._scheduler_kwargs.get("speculation"),
                draft_params=self._scheduler_kwargs.get("draft_params"),
            )
        except Exception as e:
            entry["gate"] = f"probe failed: {e!r}"[:200]
            return False
        retraces = sum(rep.engine.trace_counts.values()) - base
        entry["gate"] = "passed" if retraces == 0 else f"{retraces} retraces"
        return retraces == 0

    # ----------------------------------------------------------- durable
    def durable_report(self) -> Optional[Dict]:
        """Per-replica durable state for GET /v2/durable (None when the
        fleet has no durability_root)."""
        if self.durability_root is None:
            return None
        with self._lock:
            members = list(self.replicas) + list(self._retiring)
        out: Dict = {"root": self.durability_root, "replicas": {}}
        for rep in members:
            dur = getattr(rep.model, "durable", None)
            if dur is not None:
                out["replicas"][rep.id] = dict(
                    dur.report(), slot=rep.slot, state=rep.state
                )
        return out

    def durable_lookup(self, durable_id: str):
        """Resume-endpoint lookup across every replica (retiring ones
        included). A live hit wins over any terminal record, and a real
        terminal outcome wins over "migrated" — the stream's truth
        lives wherever it actually ran last."""
        best = None
        with self._lock:
            members = list(self.replicas) + list(self._retiring)
        for rep in members:
            dur = getattr(rep.model, "durable", None)
            if dur is None:
                continue
            hit = dur.lookup(durable_id)
            if hit is None:
                continue
            if hit[0] == "live":
                return hit
            if best is None or best[1].get("outcome") == "migrated":
                best = hit
        return best

    def check(self) -> None:
        """One fleet-supervisor inspection (manual on virtual clocks in
        tests; polled by the monitor thread under start()): edge-detect
        health signals into drains, complete drains into replacements,
        replace dead replicas, re-admit pending requests, and expire
        pending deadlines."""
        now = self.clock()
        self._sweep_retiring()
        for rep in self._replicas_snapshot():
            sched = rep.scheduler
            if rep.state == ReplicaState.ACTIVE:
                trips = sched.recovery_stats.watchdog_trips
                if trips > rep.seen_watchdog_trips:
                    rep.seen_watchdog_trips = trips
                    self.drain(rep, reason="watchdog_trip")
                elif rep.model.breaker.state == "open":
                    # the third health signal: a breaker held OPEN
                    # (step-failure storm or a trip that never
                    # recovered) drains the replica — two consecutive
                    # observations, so a transient open that the
                    # recovery path closes immediately doesn't thrash
                    # replacements
                    rep.breaker_open_checks += 1
                    if rep.breaker_open_checks >= 2:
                        self.drain(rep, reason="breaker_open")
                else:
                    rep.breaker_open_checks = 0
                if rep.state == ReplicaState.ACTIVE:
                    # quarantine storms slip past the consecutive-
                    # failure breaker (each successful prefill resets
                    # its count), so a replica quarantining every
                    # stream looks healthy to it: N quarantines with no
                    # completed request in between is a replica-health
                    # signal, not N coincidentally poisoned clients
                    completed = sched.stats.get("completed")
                    quarantined = sched.recovery_stats.quarantined
                    if completed > rep.seen_completed:
                        rep.quarantine_streak = 0
                    rep.quarantine_streak += quarantined - rep.seen_quarantined
                    rep.seen_completed = completed
                    rep.seen_quarantined = quarantined
                    if rep.quarantine_streak >= self.quarantine_streak_limit:
                        self.drain(rep, reason="quarantine_storm")
            if rep.state == ReplicaState.DRAINING and not rep.restarting:
                if not sched.has_work():
                    self._replace(rep, reason="drained")
                elif (
                    rep.drain_started is not None
                    and now - rep.drain_started >= self.drain_timeout_s
                ):
                    # rescue the never-admitted (and breaker-held)
                    # queue onto healthy replicas, then RETIRE rather
                    # than tear down: slot-resident streams keep
                    # finishing on their (possibly wedged) engine —
                    # completed normally or deadline-reaped by its
                    # watchdog, never aborted by the replacement
                    stolen = sched.steal_queue()
                    if stolen:
                        self._durable_migrate(rep, stolen)
                        self._place(stolen)
                    self._replace(rep, reason="drain_timeout", retire=True)
            elif rep.state == ReplicaState.DEAD and self.auto_replace:
                self._replace(rep, reason="failover")
        self._observe_autoscale()
        self._expire_pending(now)
        self._drain_pending()

    def _observe_autoscale(self) -> None:
        """Feed the autoscale advisor one fleet-wide observation: the
        fraction of eligible replicas that are saturated (their
        overload controller would refuse standard-priority work, or
        their ladder is degraded) and the mean limiter utilization. No
        eligible replicas at all counts as full saturation — a brownout
        is the strongest possible want-more signal."""
        eligible = [r for r in self._replicas_snapshot() if r.eligible()]
        if not eligible:
            self.autoscale.observe(1.0, 1.0)
            return
        saturated = 0
        util = 0.0
        for r in eligible:
            try:
                ctl = r.scheduler.overload
                util += ctl.limiter.utilization()
                if not ctl.would_admit(Priority.STANDARD) or ctl.ladder.level >= 1:
                    saturated += 1
            except Exception:
                pass  # a dying replica's telemetry must not kill check()
        self.autoscale.observe(saturated / len(eligible), util / len(eligible))

    def _sweep_retiring(self) -> None:
        """Tear down retired replicas once their residents are gone
        (finished, failed over, or deadline-reaped). The teardown then
        joins an idle loop thread — it can no longer abort live work
        or block the monitor on a wedged device call."""
        with self._lock:
            retiring = list(self._retiring)
        for rep in retiring:
            if rep.scheduler.has_work():
                continue
            self._teardown(rep)
            with self._lock:
                if rep in self._retiring:
                    self._retiring.remove(rep)

    def _replace(self, old: Replica, reason: str, retire: bool = False) -> None:
        """Swap ``old`` for a fresh warmed replica. A failed spawn
        (fleet.replica_spawn chaos, or a real factory error) is counted
        and retried on the next check; ``max_spawn_retries`` consecutive
        failures declare the fleet unable to replace — pending streams
        fail typed instead of hanging forever. ``retire=True`` keeps the
        old replica alive (out of the routing set) until its residents
        finish — used by the drain timeout, where teardown would abort
        live streams."""
        try:
            new = self._spawn(slot=old.slot)
        except Exception as e:
            self.fleet_stats.incr("spawn_failures")
            self._spawn_fail_streak += 1
            self.fleet_flight.record_event(
                "spawn_failed", replacing=old.id, error=repr(e)[:200],
                streak=self._spawn_fail_streak,
            )
            if self._spawn_fail_streak > self.max_spawn_retries:
                self._fail_pending(EngineFailedError(
                    f"fleet cannot spawn a replacement replica "
                    f"({self._spawn_fail_streak} consecutive failures; "
                    f"last: {e!r})"
                ))
            return
        self._spawn_fail_streak = 0
        with self._lock:
            try:
                idx = self.replicas.index(old)
            except ValueError:
                idx = None
            if idx is None:
                self.replicas.append(new)
            else:
                self.replicas[idx] = new
        self.fleet_stats.incr("replaced")
        self.fleet_flight.record_event(
            "replace", old=old.id, new=new.id, reason=reason
        )
        if retire and old.scheduler.has_work():
            old.state = ReplicaState.RETIRING
            old.since = self.clock()
            with self._lock:
                self._retiring.append(old)
        else:
            self._teardown(old)
        self._drain_pending()

    def _fold_counters(self, counts: Dict[str, int]) -> None:
        with self._lock:
            for k, v in counts.items():
                self._folded_counters[k] = self._folded_counters.get(k, 0) + v

    def _folded_snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._folded_counters)

    def _teardown(self, replica: Replica) -> None:
        replica.state = ReplicaState.DEAD
        try:
            self._fold_counters(replica.model.stats.counters())
        except Exception:
            pass
        # keep the dead lane's span ring (and spool) stitchable: its
        # spans are the only copy of hops on streams that failed over
        rec = getattr(replica.model, "journeys", None)
        spool = getattr(replica.model, "journey_spool", None)
        with self._lock:
            if rec is not None:
                self._dead_journeys.append(rec)
            if spool is not None:
                self._dead_spools.append(spool)
        try:
            # bounded join: teardown runs on the monitor thread, and a
            # replica that somehow still wedges must not stall the
            # whole fleet supervisor for scheduler.stop's default 30s
            replica.model.scheduler.stop(drain=False, timeout=5.0)
        except Exception:
            pass  # a wedged replica's teardown must not take the fleet down
        dur = getattr(replica.model, "durable", None)
        if dur is not None:
            try:
                dur.close()  # final flush; successor segments unaffected
            except Exception:
                pass

    def _drain_pending(self) -> None:
        with self._lock:
            if not self._pending:
                return
            if not any(r.eligible() for r in self.replicas):
                return
            pending, self._pending = list(self._pending), deque()
        self._place(pending)

    def _expire_pending(self, now: float) -> None:
        with self._lock:
            keep: deque = deque()
            expired: List[Request] = []
            for req in self._pending:
                if req.handle.done():
                    continue
                if req.cancelled or (
                    req.deadline is not None and now >= req.deadline
                ):
                    expired.append(req)
                else:
                    keep.append(req)
            self._pending = keep
        for req in expired:
            if req.cancelled:
                err, outcome = ShuttingDownError("request cancelled"), "cancelled"
            else:
                err = DeadlineExceededError(
                    "deadline expired while awaiting a replica"
                )
                outcome = "expired"
            if req.handle._fail(err):
                self._fold_counters({outcome: 1})

    def _fail_pending(self, err: BaseException) -> None:
        with self._lock:
            pending, self._pending = list(self._pending), deque()
        for req in pending:
            if req.handle._fail(err):
                self._fold_counters({"failed": 1})

    # ---------------------------------------------------------- lifecycle
    def start(self) -> None:
        with self._lock:
            if self._started:
                return
            self._started = True
            self._draining = False
            self._stopped = False
            reps = list(self.replicas)
        for rep in reps:
            rep.model.start()
        self._monitor_stop.clear()
        self._monitor = threading.Thread(target=self._monitor_loop, daemon=True)
        self._monitor.start()

    def _monitor_loop(self) -> None:
        while not self._monitor_stop.wait(timeout=self.poll_s):
            try:
                self.check()
            except Exception:
                # the fleet supervisor must never die of a transient
                # inspection race; missing one poll beats losing the
                # drain/replace lifecycle for the process lifetime
                pass

    def stop(self, drain: bool = True) -> None:
        """Graceful by default: every replica drains (finishes queued +
        running work), then the monitor exits; pending fleet-level
        requests fail typed."""
        self._draining = True
        try:
            self._monitor_stop.set()
            if self._monitor is not None:
                self._monitor.join(timeout=5.0)
                self._monitor = None
            with self._lock:
                members = list(self.replicas) + list(self._retiring)
                self._retiring = []
            for rep in members:
                try:
                    rep.model.stop(drain=drain)
                except Exception:
                    pass
            self._fail_pending(ShuttingDownError("fleet stopped"))
        finally:
            self._draining = False
            self._started = False
            self._stopped = True

    def _pending_count(self) -> int:
        """Locked fleet-pending depth — the read path for step/has_work
        and the scrape-facing reports (writers swap the deque wholesale
        under the lock)."""
        with self._lock:
            return len(self._pending)

    def step(self) -> bool:
        """One synchronous fleet iteration (virtual-clock tests): step
        every live replica's scheduler once, then run the supervisor's
        check(). Returns True while any work remains in flight."""
        did = False
        with self._lock:
            members = list(self.replicas) + list(self._retiring)
        for rep in members:
            if rep.state != ReplicaState.DEAD:
                did = rep.scheduler.step() or did
        self.check()
        return did or self._pending_count() > 0

    def ready(self) -> bool:
        return (
            not self._draining
            and not self._stopped
            and any(r.eligible() for r in self._replicas_snapshot())
        )

    def has_work(self) -> bool:
        with self._lock:
            members = list(self.replicas) + list(self._retiring)
        return self._pending_count() > 0 or any(
            r.scheduler.has_work() for r in members
        )

    # ------------------------------------------- GenerationModel surface
    def _solo(self) -> Optional[GenerationModel]:
        reps = self._replicas_snapshot()
        return reps[0].model if len(reps) == 1 else None

    @property
    def breaker(self):
        solo = self._solo()
        return solo.breaker if solo is not None else _FleetBreakerView(self)

    @property
    def stats(self):
        """n=1 parity: a never-failed-over single replica exposes its
        own ServingStats (bit-identical surface to the bare
        GenerationModel). Once ANY fleet lifecycle event happened —
        failover, replacement — the per-replica counters no longer tell
        the cumulative story, so even n=1 switches to the aggregate
        view (replica counters + folded retired/pending counters)."""
        solo = self._solo()
        if solo is not None:
            fs = self.fleet_stats
            if fs.failovers == 0 and fs.replaced == 0 and not self._folded_snapshot():
                return solo.stats
        return _FleetAggregateStats(self)

    @property
    def trace_ring(self):
        solo = self._solo()
        return solo.trace_ring if solo is not None else _MergedTraceRing(self)

    @property
    def scheduler(self):
        """The single replica's scheduler (n=1 parity); multi-replica
        fleets have one scheduler PER replica — use ``replicas``."""
        solo = self._solo()
        if solo is None:
            raise AttributeError(
                "a multi-replica fleet has one scheduler per replica; "
                "iterate fleet.replicas"
            )
        return solo.scheduler

    @property
    def engine(self):
        solo = self._solo()
        if solo is None:
            raise AttributeError(
                "a multi-replica fleet has one engine per replica; "
                "iterate fleet.replicas"
            )
        return solo.engine

    @property
    def flight(self):
        solo = self._solo()
        return solo.flight if solo is not None else self.fleet_flight

    @property
    def capacity(self):
        solo = self._solo()
        return solo.capacity if solo is not None else None

    @property
    def slo(self):
        solo = self._solo()
        return solo.slo if solo is not None else None

    def cache_report(self) -> Dict:
        solo = self._solo()
        if solo is not None:
            return solo.cache_report()
        return {r.id: r.model.cache_report() for r in self._replicas_snapshot()}

    def readiness_rationale(self) -> Dict:
        return {
            "ready": self.ready(),
            "fleet": True,
            "replicas": {
                r.id: {"state": r.state, **r.model.readiness_rationale()}
                for r in self._replicas_snapshot()
            },
            "pending": self._pending_count(),
        }

    sampling_from = staticmethod(GenerationModel.sampling_from)
    speculation_from = staticmethod(GenerationModel.speculation_from)
    response_format_from = staticmethod(GenerationModel.response_format_from)

    def metadata(self) -> Dict:
        reps = self._replicas_snapshot()
        md = reps[0].model.metadata()
        md["fleet"] = {
            "replicas": len(reps),
            "states": self.states(),
            "auto_replace": self.auto_replace,
            "drain_timeout_s": self.drain_timeout_s,
        }
        return md

    # ----------------------------------------------------------- reports
    def report(self) -> Dict:
        """The ``GET /v2/fleet`` payload: per-replica state + router
        score inputs + residency, fleet counters, router decisions, and
        the recent lifecycle events (failovers, drains, replacements,
        migrations)."""
        reps = []
        with self._lock:
            members = list(self.replicas) + list(self._retiring)
        for r in members:
            s = r.scheduler
            alloc = s.engine.allocator
            rs = s.recovery_stats
            reps.append({
                "id": r.id,
                "state": r.state,
                "since": r.since,
                "breaker": r.model.breaker.state,
                "queue_depth": len(s._queue),
                "running": len(s._running),
                "blocks_free": alloc.num_free,
                "blocks_total": alloc.num_total,
                "watchdog_trips": rs.watchdog_trips,
                "engine_failures": rs.engine_failures,
                "recoveries": rs.recoveries,
                "load_score": self.router.load_score(r),
                "residency": [
                    {
                        "request_id": st.req.id,
                        "generated": st.req.n_generated,
                        "blocks": len(st.blocks),
                    }
                    for st in sorted(
                        s._running.values(), key=lambda st: st.admitted_seq
                    )
                ],
            })
        out = {"name": self.name, "replicas": reps, "pending": self._pending_count()}
        out.update(self.fleet_stats.snapshot())
        out["recent_events"] = self.fleet_flight.snapshot(32)
        return out

    def autoscale_report(self) -> Dict:
        """The ``GET /v2/fleet/autoscale`` payload: the want-more /
        want-fewer signal from sustained limiter state, with the
        per-replica overload evidence behind it."""
        reps = self._replicas_snapshot()
        out = self.autoscale.report(len(reps))
        replicas = {}
        for r in reps:
            try:
                ctl = r.scheduler.overload
                replicas[r.id] = {
                    "state": r.state,
                    "eligible": r.eligible(),
                    "limiter": ctl.limiter.snapshot(),
                    "degrade_level": ctl.ladder.level,
                }
            except Exception:
                replicas[r.id] = {"state": r.state, "eligible": False}
        out["replicas"] = replicas
        out["fleet_sheds"] = self.fleet_stats.snapshot()["sheds"]
        return out

    def prom_fleet(self) -> Dict:
        """The ``fleets=`` input to obs.prom.render_prometheus: replica
        states, lifecycle counters, router decisions, and the
        autoscale signal."""
        fs = self.fleet_stats.snapshot()
        with self._lock:
            n = len(self.replicas)
        return {
            "states": self.states(),
            "failovers_total": fs["failovers"],
            "migrated_streams_total": fs["migrated_streams"],
            "replaced_total": fs["replaced"],
            "router_decisions": fs["router_decisions"],
            "autoscale": {
                "signal": self.autoscale.signal,
                "want_replicas": self.autoscale.want_replicas(n),
            },
        }


class KVHandoff:
    """One supervised prefill->decode KV transfer. State machine:

        pending ──transfer ok──────────────> delivered
           │  └──error (bounded retry, backoff)──┐
           │──CRC mismatch on arrival────────────┤
           │──deadline expiry (stall/wedge)──────┤
           └──decode replica died at adopt───────┴─> replayed

    ``replayed`` is the terminal fallback: the stream journal-replays
    (recompute-prefill) on the decode pool from the request object —
    degraded, never corrupted or lost."""

    PENDING = "pending"
    DELIVERED = "delivered"
    REPLAYED = "replayed"

    __slots__ = (
        "id", "req", "payload", "source", "state", "created", "deadline",
        "attempts", "next_attempt_at", "claimed",
    )

    def __init__(self, hid: int, req: Request, payload: KVHandoffPayload,
                 source: str, now: float, timeout_s: Optional[float]):
        self.id = hid
        self.req = req
        self.payload = payload
        self.source = source  # prefill replica id (telemetry)
        self.state = KVHandoff.PENDING
        self.created = now
        self.deadline = None if timeout_s is None else now + timeout_s
        self.attempts = 0
        self.next_attempt_at = now
        self.claimed = False  # a thread is mid-transfer; guarded-by: manager lock


class HandoffManager:
    """The supervised prefill->decode transfer protocol: CRC-verified
    per-block transfer onto the least-loaded eligible decode replica,
    bounded retry with exponential backoff, deadline expiry for stalled
    transfers, and decode-pool journal replay as the terminal fallback.

    Transfers run wherever ``pump()`` is called from — the dedicated
    handoff worker thread (when started; offers just notify it), the
    prefill scheduler's loop thread (inline at offer, when no worker
    is running), the disaggregated fleet's monitor thread, or a test
    stepping the fleet — with a claim
    flag so concurrent pumps never double-transfer one handoff, and a
    post-transfer state re-check so a transfer that un-wedges AFTER its
    deadline replayed the stream is discarded instead of adopting the
    stream twice. The ``fleet.kv_handoff`` fault site wraps each
    per-block wire copy: ``nan`` corrupts in flight (caught by CRC on
    arrival), ``error`` fails the attempt into retry, ``stall`` wedges
    the transfer until the deadline expires."""

    OUTCOMES = ("ok", "corrupt", "error", "stalled")

    def __init__(
        self,
        decode_fleet: "Fleet",
        *,
        clock: Callable[[], float] = time.monotonic,
        timeout_s: float = 30.0,
        max_attempts: int = 3,
        backoff_s: float = 0.05,
        flight: Optional[FlightRecorder] = None,
    ):
        self.decode_fleet = decode_fleet
        self.clock = clock
        self.timeout_s = timeout_s
        self.max_attempts = max(1, max_attempts)
        self.backoff_s = backoff_s
        self.flight = flight if flight is not None else FlightRecorder(
            capacity=64, enabled=False, sched_clock=clock
        )
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._worker: Optional[threading.Thread] = None
        self._worker_stop = threading.Event()
        self._hid = itertools.count()
        self._inflight: Dict[int, KVHandoff] = {}  # guarded-by: _lock
        # protocol counters (ints under the lock; prometheus families
        # flexflow_serving_handoff_* render from prom())
        self.transfers = {o: 0 for o in self.OUTCOMES}
        self.bytes_total = 0
        self.retries_total = 0
        self.replay_fallbacks = 0
        self.latency = Histogram()

    # ------------------------------------------------------------ protocol
    @property
    def in_flight(self) -> int:
        with self._lock:
            return len(self._inflight)

    def offer(self, req: Request, payload: KVHandoffPayload,
              source: str) -> KVHandoff:
        """Record one handoff (called from the prefill scheduler via its
        handoff_sink). With the worker running the transfer is handed
        to it — the prefill loop is back admitting the next prompt
        while the blocks are still on the wire; without it (synchronous
        callers, tests) the fast path delivers in this call."""
        now = self.clock()
        h = KVHandoff(next(self._hid), req, payload, source, now, self.timeout_s)
        with self._lock:
            self._inflight[h.id] = h
        self.flight.record_event(
            "handoff_start", handoff=h.id, request_id=req.id,
            source=source, n_blocks=len(payload.blocks),
            payload_bytes=payload.nbytes,
        )
        w = self._worker
        if w is not None and w.is_alive():
            with self._lock:
                self._cv.notify()
        else:
            self.pump()
        return h

    # ------------------------------------------------------------ worker
    def start_worker(self) -> None:
        """Run transfers on a dedicated thread instead of inline at
        offer(): the transfer (fault-site wire copy, CRC verify,
        decode-pool adopt) is serialized BEHIND prefill admissions when
        pumped inline, which shows up directly in TTFT tails."""
        if self._worker is not None and self._worker.is_alive():
            return
        self._worker_stop.clear()
        self._worker = threading.Thread(
            target=self._worker_loop, name="kv-handoff", daemon=True
        )
        self._worker.start()

    def stop_worker(self) -> None:
        self._worker_stop.set()
        with self._lock:
            self._cv.notify_all()
        w = self._worker
        if w is not None:
            w.join(timeout=5.0)
            self._worker = None

    def _worker_loop(self) -> None:
        while not self._worker_stop.is_set():
            try:
                self.pump()
            except Exception:
                pass  # the worker must outlive any one transfer
            with self._lock:
                if self._worker_stop.is_set():
                    return
                # sleep until the earliest retry backoff comes due (or
                # a fresh offer() notifies); cap the idle wait so a
                # clock-skewed backoff can't wedge the thread
                now = self.clock()
                delay = 0.25
                for h in self._inflight.values():
                    if h.state == KVHandoff.PENDING and not h.claimed:
                        delay = min(delay, max(0.001, h.next_attempt_at - now))
                self._cv.wait(timeout=delay)

    def pump(self) -> None:
        """Run every due pending transfer (offer fast path, retry
        backoffs that came due, handoffs that waited out a decode
        brownout)."""
        now = self.clock()
        with self._lock:
            due = [
                h for h in list(self._inflight.values())
                if h.state == KVHandoff.PENDING and not h.claimed
                and now >= h.next_attempt_at
            ]
            for h in due:
                h.claimed = True
        for h in due:
            try:
                self._attempt(h)
            finally:
                with self._lock:
                    h.claimed = False

    def check(self, now: Optional[float] = None) -> None:
        """Supervisor sweep: expire pending handoffs past their
        deadline (a stalled/wedged transfer) into replay fallback, then
        pump whatever is due."""
        now = self.clock() if now is None else now
        with self._lock:
            expired = [
                h for h in list(self._inflight.values())
                if h.state == KVHandoff.PENDING and h.deadline is not None
                and now >= h.deadline
            ]
            for h in expired:
                h.state = KVHandoff.REPLAYED
                self._inflight.pop(h.id, None)
        for h in expired:
            self._replay(h, "stalled")
        self.pump()

    # ------------------------------------------------------------ internals
    def _attempt(self, h: KVHandoff) -> None:
        req, payload = h.req, h.payload
        if req.handle.done():  # cancelled/expired while in flight
            with self._lock:
                self._inflight.pop(h.id, None)
            self.flight.record_event(
                "handoff_dropped", handoff=h.id, request_id=req.id
            )
            return
        target = self.decode_fleet.router.place_failover(
            self.decode_fleet._replicas_snapshot()
        )
        if target is None:
            # decode brownout: stay pending — a replacement replica or
            # the deadline (-> replay into the decode fleet's pending
            # queue) resolves it
            return
        try:
            wire: List[PackedBlock] = []
            for pb in payload.blocks:
                hk, hv = faults.inject(
                    faults.FLEET_KV_HANDOFF, (pb.host_k, pb.host_v)
                )
                wire.append(
                    PackedBlock(np.asarray(hk), np.asarray(hv), crc=pb.crc)
                )
        except Exception as e:
            with self._lock:
                if h.state != KVHandoff.PENDING:
                    return
                h.attempts += 1
                exhausted = h.attempts >= self.max_attempts
                if exhausted:
                    h.state = KVHandoff.REPLAYED
                    self._inflight.pop(h.id, None)
                else:
                    self.retries_total += 1
                    h.next_attempt_at = (
                        self.clock()
                        + self.backoff_s * (2 ** (h.attempts - 1))
                    )
            if exhausted:
                self._replay(h, "error", cause=e)
            else:
                self.flight.record_event(
                    "handoff_retry", handoff=h.id, request_id=req.id,
                    attempt=h.attempts, error=repr(e)[:200],
                )
            return
        arrived = KVHandoffPayload(
            payload.n_positions, payload.block_size, wire
        )
        intact = arrived.verify()
        outcome = None
        with self._lock:
            if h.state != KVHandoff.PENDING:
                return  # expired and replayed while this transfer was wedged
            if not intact:
                outcome = "corrupt"
            elif h.deadline is not None and self.clock() >= h.deadline:
                # a stall-mode wedge that finally un-blocked, too late:
                # the deadline owns this handoff even if check() has not
                # swept it yet
                outcome = "stalled"
            if outcome is not None:
                h.state = KVHandoff.REPLAYED
                self._inflight.pop(h.id, None)
            else:
                h.state = KVHandoff.DELIVERED
                self._inflight.pop(h.id, None)
        if outcome is not None:
            self._replay(h, outcome)
            return
        try:
            target.scheduler.adopt(req, front=True, imported=arrived)
        except Exception as e:
            # the chosen decode replica died between pick and adopt;
            # fall back to recompute placement (which pends if the
            # whole pool browned out)
            self._replay(h, "error", cause=e)
            return
        with self._lock:
            self.transfers["ok"] += 1
            self.bytes_total += arrived.nbytes
        self.latency.observe(max(0.0, self.clock() - h.created))
        self.flight.record_event(
            "handoff_delivered", handoff=h.id, request_id=req.id,
            source=h.source, target=target.id, attempts=h.attempts + 1,
        )
        try:
            req.journey.hop(
                "kv_handoff", source=h.source, target=target.id,
                n_blocks=len(wire), attempts=h.attempts + 1,
                payload_bytes=arrived.nbytes,
            )
            req.trace.event(
                "kv_handoff", source=h.source, target=target.id,
                n_blocks=len(wire),
            )
        except Exception:
            pass  # telemetry must not disturb an adopted stream

    def _replay(self, h: KVHandoff, outcome: str,
                cause: Optional[BaseException] = None) -> None:
        """Terminal fallback: journal-replay the stream on the decode
        pool (recompute-prefill from the request object — byte-exact).
        ``_place`` pends the request if the pool has no eligible
        replica, so even a brownout degrades to waiting, not loss."""
        with self._lock:
            self.transfers[outcome] = self.transfers.get(outcome, 0) + 1
            self.replay_fallbacks += 1
        self.flight.record_event(
            "handoff_replay", handoff=h.id, request_id=h.req.id,
            outcome=outcome,
            **({"error": repr(cause)[:200]} if cause is not None else {}),
        )
        try:
            h.req.journey.hop(
                "kv_handoff_replay", outcome=outcome, source=h.source,
            )
            h.req.trace.event("kv_handoff_replay", outcome=outcome)
        except Exception:
            pass
        self.decode_fleet._place([h.req])

    # ------------------------------------------------------------- reports
    def report(self) -> Dict:
        now = self.clock()
        with self._lock:
            in_flight = [
                {
                    "id": h.id,
                    "request_id": h.req.id,
                    "source": h.source,
                    "attempts": h.attempts,
                    "age_s": max(0.0, now - h.created),
                    "deadline_in_s": (
                        None if h.deadline is None else h.deadline - now
                    ),
                    "bytes": h.payload.nbytes,
                }
                for h in self._inflight.values()
            ]
            transfers = dict(self.transfers)
        return {
            "in_flight": in_flight,
            "transfers": transfers,
            "bytes_total": self.bytes_total,
            "retries_total": self.retries_total,
            "replay_fallbacks_total": self.replay_fallbacks,
            "latency": self.latency.snapshot(),
        }

    def prom(self) -> Dict:
        """The ``handoff`` block of a disaggregated fleet's prom_fleet()
        payload (obs/prom.py renders the flexflow_serving_handoff_*
        families from it)."""
        with self._lock:
            transfers = dict(self.transfers)
        return {
            "transfers": transfers,
            "bytes_total": self.bytes_total,
            "replay_fallbacks_total": self.replay_fallbacks,
            "latency": self.latency.snapshot(),
        }


class DisaggregatedFleet:
    """Disaggregated serving: a prefill pool and a decode pool joined by
    the supervised KV handoff (DistServe OSDI'24 / Splitwise ISCA'24:
    prefill's compute-bound bursts and decode's latency-bound steady
    state stop interfering when they stop sharing replicas).

    Requests admit on the prefill pool (full router treatment: typed
    overload/priority rejections, prefix affinity, least-loaded). The
    prefill replica emits the FIRST token — TTFT comes from a pool
    that never competes with decode steps — then packs the prompt's KV
    into the CRC-stamped wire format and hands the stream to the
    :class:`HandoffManager`, which delivers it onto the least-loaded
    decode replica via ``adopt(imported=...)``. Decode replicas never
    prefill in steady state, so TPOT stops paying prefill bursts.

    Each pool is a full :class:`Fleet`: drain/replace/failover,
    overload control, and autoscale signals all work per pool, and a
    prefill replica that dies AFTER its payload packed is harmless (the
    wire format is host-resident and engine-agnostic). Both pools run
    one GPU each, without tensor parallelism (the wire carries full-head
    blocks). Duck-types :class:`GenerationModel` / :class:`Fleet` so the
    server and existing tooling work unchanged.
    """

    def __init__(
        self,
        prefill_factory: Callable[[], GenerationEngine],
        decode_factory: Optional[Callable[[], GenerationEngine]] = None,
        *,
        n_prefill: int = 1,
        n_decode: int = 1,
        name: str = "generator",
        clock: Callable[[], float] = time.monotonic,
        handoff_timeout_s: float = 30.0,
        handoff_max_attempts: int = 3,
        handoff_backoff_s: float = 0.05,
        warm_handoff: bool = True,
        poll_s: float = 0.25,
        **fleet_kwargs,
    ):
        self.name = name
        self.clock = clock
        self.poll_s = poll_s
        self._started = False
        self._stopped = False
        self._monitor: Optional[threading.Thread] = None
        self._monitor_stop = threading.Event()
        # handoff lifecycle events land on the disagg fleet's own ring
        # (GET /v2/fleet shows them alongside both pools' events)
        self.fleet_flight = FlightRecorder(
            capacity=256,
            enabled=bool(fleet_kwargs.get("observability", True)),
            sched_clock=clock,
        )
        # decode pool first: the handoff sink needs a live target pool
        # before the first prefill replica can take traffic
        self.decode = Fleet(
            decode_factory or prefill_factory, n_decode, name=name,
            clock=clock, rid_prefix="d", poll_s=poll_s, **fleet_kwargs,
        )
        self.handoff = HandoffManager(
            self.decode, clock=clock, timeout_s=handoff_timeout_s,
            max_attempts=handoff_max_attempts, backoff_s=handoff_backoff_s,
            flight=self.fleet_flight,
        )
        self.prefill = Fleet(
            prefill_factory, n_prefill, name=name, clock=clock,
            rid_prefix="p", poll_s=poll_s,
            handoff_sink=self._on_prefill_done, **fleet_kwargs,
        )
        if warm_handoff and fleet_kwargs.get("warmup", True):
            # one end-to-end request through the handoff path: the pack
            # and import paths (their index and staging allocations) run
            # here, NOT on the first real request, same contract as
            # Fleet warmup
            self._warm_handoff()

    # ------------------------------------------------------------- serving
    def _on_prefill_done(self, req: Request, payload: KVHandoffPayload,
                         replica: Replica) -> None:
        self.handoff.offer(req, payload, replica.id)

    def submit(
        self,
        prompt: Sequence[int],
        sampling: Optional[SamplingParams] = None,
        deadline_s: Optional[float] = None,
        speculation=None,
        transport: Optional[str] = None,
        priority: Optional[str] = None,
        journey=None,
        response_format: Optional[Dict] = None,
    ) -> GenerationHandle:
        """Admission is the prefill pool's: its router places the
        request (affinity/least-loaded/spill) and its overload
        machinery raises the typed rejections. The stream's decode
        residency arrives via the handoff."""
        if self._stopped:
            raise ShuttingDownError("fleet stopped")
        return self.prefill.submit(
            prompt, sampling, deadline_s=deadline_s, speculation=speculation,
            transport=transport, priority=priority, journey=journey,
            response_format=response_format,
        )

    def generate(
        self,
        prompt: Sequence[int],
        sampling: Optional[SamplingParams] = None,
        timeout: Optional[float] = None,
        speculation=None,
    ) -> List[int]:
        handle = self.submit(
            prompt, sampling, deadline_s=timeout, speculation=speculation
        )
        if not self._started:
            self._drive(handle)
        return handle.result(timeout=timeout)

    def _drive(self, handle: GenerationHandle, max_steps: int = 100000) -> None:
        """Synchronous drive for unstarted fleets (warmup, tests): step
        both pools + the handoff supervisor until the handle settles."""
        for _ in range(max_steps):
            if handle.done():
                return
            if not self.step() and handle.done():
                return

    def _warm_handoff(self) -> None:
        warm = list(self.prefill.warm_prompt)
        try:
            handle = self.submit(
                warm, SamplingParams(max_new_tokens=max(2, self.prefill.warm_tokens))
            )
            self._drive(handle, max_steps=10000)
            handle.result(timeout=60.0)
        except Exception:
            # warmup must never fail construction — the first real
            # handoff just pays the compile instead
            pass
        # the end-to-end request above ran the wire paths on ONE replica
        # per pool; warm the rest with a self-roundtrip (pack block 0,
        # import it back: bit-identical, so it is safe even if block 0
        # is live)
        for rep in (self.prefill._replicas_snapshot()
                    + self.decode._replicas_snapshot()):
            try:
                eng = rep.engine
                payload = eng.pack_kv_blocks([0], eng.cache_config.block_size)
                eng.import_kv_blocks([0], payload.blocks)
            except Exception:
                pass

    # ---------------------------------------------------------- supervisor
    def check(self) -> None:
        self.prefill.check()
        self.handoff.check()
        self.decode.check()

    def step(self) -> bool:
        """One synchronous iteration across both pools + the handoff
        supervisor (virtual-clock tests, warmup drive)."""
        did = self.prefill.step()
        self.handoff.check()
        did = self.decode.step() or did
        return did or self.handoff.in_flight > 0

    # ---------------------------------------------------------- lifecycle
    def start(self) -> None:
        self.prefill.start()
        self.decode.start()
        self.handoff.start_worker()
        self._started = True
        self._stopped = False
        self._monitor_stop.clear()
        self._monitor = threading.Thread(target=self._monitor_loop, daemon=True)
        self._monitor.start()

    def _monitor_loop(self) -> None:
        while not self._monitor_stop.wait(timeout=self.poll_s):
            try:
                self.handoff.check()
            except Exception:
                pass  # the handoff supervisor must outlive any one sweep

    def stop(self, drain: bool = True) -> None:
        """Prefill pool first (stops new admissions; queued work
        finishes and hands off), then the in-flight handoffs drain (or
        expire into replay), then the decode pool."""
        self._monitor_stop.set()
        if self._monitor is not None:
            self._monitor.join(timeout=5.0)
            self._monitor = None
        self.prefill.stop(drain=drain)
        # late handoffs from the draining prefills were still offered
        # to the worker; stop it only after the prefill pool is quiet
        # (offers after this pump inline — the sync path)
        self.handoff.stop_worker()
        if drain:
            # real wall clock on purpose: this bounds a shutdown wait
            # (self.clock may be virtual in tests, and a frozen clock
            # must not wedge stop() forever)
            deadline = time.monotonic() + 10.0
            while self.handoff.in_flight and time.monotonic() < deadline:
                self.handoff.check()
                time.sleep(0.01)
        self.decode.stop(drain=drain)
        self._started = False
        self._stopped = True

    def ready(self) -> bool:
        return self.prefill.ready() and self.decode.ready()

    def has_work(self) -> bool:
        return (
            self.prefill.has_work()
            or self.decode.has_work()
            or self.handoff.in_flight > 0
        )

    # ------------------------------------------- GenerationModel surface
    @property
    def replicas(self) -> List[Replica]:
        """Both pools' replicas (distinct id namespaces: p*/d*) — the
        server's per-replica debug endpoints and /v2/fleet inclusion
        key off this."""
        return (
            self.prefill._replicas_snapshot()
            + self.decode._replicas_snapshot()
        )

    def _replicas_snapshot(self) -> List[Replica]:
        return self.replicas

    @property
    def journeys(self):
        """Journeys-on gate for the ingress layer: requests enter via the
        prefill pool, so its router recorder answers for both pools."""
        return self.prefill.journeys

    def states(self) -> Dict[str, int]:
        out = self.prefill.states()
        for k, v in self.decode.states().items():
            out[k] = out.get(k, 0) + v
        return out

    @property
    def breaker(self):
        return _FleetBreakerView(self)

    @property
    def stats(self):
        return _DisaggAggregateStats(self)

    @property
    def trace_ring(self):
        return _MergedTraceRing(self)

    @property
    def flight(self):
        return self.fleet_flight

    @property
    def capacity(self):
        return None

    @property
    def slo(self):
        return None

    def cache_report(self) -> Dict:
        return {
            r.id: r.model.cache_report() for r in self.replicas
        }

    def readiness_rationale(self) -> Dict:
        return {
            "ready": self.ready(),
            "fleet": True,
            "disaggregated": True,
            "pools": {
                "prefill": self.prefill.readiness_rationale(),
                "decode": self.decode.readiness_rationale(),
            },
            "handoffs_in_flight": self.handoff.in_flight,
        }

    sampling_from = staticmethod(GenerationModel.sampling_from)
    speculation_from = staticmethod(GenerationModel.speculation_from)
    response_format_from = staticmethod(GenerationModel.response_format_from)

    def metadata(self) -> Dict:
        md = self.prefill._replicas_snapshot()[0].model.metadata()
        md["fleet"] = {
            "disaggregated": True,
            "pools": {
                "prefill": {
                    "replicas": len(self.prefill._replicas_snapshot()),
                    "states": self.prefill.states(),
                },
                "decode": {
                    "replicas": len(self.decode._replicas_snapshot()),
                    "states": self.decode.states(),
                },
            },
            "handoff_timeout_s": self.handoff.timeout_s,
        }
        return md

    # ---------------------------------------------------------- journeys
    def journey_recorders(self) -> List:
        """Both pools' span lanes (routers + every replica) — one
        stitched timeline covers prefill, handoff, and decode hops."""
        return (
            self.prefill.journey_recorders() + self.decode.journey_recorders()
        )

    def journey_spools(self) -> List:
        return self.prefill.journey_spools() + self.decode.journey_spools()

    # ----------------------------------------------------------- reports
    def report(self) -> Dict:
        """GET /v2/fleet payload: the pools block (each pool's full
        fleet report) + the handoffs block (in-flight transfers and
        protocol counters) + the disagg-level lifecycle events."""
        return {
            "name": self.name,
            "disaggregated": True,
            "pools": {
                "prefill": self.prefill.report(),
                "decode": self.decode.report(),
            },
            "handoffs": self.handoff.report(),
            "recent_events": self.fleet_flight.snapshot(32),
        }

    def autoscale_report(self) -> Dict:
        return {
            "disaggregated": True,
            "pools": {
                "prefill": self.prefill.autoscale_report(),
                "decode": self.decode.autoscale_report(),
            },
        }

    def prom_fleet(self) -> Dict:
        """Unified families render from the pool-merged view (states,
        lifecycle counters, router decisions); the pools/handoff keys
        add the flexflow_serving_fleet_pool_replicas and
        flexflow_serving_handoff_* families (key-gated in obs/prom.py,
        so plain fleets render unchanged)."""
        p = self.prefill.prom_fleet()
        d = self.decode.prom_fleet()
        decisions = dict(p["router_decisions"])
        for k, v in d["router_decisions"].items():
            decisions[k] = decisions.get(k, 0) + v
        return {
            "states": self.states(),
            "failovers_total": p["failovers_total"] + d["failovers_total"],
            "migrated_streams_total": (
                p["migrated_streams_total"] + d["migrated_streams_total"]
            ),
            "replaced_total": p["replaced_total"] + d["replaced_total"],
            "router_decisions": decisions,
            "autoscale": p["autoscale"],
            "pools": {
                "prefill": {"states": self.prefill.states()},
                "decode": {"states": self.decode.states()},
            },
            "handoff": self.handoff.prom(),
        }


class _DisaggAggregateStats:
    """``/v2/stats`` view of a disaggregated fleet: summed admission
    counters and load gauges across both pools (a stream submits on
    prefill and completes on decode, so each counter increments in
    exactly one pool), with the per-pool snapshots and the handoff
    protocol counters nested."""

    def __init__(self, dfleet: "DisaggregatedFleet"):
        self._dfleet = dfleet

    def snapshot(self) -> Dict:
        from .stats import ServingStats

        pre = self._dfleet.prefill.stats.snapshot()
        dec = self._dfleet.decode.stats.snapshot()
        out: Dict = {}
        for c in ServingStats.COUNTERS:
            out[c] = int(pre.get(c) or 0) + int(dec.get(c) or 0)
        for g in _FleetAggregateStats._SUM_GAUGES:
            out[g] = (pre.get(g) or 0) + (dec.get(g) or 0)
        out["disaggregated"] = True
        out["pools"] = {"prefill": pre, "decode": dec}
        out["handoff"] = self._dfleet.handoff.report()
        return out
