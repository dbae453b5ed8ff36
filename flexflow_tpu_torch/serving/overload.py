"""Overload control (port of ``flexflow_tpu/serving/overload.py``):
priority-aware admission, an AIMD adaptive concurrency limiter, and a
graceful-degradation ladder with hysteresis.

* **Priority classes** (:class:`Priority`) — interactive / standard /
  best_effort, carried from the HTTP request (body ``"priority"`` or the
  ``X-Request-Priority`` header) into the continuous-batching scheduler.
  Admission order, preemption-victim selection and shed order are all
  priority-ordered; rejections are the typed
  :class:`~flexflow_tpu_torch.serving.resilience.OverloadedError` (HTTP
  503 + ``Retry-After``) with per-reason / per-priority accounting on
  ``/v2/stats``.

* :class:`AdaptiveLimiter` — an AIMD concurrency limit over live (queued
  + running) requests, driven by the queue-time/TTFT percentile windows
  and the cache-pressure flag on the scheduler's injectable clock.
  Healthy intervals raise the limit additively; overloaded intervals cut
  it multiplicatively, so admissions throttle BEFORE the queue fills.
  Lower classes hit the limit first (per-class headroom multipliers).

* :class:`DegradeLadder` — under sustained pressure the scheduler
  degrades *quality of service before correctness*, one level at a time
  with hysteresis:

      level 1   cap the speculation window k (fewer drafted tokens)
      level 2   disable drafting entirely (plain decode)
      level 3   clamp per-class ``max_new`` for NEW admissions
      level 4   shed best-effort (queued best-effort fails typed; new
                best-effort submits are refused with reason "degraded")

  Every transition is a flight-ring event and moves the ``degrade_level``
  gauge. Streams stay exact across a level change: capping or disabling
  speculation emits the same tokens (the acceptance rule is exact for
  any k), and the ``max_new`` clamp applies only to requests admitted at
  that level.

* **Roofline infeasibility fast-fail** — a request whose
  roofline-predicted TTFT already exceeds its deadline is denied at
  submit (typed :class:`~flexflow_tpu_torch.serving.resilience.InfeasibleError`,
  counted apart from sheds).

:class:`OverloadController` composes the three for one scheduler;
:class:`AutoscaleAdvisor` turns a fleet's sustained saturation or
idleness into a want-more / want-fewer replica signal. Everything runs on
injectable clocks, so tests drive saturation, shedding and recovery on
virtual time; the machinery is inert off the pressure path.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, List, Optional

from .resilience import InfeasibleError, OverloadedError


class Priority:
    """The three serving priority classes, best first. Values are
    strings so request metadata, stats counters, and reports stay
    JSON-plain."""

    INTERACTIVE = "interactive"
    STANDARD = "standard"
    BEST_EFFORT = "best_effort"

    ORDER = (INTERACTIVE, STANDARD, BEST_EFFORT)
    RANK = {INTERACTIVE: 0, STANDARD: 1, BEST_EFFORT: 2}

    @classmethod
    def parse(cls, value, default: str = STANDARD) -> str:
        """Normalize request-supplied priority metadata ("Interactive",
        "best-effort", None, ...) to a canonical class; unknown values
        raise ValueError so transports answer 400/INVALID_ARGUMENT
        instead of silently serving at the wrong class."""
        if value is None or value == "":
            return default
        p = str(value).strip().lower().replace("-", "_")
        if p not in cls.RANK:
            raise ValueError(
                f"unknown priority {value!r}; want one of {cls.ORDER}"
            )
        return p

    @classmethod
    def rank(cls, priority: str) -> int:
        return cls.RANK[priority]


@dataclasses.dataclass(frozen=True)
class OverloadConfig:
    """Tuning for one scheduler's overload controller. Defaults are
    deliberately inert on an unloaded engine: the limiter starts wide
    open and only cuts when the queue-occupancy floor AND a latency /
    cache-pressure signal agree, so fault-free benches never see a
    throttle, shed, or ladder transition."""

    # ---- AdaptiveLimiter
    limiter_interval_s: float = 0.5     # AIMD adjustment cadence
    additive_step: float = 1.0          # healthy interval: limit += step
    md_factor: float = 0.5              # overloaded interval: limit *= factor
    min_limit: Optional[int] = None     # floor (default: engine slot count)
    max_limit: Optional[int] = None     # ceiling (default: slots + max_queue)
    target_queue_s: float = 0.5         # queue-time p95 target
    target_ttft_s: float = 2.5          # TTFT p95 target (matches the SLO)
    # occupancy floor before any cut (the JAX package's simulator-tuned
    # value): the deeper floor stops the limiter cutting on queues the
    # engine was about to drain anyway
    min_queue_frac: float = 0.25
    hard_queue_frac: float = 0.5        # occupancy at/above which the cut
                                        # signal fires unconditionally
    # per-class admission headroom: fraction of the live limit each
    # class may fill — best-effort saturates first, interactive keeps a
    # reserve above the nominal limit
    class_headroom: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {
            Priority.INTERACTIVE: 1.1,
            Priority.STANDARD: 1.0,
            Priority.BEST_EFFORT: 0.85,
        }
    )
    # ---- DegradeLadder
    # pressure >= this to climb (the JAX package's simulator-tuned
    # value): the later trigger skips climbs the limiter alone was
    # already absorbing
    up_threshold: float = 0.9
    up_hold_s: float = 0.25             # ...sustained this long
    down_threshold: float = 0.3         # pressure <= this to descend...
    down_hold_s: float = 1.0            # ...sustained this long (hysteresis)
    spec_cap_level1: int = 1            # level 1: cap speculation k
    # level 3: per-class max_new clamp for NEW admissions (None = uncapped)
    max_new_caps: Dict[str, Optional[int]] = dataclasses.field(
        default_factory=lambda: {
            Priority.INTERACTIVE: None,
            Priority.STANDARD: 256,
            Priority.BEST_EFFORT: 64,
        }
    )
    # ---- rejections
    retry_after_base_s: float = 1.0     # Retry-After = base * (1 + level)
    # ---- AutoscaleAdvisor (fleet-level: serving/fleet.py builds its
    # advisor from the same config that tunes each replica's controller,
    # one tuning surface for replica-count and admission dynamics)
    autoscale_up_hold_s: float = 3.0    # full saturation this long -> +1
    autoscale_down_hold_s: float = 30.0  # idle this long -> -1
    autoscale_low_util: float = 0.25    # "idle" = no saturation, util <= this


class AdaptiveLimiter:
    """AIMD concurrency limit over live (queued + running) requests.

    ``try_acquire(priority)`` admits while the live count is under the
    class's headroom-scaled limit; ``release()`` runs exactly once per
    terminal request (the handle settle-race winner). ``tick()`` —
    called once per scheduler iteration on the injectable clock —
    re-evaluates the pressure signals at ``interval_s`` boundaries:
    an overloaded interval (queue-time/TTFT p95 past target or cache
    pressure, with the queue at least ``min_queue_frac`` occupied)
    cuts the limit multiplicatively; a healthy interval raises it
    additively toward the ceiling.
    """

    def __init__(
        self,
        cfg: OverloadConfig,
        *,
        clock: Callable[[], float],
        slots: int,
        max_queue: int,
        queue_depth: Callable[[], int],
        queue_p95: Callable[[], float],
        ttft_p95: Callable[[], float],
        cache_pressure: Callable[[], bool],
    ):
        self.cfg = cfg
        self.clock = clock
        self.queue_depth = queue_depth
        self.queue_p95 = queue_p95
        self.ttft_p95 = ttft_p95
        self.cache_pressure = cache_pressure
        self.max_queue = max(1, max_queue)
        self.min_limit = float(
            cfg.min_limit if cfg.min_limit is not None else max(1, slots)
        )
        self.max_limit = float(
            cfg.max_limit if cfg.max_limit is not None else slots + max_queue
        )
        self._lock = threading.Lock()
        self._limit = self.max_limit  # guarded-by: _lock
        self._inflight = 0  # guarded-by: _lock
        self._last_adjust: Optional[float] = None  # guarded-by: _lock
        self._last_decision = "idle"  # guarded-by: _lock
        self.raises_total = 0  # guarded-by: _lock
        self.cuts_total = 0  # guarded-by: _lock
        self.throttled_total = 0  # guarded-by: _lock

    # ------------------------------------------------------------ admission
    def _allowed_locked(self, priority: str) -> float:
        return self._limit * self.cfg.class_headroom.get(priority, 1.0)

    def would_admit(self, priority: str) -> bool:
        """Non-mutating admission probe (the fleet router's spill
        input)."""
        with self._lock:
            return self._inflight < self._allowed_locked(priority)

    def can_admit(self, priority: str, freed: int = 0) -> bool:
        """Would ``try_acquire`` succeed after ``freed`` pending
        releases? The submit path's plan-before-shed feasibility check:
        no victim is destroyed unless its release actually lets the
        newcomer in."""
        with self._lock:
            return self._inflight - freed < self._allowed_locked(priority)

    def try_acquire(self, priority: str) -> bool:
        with self._lock:
            if self._inflight >= self._allowed_locked(priority):
                self.throttled_total += 1
                return False
            self._inflight += 1
            return True

    def acquire_forced(self) -> None:
        """Count one admission regardless of the limit (``adopt``: a
        warm-restarted stream was admitted once already and must not be
        dropped here, but its load must be visible)."""
        with self._lock:
            self._inflight += 1

    def note_throttled(self) -> None:
        """Count one limiter refusal decided by the plan-before-shed
        gate (``can_admit``), which — unlike ``try_acquire`` — never
        mutates and so cannot count its own refusals."""
        with self._lock:
            self.throttled_total += 1

    def release(self) -> None:
        with self._lock:
            if self._inflight > 0:
                self._inflight -= 1

    def counts(self) -> Dict[str, int]:
        """Locked counter reads for the gauge path (no full snapshot /
        history copies per scrape)."""
        with self._lock:
            return {
                "throttled": self.throttled_total,
                "cuts": self.cuts_total,
                "raises": self.raises_total,
            }

    # ------------------------------------------------------------- control
    def overloaded(self) -> bool:
        """The cut signal: a latency or capacity symptom AND a queue
        actually forming. The occupancy floor keeps a benign burst of
        co-submitted requests (whose queue-time window legitimately
        grows while they wait for slots) from reading as overload."""
        cfg = self.cfg
        qfrac = self.queue_depth() / self.max_queue
        if qfrac < cfg.min_queue_frac:
            return False
        if qfrac >= cfg.hard_queue_frac:
            return True
        if self.queue_p95() > cfg.target_queue_s:
            return True
        if self.ttft_p95() > cfg.target_ttft_s:
            return True
        return bool(self.cache_pressure())

    def tick(self) -> Optional[str]:
        """One control-loop evaluation; adjusts at interval boundaries.
        Returns "cut" / "raise" when the limit moved this call."""
        now = self.clock()
        with self._lock:
            if self._last_adjust is None:
                self._last_adjust = now
                return None
            if now - self._last_adjust < self.cfg.limiter_interval_s:
                return None
            self._last_adjust = now
        hot = self.overloaded()  # reads other components; outside _lock
        with self._lock:
            if hot:
                new = max(self.min_limit, self._limit * self.cfg.md_factor)
                moved = new < self._limit
                self._limit = new
                self._last_decision = "cut"
                if moved:
                    self.cuts_total += 1
                    return "cut"
                return None
            new = min(self.max_limit, self._limit + self.cfg.additive_step)
            moved = new > self._limit
            self._limit = new
            self._last_decision = "raise"
            if moved:
                self.raises_total += 1
                return "raise"
            return None

    # ------------------------------------------------------------- reading
    @property
    def limit(self) -> float:
        with self._lock:
            return self._limit

    @property
    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    def utilization(self) -> float:
        with self._lock:
            return self._inflight / max(1.0, self._limit)

    def snapshot(self) -> Dict:
        with self._lock:
            return {
                "limit": self._limit,
                "min_limit": self.min_limit,
                "max_limit": self.max_limit,
                "inflight": self._inflight,
                "utilization": self._inflight / max(1.0, self._limit),
                "last_decision": self._last_decision,
                "raises_total": self.raises_total,
                "cuts_total": self.cuts_total,
                "throttled_total": self.throttled_total,
            }


class DegradeLadder:
    """Graded QoS degradation with hysteresis on an injectable clock.

    ``update(pressure)`` — once per scheduler iteration — climbs one
    level after ``up_hold_s`` of pressure at/above ``up_threshold`` and
    descends one level after ``down_hold_s`` at/below
    ``down_threshold``; anything in between resets both timers, so the
    ladder can neither flap nor skip levels. Transitions are recorded
    in a bounded history and reported through ``on_transition``.
    """

    MAX_LEVEL = 4

    def __init__(
        self,
        cfg: OverloadConfig,
        *,
        clock: Callable[[], float],
        on_transition: Optional[Callable[[int, int, float], None]] = None,
    ):
        self.cfg = cfg
        self.clock = clock
        self.on_transition = on_transition
        self._lock = threading.Lock()
        self._level = 0  # guarded-by: _lock
        self._above_since: Optional[float] = None  # guarded-by: _lock
        self._below_since: Optional[float] = None  # guarded-by: _lock
        self.transitions_total = 0  # guarded-by: _lock
        self._history: List[Dict] = []  # guarded-by: _lock
        self.max_level_seen = 0  # guarded-by: _lock

    @property
    def level(self) -> int:
        with self._lock:
            return self._level

    def update(self, pressure: float) -> Optional[int]:
        """Fold one pressure sample in; returns the new level when a
        transition happened this call, else None."""
        now = self.clock()
        cb = None
        with self._lock:
            old = self._level
            new = old
            if pressure >= self.cfg.up_threshold:
                self._below_since = None
                if self._above_since is None:
                    self._above_since = now
                elif (
                    now - self._above_since >= self.cfg.up_hold_s
                    and old < self.MAX_LEVEL
                ):
                    new = old + 1
                    self._above_since = now  # one level per hold window
            elif pressure <= self.cfg.down_threshold:
                self._above_since = None
                if self._below_since is None:
                    self._below_since = now
                elif (
                    now - self._below_since >= self.cfg.down_hold_s
                    and old > 0
                ):
                    new = old - 1
                    self._below_since = now
            else:
                self._above_since = None
                self._below_since = None
            if new == old:
                return None
            self._level = new
            self.transitions_total += 1
            self.max_level_seen = max(self.max_level_seen, new)
            self._history.append({
                "t": now, "from": old, "to": new, "pressure": pressure,
            })
            del self._history[:-64]
            cb = self.on_transition
        if cb is not None:
            try:
                cb(old, new, pressure)
            except Exception:
                pass  # a telemetry hook must never break the control loop
        return new

    # --------------------------------------------------------- level effects
    def spec_cap(self) -> Optional[int]:
        """Speculation-window cap for THIS iteration: None below level
        1, ``spec_cap_level1`` at level 1, 0 (drafting disabled) at
        level 2 and above. Exact by construction — the acceptance
        rule makes any k (including 0) emit the same greedy stream."""
        lvl = self.level
        if lvl <= 0:
            return None
        if lvl == 1:
            return self.cfg.spec_cap_level1
        return 0

    def max_new_cap(self, priority: str) -> Optional[int]:
        """Per-class ``max_new`` clamp for NEW admissions at level 3+
        (running streams keep the budget they were admitted with —
        byte-exactness across a level change)."""
        if self.level < 3:
            return None
        return self.cfg.max_new_caps.get(priority)

    def shed_best_effort(self) -> bool:
        """Level 4: refuse new best-effort work and shed what is
        queued (never-streamed requests only)."""
        return self.level >= 4

    @property
    def transitions(self) -> int:
        with self._lock:
            return self.transitions_total

    def history(self) -> List[Dict]:
        with self._lock:
            return list(self._history)

    def snapshot(self) -> Dict:
        with self._lock:
            return {
                "level": self._level,
                "max_level_seen": self.max_level_seen,
                "transitions_total": self.transitions_total,
                "up_threshold": self.cfg.up_threshold,
                "down_threshold": self.cfg.down_threshold,
                "history": list(self._history),
            }


class OverloadController:
    """One scheduler's overload-control plane: limiter + ladder +
    per-reason/per-priority rejection accounting + the roofline
    infeasibility gate. The scheduler calls ``tick()`` once per
    iteration and consults the admission helpers from ``submit``; all
    signal inputs are zero-arg callables so this module owns no
    scheduler state.
    """

    REASONS = ("queue_full", "limiter", "infeasible", "degraded")

    def __init__(
        self,
        *,
        clock: Callable[[], float],
        slots: int,
        max_queue: int,
        queue_depth: Callable[[], int],
        queue_p95: Callable[[], float],
        ttft_p95: Callable[[], float],
        cache_pressure: Callable[[], bool],
        ttft_predictor: Optional[Callable[[int, int], float]] = None,
        stats=None,
        on_transition: Optional[Callable[[int, int, float], None]] = None,
        config: Optional[OverloadConfig] = None,
    ):
        self.cfg = config or OverloadConfig()
        self.clock = clock
        self.max_queue = max(1, max_queue)
        self.queue_depth = queue_depth
        self.cache_pressure = cache_pressure
        # predicted TTFT for (prompt_len, queue_depth) — the
        # serving roofline by default; injectable so tests pin it
        self.ttft_predictor = ttft_predictor
        self.stats = stats
        self.limiter = AdaptiveLimiter(
            self.cfg, clock=clock, slots=slots, max_queue=max_queue,
            queue_depth=queue_depth, queue_p95=queue_p95, ttft_p95=ttft_p95,
            cache_pressure=cache_pressure,
        )
        self.ladder = DegradeLadder(
            self.cfg, clock=clock, on_transition=on_transition,
        )
        self._lock = threading.Lock()
        self.sheds_total = 0  # guarded-by: _lock
        self.infeasible_total = 0  # guarded-by: _lock
        self._by_reason: Dict[str, int] = {}  # guarded-by: _lock
        self._by_priority: Dict[str, int] = {}  # guarded-by: _lock

    # ------------------------------------------------------------ admission
    def would_admit(self, priority: str) -> bool:
        """Non-mutating probe: would ``submit`` at this priority pass the
        overload gates right now? (The fleet router's spill input;
        queue-full displacement is not modeled: a spill beats a
        displacement.)"""
        if self.ladder.shed_best_effort() and priority == Priority.BEST_EFFORT:
            return False
        if self.queue_depth() >= self.max_queue:
            return False
        return self.limiter.would_admit(priority)

    def degraded_reject(self, priority: str) -> bool:
        return self.ladder.shed_best_effort() and priority == Priority.BEST_EFFORT

    def spec_cap(self) -> Optional[int]:
        return self.ladder.spec_cap()

    def max_new_cap(self, priority: str) -> Optional[int]:
        return self.ladder.max_new_cap(priority)

    def predicted_ttft_s(self, prompt_len: int) -> Optional[float]:
        if self.ttft_predictor is None:
            return None
        try:
            return float(self.ttft_predictor(prompt_len, self.queue_depth()))
        except Exception:
            return None  # a dying predictor must never block admission

    def infeasible(self, prompt_len: int, deadline_s: Optional[float]) -> Optional[float]:
        """Predicted TTFT when it already exceeds the deadline, else
        None (feasible / no deadline / no predictor)."""
        if deadline_s is None:
            return None
        predicted = self.predicted_ttft_s(prompt_len)
        if predicted is not None and predicted > deadline_s:
            return predicted
        return None

    def retry_after_s(self) -> float:
        """Suggested client backoff: the base, scaled by how degraded
        the service currently is."""
        return self.cfg.retry_after_base_s * (1 + self.ladder.level)

    # ------------------------------------------------------------ rejections
    def note_rejection(self, reason: str, priority: str, shed: bool = False) -> None:
        """Account one refused request per reason AND per priority (the
        /v2/stats 'why was load refused' split); ``shed=True`` marks a
        queued victim displaced by higher-priority work."""
        with self._lock:
            self._by_reason[reason] = self._by_reason.get(reason, 0) + 1
            self._by_priority[priority] = self._by_priority.get(priority, 0) + 1
            if shed:
                self.sheds_total += 1
            if reason == "infeasible":
                self.infeasible_total += 1
        if reason == "limiter" and not shed:
            # the plan-before-shed gate refused without ever calling the
            # (mutating, self-counting) try_acquire
            self.limiter.note_throttled()
        if self.stats is not None:
            self.stats.incr("rejected")
            self.stats.incr(f"rejected_{reason}")
            self.stats.incr(f"rejected_{priority}")

    def overload_error(
        self, msg: str, reason: str, priority: str, shed: bool = False,
    ) -> OverloadedError:
        """Account + build the typed rejection in one step."""
        self.note_rejection(reason, priority, shed=shed)
        return OverloadedError(
            msg, reason=reason, priority=priority,
            retry_after_s=self.retry_after_s(),
        )

    def infeasible_error(
        self, priority: str, predicted_s: float, deadline_s: float,
    ) -> InfeasibleError:
        self.note_rejection("infeasible", priority)
        return InfeasibleError(
            f"predicted TTFT {predicted_s * 1e3:.0f}ms already exceeds the "
            f"{deadline_s * 1e3:.0f}ms deadline",
            priority=priority, retry_after_s=self.retry_after_s(),
            predicted_ttft_s=predicted_s,
        )

    # -------------------------------------------------------------- control
    def pressure(self) -> float:
        """The ladder's drive signal in [0, 1]: queue occupancy,
        limiter saturation (only meaningful once the limiter has been
        cut below its ceiling), and cache pressure."""
        qfrac = min(1.0, self.queue_depth() / self.max_queue)
        lim = self.limiter
        sat = 0.0
        if lim.limit < lim.max_limit:
            sat = min(1.0, lim.utilization())
        cache = 1.0 if (self.cache_pressure() and self.queue_depth() > 0) else 0.0
        return max(qfrac, sat, cache)

    def tick(self) -> None:
        """One control-plane iteration: AIMD adjustment, then the
        ladder folds in the current pressure."""
        self.limiter.tick()
        self.ladder.update(self.pressure())

    # ------------------------------------------------------------- reporting
    def rejections(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            return {
                "by_reason": dict(self._by_reason),
                "by_priority": dict(self._by_priority),
            }

    def activations(self) -> Dict[str, int]:
        """The inertness counters, zero on a fault-free unloaded run: any nonzero value means the overload machinery acted."""
        lim = self.limiter.counts()
        with self._lock:
            sheds = self.sheds_total
            infeasible = self.infeasible_total
            rejected = sum(self._by_reason.values())
        return {
            "throttled": lim["throttled"],
            "limit_cuts": lim["cuts"],
            "sheds": sheds,
            "infeasible": infeasible,
            "rejected": rejected,
            "degrade_transitions": self.ladder.transitions,
            "degrade_level": self.ladder.level,
        }

    def report(self) -> Dict:
        """The ``GET /v2/overload`` payload for one scheduler."""
        return {
            "limiter": self.limiter.snapshot(),
            "ladder": self.ladder.snapshot(),
            "rejections": self.rejections(),
            "pressure": self.pressure(),
            "retry_after_s": self.retry_after_s(),
        }

    def shed_count(self) -> int:
        with self._lock:
            return self.sheds_total

    def infeasible_count(self) -> int:
        with self._lock:
            return self.infeasible_total

    def register_gauges(self, stats) -> None:
        """``flexflow_serving_overload_*`` / ``degrade_level`` series
        (golden-pinned in tests/data/prometheus_golden.txt). Gauges read
        single locked counters — never full snapshots or history copies
        — so a scrape costs a handful of integer reads."""
        lim = self.limiter
        stats.add_gauge("overload_limit", lambda: lim.limit)
        stats.add_gauge("overload_inflight", lambda: lim.inflight)
        stats.add_gauge(
            "overload_throttled_total", lambda: lim.counts()["throttled"]
        )
        stats.add_gauge(
            "overload_limit_cuts_total", lambda: lim.counts()["cuts"]
        )
        stats.add_gauge("overload_sheds_total", self.shed_count)
        stats.add_gauge("overload_infeasible_total", self.infeasible_count)
        stats.add_gauge("degrade_level", lambda: self.ladder.level)
        stats.add_gauge(
            "degrade_transitions_total", lambda: self.ladder.transitions
        )


class AutoscaleAdvisor:
    """Fleet want-more/want-fewer replica signal from sustained limiter
    state.

    The fleet supervisor feeds one ``observe`` per ``check()`` with the
    fraction of eligible replicas that are saturated (their controller
    would not admit standard-priority work, or their ladder is
    degraded) and the mean limiter utilization. The signal is +1 after
    EVERY eligible replica has been saturated for ``up_hold_s``
    (spilling no longer has anywhere to go), -1 after the fleet has
    been idle-ish (no saturation, utilization under ``low_util``) for
    ``down_hold_s``, else 0 — the same sustained-signal hysteresis
    shape as the degrade ladder, so a burst the ladder absorbs does
    not also thrash the replica count.
    """

    def __init__(
        self,
        *,
        clock: Callable[[], float],
        up_hold_s: float = 3.0,
        down_hold_s: float = 30.0,
        low_util: float = 0.25,
    ):
        self.clock = clock
        self.up_hold_s = up_hold_s
        self.down_hold_s = down_hold_s
        self.low_util = low_util
        self._lock = threading.Lock()
        self._saturated_since: Optional[float] = None  # guarded-by: _lock
        self._idle_since: Optional[float] = None  # guarded-by: _lock
        self._signal = 0  # guarded-by: _lock
        self._last: Dict = {}  # guarded-by: _lock

    @classmethod
    def from_config(
        cls, cfg: OverloadConfig, *, clock: Callable[[], float],
    ) -> "AutoscaleAdvisor":
        """Build from the typed overload config: the fleet's replica
        count and each replica's admission tune from one surface."""
        return cls(
            clock=clock,
            up_hold_s=cfg.autoscale_up_hold_s,
            down_hold_s=cfg.autoscale_down_hold_s,
            low_util=cfg.autoscale_low_util,
        )

    def observe(self, saturated_frac: float, mean_util: float) -> int:
        now = self.clock()
        with self._lock:
            if saturated_frac >= 1.0:
                self._idle_since = None
                if self._saturated_since is None:
                    self._saturated_since = now
                self._signal = (
                    1 if now - self._saturated_since >= self.up_hold_s else 0
                )
            elif saturated_frac == 0.0 and mean_util <= self.low_util:
                self._saturated_since = None
                if self._idle_since is None:
                    self._idle_since = now
                self._signal = (
                    -1 if now - self._idle_since >= self.down_hold_s else 0
                )
            else:
                self._saturated_since = None
                self._idle_since = None
                self._signal = 0
            self._last = {
                "t": now,
                "saturated_frac": saturated_frac,
                "mean_utilization": mean_util,
            }
            return self._signal

    @property
    def signal(self) -> int:
        with self._lock:
            return self._signal

    def want_replicas(self, current: int) -> int:
        return max(1, current + self.signal)

    def report(self, current: int) -> Dict:
        now = self.clock()
        with self._lock:
            sustained = 0.0
            if self._signal > 0 and self._saturated_since is not None:
                sustained = now - self._saturated_since
            elif self._signal < 0 and self._idle_since is not None:
                sustained = now - self._idle_since
            return {
                "signal": self._signal,
                "want_replicas": max(1, current + self._signal),
                "current_replicas": current,
                "sustained_s": sustained,
                "last_observation": dict(self._last),
                "up_hold_s": self.up_hold_s,
                "down_hold_s": self.down_hold_s,
            }
