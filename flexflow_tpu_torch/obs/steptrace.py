"""Step-anatomy profiler: critical-path spans, device-bubble accounting,
and the overlap-headroom report for the decode hot path (port of
``flexflow_tpu/obs/steptrace.py``, which imports nothing of JAX: the
same code, kept as the port's own copy).

1. **Where does a step's wall time go?** Every scheduler iteration
   decomposes into host spans — ``schedule`` (expire / speculation
   planning / growth / slot collection), ``admit`` (queue pop, block
   acquisition, post-prefill bookkeeping), ``prefix_plan`` (radix match
   + table assembly), ``draft`` (speculative proposal), ``dispatch``
   (packing, upload and the graph launch), ``block`` (host waiting on
   the step's completion event), ``readback`` (tokens to numpy),
   ``bookkeep`` (token scatter) — plus a device-lane ``execute`` span:
   the engine's execute phase on the host clock, from the step's launch
   (or its in-flight predecessor's completion) to its own completion.
   Spans carry real ``perf_counter`` offsets, not just durations.

2. **Is steady-state decode host-bound or device-bound?** Per-``{kind,
   phase}`` histograms (``flexflow_serving_step_phase_seconds`` on
   /metrics) and a rolling window of token-emitting steps give
   ``device_bubble_ratio`` — the share of step wall time the device sat
   idle while the host worked — and a host-bound / device-bound
   classification.

3. **What would overlap buy?** :meth:`overlap_headroom` projects the
   tokens/s of the same window if every host phase hid behind device
   execution (step wall -> max(execute, dispatch)).

:meth:`arm_capture` retains the next K steps' full span lists;
:meth:`to_chrome_trace` renders them as a two-lane (host / device)
chrome://tracing timeline (``GET /v2/debug/anatomy?capture=K``).

Span stamps are ``time.perf_counter`` values produced by the scheduler
and the engine, physical even in virtual-clock tests; this module never
reads a clock itself. On the CPU a step completes inside its dispatch,
so ``execute`` is near zero and the bubble ratio near one: true of that
configuration, not a prediction of the card. ``observe_step`` is a
handful of dict/float ops per iteration under one lock;
``enabled=False`` makes every method a cheap no-op (mirrors
``observability=False``).
"""
from __future__ import annotations

import math
import threading
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

# span names on the DEVICE lane of the two-lane timeline; everything
# else is host work. With overlap OFF, "block" (host waiting on the
# step) and "execute" (device computing) cover the same interval; under
# the overlap pipeline they genuinely diverge — an
# iteration's execute span started during the previous iteration's
# dispatch, and host bookkeeping sits under it on the other lane.
DEVICE_PHASES = frozenset({"execute"})

# step kinds whose iterations emit tokens — the decode hot path the
# bubble/headroom window is computed over (admission-only iterations
# are aggregated in the histograms but excluded from the window)
HOT_KINDS = frozenset({"decode", "verify"})

# phase-duration buckets (seconds): step phases live in the us..ms
# range on warm engines; the tail covers cold CI hosts
PHASE_BUCKETS: Tuple[float, ...] = (
    1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4,
    1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    0.1, 0.25, 1.0,
)

Span = Tuple[str, float, float]  # (phase, t0, t1) — perf_counter stamps


class _PhaseHist:
    """Fixed-bucket histogram for one (kind, phase). No lock of its
    own: every access happens under the owning StepAnatomy._lock.

    Deliberately NOT serving/stats.Histogram: importing
    ``flexflow_tpu_torch.serving.stats`` from here would execute the serving
    package __init__, whose ``server`` module imports ``..obs`` back
    while obs/__init__ is still mid-import of this module — a cycle
    that breaks on the obs names registered after steptrace."""

    __slots__ = ("counts", "count", "sum")

    BOUNDS: Tuple[float, ...] = PHASE_BUCKETS + (math.inf,)

    def __init__(self):
        self.counts = [0] * len(self.BOUNDS)
        self.count = 0
        self.sum = 0.0

    def observe(self, value: float) -> None:
        i = 0
        for i, b in enumerate(self.BOUNDS):  # noqa: B007 — tiny fixed scan
            if value <= b:
                break
        self.counts[i] += 1
        self.count += 1
        self.sum += value

    def buckets(self) -> List[Tuple[float, int]]:
        """Cumulative (le, count) pairs in the exposition shape."""
        cum, out = 0, []
        for b, c in zip(self.BOUNDS, self.counts):
            cum += c
            out.append((b, cum))
        return out

    def quantile(self, q: float) -> float:
        """Histogram-approximate quantile: the upper bound of the first
        bucket whose cumulative count reaches q (0 when empty)."""
        if self.count == 0:
            return 0.0
        target = q * self.count
        cum = 0
        for b, c in zip(self.BOUNDS, self.counts):
            cum += c
            if cum >= target:
                return b if math.isfinite(b) else self.BOUNDS[-2]
        return self.BOUNDS[-2]


class _WindowSample:
    """One hot-path step in the rolling window."""

    __slots__ = ("kind", "wall", "execute", "dispatch", "host", "tokens")

    def __init__(self, kind, wall, execute, dispatch, host, tokens):
        self.kind = kind
        self.wall = wall
        self.execute = execute
        self.dispatch = dispatch
        self.host = host
        self.tokens = tokens


class StepAnatomy:
    """Span-based step-anatomy aggregator for one scheduler.

    Writers: the scheduler loop thread (``observe_step``). Readers:
    scrape threads (gauges, ``report``, ``prom_snapshot``), the debug
    endpoint (``arm_capture``, ``to_chrome_trace``). One lock guards
    all mutable state.
    """

    def __init__(
        self,
        enabled: bool = True,
        window: int = 128,
        capture_capacity: int = 256,
        host_bound_threshold: float = 0.5,
        min_steps: int = 8,
    ):
        self.enabled = enabled
        self.window_size = max(1, window)
        self.capture_capacity = max(1, capture_capacity)
        self.host_bound_threshold = host_bound_threshold
        self.min_steps = max(1, min_steps)
        self._lock = threading.Lock()
        self._hists: Dict[Tuple[str, str], _PhaseHist] = {}  # guarded-by: _lock
        self._window: deque = deque(maxlen=self.window_size)  # guarded-by: _lock
        self.steps_total = 0  # guarded-by: _lock
        self._capture_left = 0  # guarded-by: _lock
        self._captures: deque = deque(maxlen=self.capture_capacity)  # guarded-by: _lock
        self.captures_total = 0  # guarded-by: _lock

    # ---------------------------------------------------------- recording
    def observe_step(
        self,
        kind: str,
        spans: Sequence[Span],
        t_start: float,
        t_end: float,
        tokens: int = 0,
        hot: bool = True,
    ) -> None:
        """Fold one scheduler iteration into the aggregator. ``spans``
        are (phase, t0, t1) perf_counter stamps; host-lane spans must be
        disjoint (the conservation invariant tests assert), device-lane
        spans mirror host ``block`` time on the other lane and are
        excluded from the host sum. ``hot=False`` keeps the step out of
        the rolling bubble/headroom window (histograms and capture
        still record it): a handled-failure iteration has no execute
        span but a retry/backoff-inflated wall, and one such sample
        would pin the bubble ratio near 1 for a whole window."""
        if not self.enabled:
            return
        wall = max(0.0, t_end - t_start)
        per_phase: Dict[str, float] = {}
        host = execute = dispatch = 0.0
        for name, s0, s1 in spans:
            d = max(0.0, s1 - s0)
            per_phase[name] = per_phase.get(name, 0.0) + d
            if name in DEVICE_PHASES:
                execute += d
            else:
                host += d
            if name == "dispatch":
                dispatch += d
        with self._lock:
            self.steps_total += 1
            for phase, d in per_phase.items():
                h = self._hists.get((kind, phase))
                if h is None:
                    h = self._hists[(kind, phase)] = _PhaseHist()
                h.observe(d)
            if hot and kind in HOT_KINDS:
                self._window.append(
                    _WindowSample(kind, wall, execute, dispatch, host, tokens)
                )
            if self._capture_left > 0:
                self._capture_left -= 1
                self.captures_total += 1
                self._captures.append({
                    "kind": kind,
                    "t_start": t_start,
                    "t_end": t_end,
                    "tokens": int(tokens),
                    "spans": [(n, float(s0), float(s1)) for n, s0, s1 in spans],
                })

    # ------------------------------------------------------------ capture
    def arm_capture(self, k: int) -> int:
        """Retain the next ``k`` steps' full span lists (bounded by the
        capture ring capacity; re-arming replaces the remaining count).
        Returns the armed count — 0 when disabled."""
        if not self.enabled:
            return 0
        k = max(0, min(int(k), self.capture_capacity))
        with self._lock:
            self._capture_left = k
        return k

    def capture_state(self) -> Dict:
        with self._lock:
            return {
                "remaining": self._capture_left,
                "captured": len(self._captures),
                "captured_total": self.captures_total,
                "capacity": self.capture_capacity,
            }

    def captured_steps(self) -> List[Dict]:
        """Locked copy of the retained captures, oldest first."""
        with self._lock:
            return [dict(c) for c in self._captures]

    def to_chrome_trace(self, pid: int = 1, name: str = "step-anatomy") -> Dict:
        """The captured steps as a two-lane chrome://tracing timeline:
        tid 1 = host spans, tid 2 = device spans (``execute``), with
        REAL span offsets (microseconds relative to the oldest captured
        step) — not the flight recorder's synthetic sequential layout.
        Load in chrome://tracing or https://ui.perfetto.dev."""
        captures = self.captured_steps()
        events: List[Dict] = [
            {"name": "process_name", "ph": "M", "pid": pid,
             "args": {"name": name}},
            {"name": "thread_name", "ph": "M", "pid": pid, "tid": 1,
             "args": {"name": "host"}},
            {"name": "thread_name", "ph": "M", "pid": pid, "tid": 2,
             "args": {"name": "device"}},
        ]
        if not captures:
            return {"traceEvents": events, "displayTimeUnit": "ms"}
        t0 = captures[0]["t_start"]
        for i, cap in enumerate(captures):
            for phase, s0, s1 in cap["spans"]:
                events.append({
                    "name": phase,
                    "ph": "X",
                    "pid": pid,
                    "tid": 2 if phase in DEVICE_PHASES else 1,
                    "ts": (s0 - t0) * 1e6,
                    "dur": max(0.0, s1 - s0) * 1e6,
                    "args": {"step": i, "kind": cap["kind"]},
                })
            events.append({
                "name": f"step:{cap['kind']}",
                "ph": "i", "pid": pid, "tid": 1, "s": "t",
                "ts": (cap["t_start"] - t0) * 1e6,
                "args": {"step": i, "tokens": cap["tokens"]},
            })
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    # ---------------------------------------------------------- analysis
    def _window_sums_locked(self) -> Tuple[int, float, float, float, int]:
        """(n, wall, execute, projected, tokens) over the rolling
        window in ONE pass — the shared input for the bubble,
        classification, and headroom reads, so a scrape sums in-lock
        instead of copying the window once per gauge."""
        n = wall = execute = projected = tokens = 0
        for s in self._window:
            n += 1
            wall += s.wall
            execute += s.execute
            projected += max(s.execute, s.dispatch)
            tokens += s.tokens
        return n, wall, execute, projected, tokens

    def device_bubble_ratio(self) -> Optional[float]:
        """Fraction of hot-path step wall time the device sat idle
        while the host worked: 1 - execute/wall over the rolling
        window. None before any token-emitting step."""
        with self._lock:
            _, wall, execute, _, _ = self._window_sums_locked()
        if wall <= 0.0:
            return None
        return max(0.0, min(1.0, 1.0 - execute / wall))

    def classification(self) -> str:
        """"host_bound" / "device_bound" over the rolling window, or
        "unknown" before ``min_steps`` hot-path steps accumulated."""
        with self._lock:
            n, wall, execute, _, _ = self._window_sums_locked()
        if n < self.min_steps or wall <= 0.0:
            return "unknown"
        bubble = max(0.0, min(1.0, 1.0 - execute / wall))
        return "host_bound" if bubble >= self.host_bound_threshold else "device_bound"

    def overlap_headroom(self) -> Dict:
        """Amdahl-style projection over the rolling window: tokens/s if
        every host phase were hidden behind device execution. Per step
        the projected wall is max(execute, dispatch) — dispatch is the
        serial residue that must still issue the program even in a
        fully pipelined loop. ``projected_speedup`` is the go/no-go
        number for ROADMAP item 4 (and its gate once overlap lands);
        ``host_s_per_hot_step`` (hidden host seconds / steps) is the
        UNCLAMPED trajectory perfwatch gates — the bubble ratio
        saturates at 1.0 on host-bound CPU hosts, so a ratio gate could
        never fire there."""
        with self._lock:
            n, wall, execute, projected, tokens = self._window_sums_locked()
        if wall <= 0.0 or n == 0:
            return {
                "steps": n, "tokens": tokens,
                "measured_tokens_per_s": None,
                "projected_tokens_per_s": None,
                "projected_speedup": None,
                "hidden_host_s": None,
                "host_s_per_hot_step": None,
            }
        # a fully host-bound window (execute ~ 0) still pays dispatch;
        # floor keeps the projection finite instead of infinite
        projected = max(projected, 1e-9)
        hidden = max(0.0, wall - projected)
        return {
            "steps": n,
            "tokens": tokens,
            "measured_tokens_per_s": tokens / wall,
            "projected_tokens_per_s": tokens / projected,
            "projected_speedup": wall / projected,
            "hidden_host_s": hidden,
            "host_s_per_hot_step": hidden / n,
        }

    # ---------------------------------------------------------- reporting
    def phases_summary(self) -> Dict[str, Dict[str, Dict]]:
        """kind -> phase -> {count, total_s, mean_s, p50_s} from the
        cumulative per-(kind, phase) histograms."""
        with self._lock:
            items = [(k, h.count, h.sum, h.quantile(0.5))
                     for k, h in sorted(self._hists.items())]
        out: Dict[str, Dict[str, Dict]] = {}
        for (kind, phase), count, total, p50 in items:
            out.setdefault(kind, {})[phase] = {
                "count": count,
                "total_s": total,
                "mean_s": total / count if count else 0.0,
                "p50_s": p50,
            }
        return out

    def report(self) -> Dict:
        """The ``GET /v2/debug/anatomy`` payload for one unit."""
        return {
            "enabled": self.enabled,
            "steps_observed": self.steps_observed(),
            "window_size": self.window_size,
            "phases": self.phases_summary(),
            "device_bubble_ratio": self.device_bubble_ratio(),
            "classification": self.classification(),
            "headroom": self.overlap_headroom(),
            "capture": self.capture_state(),
        }

    def steps_observed(self) -> int:
        with self._lock:
            return self.steps_total

    def prom_snapshot(self) -> List[Dict]:
        """The ``flexflow_serving_step_phase_seconds`` family's input
        for obs/prom.py: one entry per (kind, phase) with cumulative
        buckets, sorted for deterministic rendering."""
        with self._lock:
            items = [
                (kind, phase, h.buckets(), h.sum, h.count)
                for (kind, phase), h in sorted(self._hists.items())
            ]
        return [
            {"kind": kind, "phase": phase, "buckets": buckets,
             "sum": total, "count": count}
            for kind, phase, buckets, total, count in items
        ]

    def register_gauges(self, stats) -> None:
        """Surface the window-derived signals as ServingStats gauges
        (``flexflow_serving_step_*`` on /metrics). A gauge returning
        None is skipped by the exposition — a disabled or not-yet-warm
        anatomy emits nothing rather than zeros that look like data."""
        stats.add_gauge("step_device_bubble_ratio", self.device_bubble_ratio)
        stats.add_gauge(
            "step_host_bound",
            lambda: {"host_bound": 1.0, "device_bound": 0.0}.get(
                self.classification()
            ),
        )
        stats.add_gauge(
            "step_overlap_projected_tokens_per_s",
            lambda: self.overlap_headroom()["projected_tokens_per_s"],
        )
        stats.add_gauge(
            "step_overlap_projected_speedup",
            lambda: self.overlap_headroom()["projected_speedup"],
        )
        stats.add_gauge(
            "step_anatomy_steps_observed",
            lambda: self.steps_observed() if self.enabled else None,
        )
