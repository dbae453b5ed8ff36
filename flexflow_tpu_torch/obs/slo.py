"""Declarative serving SLOs with multi-window burn-rate monitoring.

(Port of ``flexflow_tpu/obs/slo.py``, which imports nothing of JAX: the
same code, kept as the port's own copy.)

An :class:`SLObjective` encodes a target of the form "at least
``target`` fraction of requests are *good*", where good means:

  * ``metric="ttft"``  — TTFT <= ``threshold_s`` (a percentile target:
    "p95 TTFT under 2.5s" is exactly "95% of requests have TTFT under
    2.5s");
  * ``metric="tpot"``  — mean time-per-output-token <= ``threshold_s``;
  * ``metric="availability"`` — the request completed (any failure,
    expiry, or quarantine is bad; client cancellation / shutdown drain
    — ``availability_skip`` outcomes — count neither way).

The monitor evaluates each objective over TWO trailing windows — fast
(default 5 minutes) and slow (default 1 hour) — on an injectable clock,
so burn-rate tests run entirely on virtual time. The *burn rate* is the
SRE workbook's definition:

    burn = bad_fraction / (1 - target)

i.e. how many times faster than "exactly on budget" the error budget is
being consumed; burn > 1 sustained for a full window means the SLO is
missed for that window. An objective is **breaching** when BOTH windows
burn at or above its ``burn_threshold`` (the standard multi-window
alert: the fast window proves it is still happening, the slow window
proves it is not a blip) with at least ``min_events`` fast-window
samples.

Surfaced on ``GET /v2/slo``, as ``flexflow_serving_slo_*`` gauges on
``/metrics``, and as the third input (alongside the circuit breaker and
the watchdog) to the health endpoints' readiness *rationale* — a
breaching SLO explains degraded service but does not flip readiness by
itself (that would turn a latency regression into an outage).
"""
from __future__ import annotations

import dataclasses
import math
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

METRICS = ("ttft", "tpot", "availability")


@dataclasses.dataclass(frozen=True)
class SLObjective:
    """One declarative objective. ``target`` is the required good
    fraction (0..1); ``threshold_s`` bounds the latency metric (unused
    for availability); ``burn_threshold`` is the multi-window alert
    level (1.0 = budget consumed exactly as fast as allowed)."""

    name: str
    metric: str = "ttft"
    target: float = 0.95
    threshold_s: Optional[float] = None
    burn_threshold: float = 1.0
    min_events: int = 1

    def __post_init__(self):
        if self.metric not in METRICS:
            raise ValueError(f"unknown SLO metric {self.metric!r}; want one of {METRICS}")
        if not 0.0 < self.target < 1.0:
            raise ValueError(f"target must be in (0, 1), got {self.target}")
        if self.metric != "availability" and self.threshold_s is None:
            raise ValueError(f"objective {self.name!r}: latency metric needs threshold_s")


DEFAULT_OBJECTIVES: Tuple[SLObjective, ...] = (
    SLObjective("ttft_p95", metric="ttft", target=0.95, threshold_s=2.5),
    SLObjective("tpot_p95", metric="tpot", target=0.95, threshold_s=0.5),
    SLObjective("availability", metric="availability", target=0.999),
)


class _BurnWindow:
    """Trailing-window good/bad event counts on a supplied clock.

    Events aggregate into fixed-width time buckets, so memory is bounded
    by ``window_s / bucket_s`` (+1) regardless of request rate — a
    per-event ring with a count cap would silently shrink the 1-hour
    window into a short one under sustained load, collapsing the
    multi-window breach logic toward the fast window alone. A bucket
    expires when its START falls out of the window, so expiry is exact
    to ``bucket_s`` granularity (default 1s)."""

    def __init__(
        self,
        window_s: float,
        clock: Callable[[], float],
        bucket_s: Optional[float] = None,
    ):
        self.window_s = window_s
        self.clock = clock
        self.bucket_s = bucket_s if bucket_s is not None else max(1.0, window_s / 3600.0)
        self._buckets: deque = deque()  # [bucket_start, events, bad]
        # running totals over the live buckets: counts() is O(1) after
        # trim instead of re-summing every bucket on every scrape
        self._n = 0
        self._bad = 0

    def record(self, good: bool, now: float) -> None:
        t0 = math.floor(now / self.bucket_s) * self.bucket_s
        # fold a non-advancing stamp into the newest bucket so the
        # deque stays time-ordered (monotonic/virtual clocks only move
        # forward; this guards the degenerate case anyway)
        if self._buckets and self._buckets[-1][0] >= t0:
            b = self._buckets[-1]
        else:
            self._buckets.append([t0, 0, 0])
            b = self._buckets[-1]
        b[1] += 1
        self._n += 1
        if not good:
            b[2] += 1
            self._bad += 1
        self._trim(now)

    def _trim(self, now: float) -> None:
        while self._buckets and now - self._buckets[0][0] > self.window_s:
            _, n, bad = self._buckets.popleft()
            self._n -= n
            self._bad -= bad

    def counts(self) -> Tuple[int, int]:
        """(events, bad) over the live window."""
        self._trim(self.clock())
        return self._n, self._bad


class SLOMonitor:
    """Per-model SLO evaluation: feed one ``observe`` per finished
    request (the scheduler's trace-done hook), read burn rates,
    breaches, and the ``/v2/slo`` snapshot.

    Thread-safety: observed from the loop/watchdog threads, read from
    HTTP scrape threads — one lock around the windows.
    """

    def __init__(
        self,
        objectives: Optional[Sequence[SLObjective]] = None,
        clock: Callable[[], float] = time.monotonic,
        fast_window_s: float = 300.0,
        slow_window_s: float = 3600.0,
        availability_skip: Sequence[str] = ("ShuttingDownError",),
    ):
        self.objectives: Tuple[SLObjective, ...] = tuple(
            objectives if objectives is not None else DEFAULT_OBJECTIVES
        )
        names = [o.name for o in self.objectives]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate objective names: {names}")
        self.clock = clock
        self.fast_window_s = fast_window_s
        self.slow_window_s = slow_window_s
        # outcomes that are neither good nor bad for availability:
        # client cancellation and shutdown drain settle requests with
        # ShuttingDownError — client/operator behavior, not a service
        # fault, and must not be able to burn the error budget
        self.availability_skip = frozenset(availability_skip)
        self._lock = threading.Lock()
        # guarded-by: _lock
        self._windows: Dict[str, Dict[str, _BurnWindow]] = {
            o.name: {
                "fast": _BurnWindow(fast_window_s, clock),
                "slow": _BurnWindow(slow_window_s, clock),
            }
            for o in self.objectives
        }
        self.observed = 0  # cumulative requests folded in; guarded-by: _lock

    # ------------------------------------------------------------ feeding
    def observe(
        self,
        outcome: str,
        ttft_s: Optional[float] = None,
        tpot_s: Optional[float] = None,
    ) -> None:
        """Fold one finished request in. ``outcome`` is the trace
        outcome ("completed" or an error type name); latency metrics
        with no sample (e.g. TPOT on a 1-token stream) skip their
        objectives rather than count as violations."""
        now = self.clock()
        with self._lock:
            self.observed += 1
            for obj in self.objectives:
                if obj.metric == "availability":
                    if outcome in self.availability_skip:
                        continue
                    good = outcome == "completed"
                elif obj.metric == "ttft":
                    if ttft_s is None:
                        continue
                    good = ttft_s <= obj.threshold_s
                else:  # tpot
                    if tpot_s is None:
                        continue
                    good = tpot_s <= obj.threshold_s
                w = self._windows[obj.name]
                w["fast"].record(good, now)
                w["slow"].record(good, now)

    # ------------------------------------------------------------ reading
    def burn_rate(self, name: str, window: str = "fast") -> float:
        """Error-budget burn rate over the named window (0 when the
        window holds no events)."""
        with self._lock:
            events, bad = self._windows[name][window].counts()
        if events == 0:
            return 0.0
        obj = next(o for o in self.objectives if o.name == name)
        budget = max(1e-9, 1.0 - obj.target)
        return (bad / events) / budget

    def breaching(self) -> List[str]:
        """Objectives whose fast AND slow windows both burn at or above
        their threshold (with enough fast-window evidence)."""
        out = []
        for obj in self.objectives:
            with self._lock:
                f_events, f_bad = self._windows[obj.name]["fast"].counts()
                s_events, s_bad = self._windows[obj.name]["slow"].counts()
            if f_events < obj.min_events or s_events == 0:
                continue
            budget = max(1e-9, 1.0 - obj.target)
            fast = (f_bad / f_events) / budget
            slow = (s_bad / s_events) / budget
            if fast >= obj.burn_threshold and slow >= obj.burn_threshold:
                out.append(obj.name)
        return out

    def healthy(self) -> bool:
        return not self.breaching()

    def snapshot(self) -> Dict:
        """The ``GET /v2/slo`` payload."""
        breaching = set(self.breaching())
        objectives = []
        for obj in self.objectives:
            with self._lock:
                f_events, f_bad = self._windows[obj.name]["fast"].counts()
                s_events, s_bad = self._windows[obj.name]["slow"].counts()
            budget = max(1e-9, 1.0 - obj.target)
            objectives.append({
                "name": obj.name,
                "metric": obj.metric,
                "target": obj.target,
                "threshold_s": obj.threshold_s,
                "burn_threshold": obj.burn_threshold,
                "fast": {
                    "window_s": self.fast_window_s,
                    "events": f_events,
                    "bad": f_bad,
                    "burn_rate": (f_bad / f_events) / budget if f_events else 0.0,
                },
                "slow": {
                    "window_s": self.slow_window_s,
                    "events": s_events,
                    "bad": s_bad,
                    "burn_rate": (s_bad / s_events) / budget if s_events else 0.0,
                },
                "breaching": obj.name in breaching,
            })
        with self._lock:
            observed = self.observed
        return {
            "observed": observed,
            "healthy": not breaching,
            "breaching": sorted(breaching),
            "objectives": objectives,
        }

    def register_gauges(self, stats) -> None:
        """``flexflow_serving_slo_*`` series: per-objective fast/slow
        burn rates + a 0/1 breaching flag, plus the monitor-wide
        breach count."""
        for obj in self.objectives:
            name = obj.name
            stats.add_gauge(
                f"slo_{name}_burn_fast", lambda n=name: self.burn_rate(n, "fast")
            )
            stats.add_gauge(
                f"slo_{name}_burn_slow", lambda n=name: self.burn_rate(n, "slow")
            )
            stats.add_gauge(
                f"slo_{name}_breaching",
                lambda n=name: 1 if n in self.breaching() else 0,
            )
        stats.add_gauge("slo_breaching_total", lambda: len(self.breaching()))
