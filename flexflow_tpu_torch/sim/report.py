"""Per-run report for the fleet digital twin, plus the honesty hooks.

The report answers the capacity questions (TTFT/TPOT percentiles,
goodput, shed rates per priority, overload activations, autoscale
signal trace) and carries the determinism fingerprint (event count +
trace digest). The honesty hooks close the loop with the truth
telemetry: :meth:`SimReport.register_predictions` writes the twin's
latency percentiles into a PredictionLedger under ``sim:`` keys with
sim provenance, and :func:`measure_live` pairs them with a live run's
measurements — so a lying twin shows up on ``GET
/v2/debug/predictions`` (and in drift alarms) exactly like a lying
roofline.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

from .costs import SimCosts
from .events import EventLoop
from .virtual import SimRequest, VirtualFleet

SIM_PROVENANCE = "fleet digital twin (discrete-event sim)"
PRIORITIES = ("interactive", "standard", "best_effort")
# the percentile keys the honesty loop pairs between sim and live runs
METRIC_KEYS = ("ttft_p50_s", "ttft_p95_s", "ttft_p99_s", "tpot_p50_s")


def _pct(xs: Sequence[float], p: float) -> Optional[float]:
    # nearest-rank, the repo-wide percentile rule (serving.stats /
    # loadgen agree), so sim and live percentiles are comparable
    if not xs:
        return None
    xs = sorted(xs)
    return xs[min(len(xs) - 1, math.ceil(p * len(xs)) - 1)]


class SimReport:
    """One simulated scenario's outcome."""

    def __init__(
        self,
        *,
        requests: List[SimRequest],
        fleet: VirtualFleet,
        loop: EventLoop,
        costs: SimCosts,
        duration_s: float,
        scenario: Optional[Dict] = None,
    ):
        self.requests = requests
        self.fleet = fleet
        self.loop = loop
        self.costs = costs
        self.duration_s = float(duration_s)
        self.scenario = dict(scenario or {})

    # ------------------------------------------------------------- metrics
    def completed(self) -> List[SimRequest]:
        return [r for r in self.requests if r.outcome == "completed"]

    def ttft_values(self) -> List[float]:
        return [r.ttft_s() for r in self.completed() if r.ttft_s() is not None]

    def tpot_values(self) -> List[float]:
        return [r.tpot_s() for r in self.completed() if r.tpot_s() is not None]

    def metrics(self) -> Dict[str, Optional[float]]:
        ttfts = self.ttft_values()
        return {
            "ttft_p50_s": _pct(ttfts, 0.50),
            "ttft_p95_s": _pct(ttfts, 0.95),
            "ttft_p99_s": _pct(ttfts, 0.99),
            "tpot_p50_s": _pct(self.tpot_values(), 0.50),
        }

    def shed_rate(self) -> float:
        n = len(self.requests)
        return (
            sum(1 for r in self.requests if r.outcome == "shed") / n
            if n else 0.0
        )

    def render(self) -> Dict:
        per: Dict[str, Dict] = {}
        for p in PRIORITIES:
            rs = [r for r in self.requests if r.priority == p]
            ttfts = [
                r.ttft_s() for r in rs
                if r.outcome == "completed" and r.ttft_s() is not None
            ]
            per[p] = {
                "submitted": len(rs),
                "completed": sum(1 for r in rs if r.outcome == "completed"),
                "shed": sum(1 for r in rs if r.outcome == "shed"),
                "expired": sum(1 for r in rs if r.outcome == "expired"),
                "failed": sum(1 for r in rs if r.outcome == "failed"),
                "tokens": sum(r.tokens for r in rs),
                "ttft_p50_s": _pct(ttfts, 0.50),
                "ttft_p95_s": _pct(ttfts, 0.95),
            }
        tokens = sum(r.tokens for r in self.requests)
        good = sum(r.tokens for r in self.completed())
        makespan = max(
            [r.t_finish for r in self.requests if r.t_finish is not None]
            or [self.duration_s]
        )
        out = {
            "mode": "sim",
            "arm": self.fleet.arm,
            "engines": self.fleet.engines(),
            "duration_s": self.duration_s,
            "makespan_s": makespan,
            "submitted": len(self.requests),
            "completed": len(self.completed()),
            "shed_rate": self.shed_rate(),
            "tokens_per_s": tokens / max(1e-9, self.duration_s),
            "goodput_tokens_per_s": good / max(1e-9, self.duration_s),
            "per_priority": per,
            "overload": self.fleet.activations(),
            "autoscale": self.fleet.autoscale_summary(),
            "costs": self.costs.describe(),
            "events": self.loop.events_run,
            "trace_digest": self.loop.trace_digest(),
        }
        out.update(self.metrics())
        if self.scenario:
            out["scenario"] = self.scenario
        return out

    # ------------------------------------------------------------- honesty
    def register_predictions(self, ledger, *, prefix: str,
                             alarm: bool = True) -> List[str]:
        """Write the twin's percentile predictions into ``ledger``
        under ``sim:{prefix}:{metric}`` with sim provenance; a live
        replay of the same scenario then :func:`measure_live`-pairs
        them, and drift telemetry flags a lying twin. Returns the keys
        registered."""
        keys: List[str] = []
        for metric, value in self.metrics().items():
            if value is None:
                continue
            key = f"sim:{prefix}:{metric}"
            ledger.predict(
                key, value,
                label=f"sim {self.fleet.arm} {metric}",
                provenance=SIM_PROVENANCE,
                alarm=alarm,
            )
            keys.append(key)
        return keys


def measure_live(ledger, *, prefix: str,
                 live_metrics: Dict[str, Optional[float]]) -> List[str]:
    """Pair a live run's measured percentiles with the twin's
    registered ``sim:`` predictions (keys that were never predicted
    are skipped — the ledger would count them as unpredicted work,
    which is drift noise, not twin error)."""
    keys: List[str] = []
    for metric in METRIC_KEYS:
        value = live_metrics.get(metric)
        if value is None:
            continue
        key = f"sim:{prefix}:{metric}"
        ledger.measure(key, value)
        keys.append(key)
    return keys
