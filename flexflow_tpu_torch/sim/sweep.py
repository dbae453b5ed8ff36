"""Scenario runner + sweep ranking: the twin's answer surface.

``run_scenario`` replays one arrival schedule against one fleet
configuration and returns a :class:`~flexflow_tpu_torch.sim.report.SimReport`;
``sweep`` runs a scenario list and ranks the configurations that meet
the operator's targets (TTFT p99 bound, shed-rate bound) by engine
cost then latency — "how many replicas do I need for this SLO at N×
traffic" becomes an offline table instead of a load test.

Schedules are ``tools/loadgen.py`` arrivals: pass the live objects, a
parsed ``flexflow-load-schedule-v1`` document, or a path to one (the
``--record-schedule`` artifact) — the same canned storm drives live
runs, A/B gates, and the twin.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence, Union

from ..serving.overload import OverloadConfig
from .costs import SimCosts
from .events import EventLoop
from .report import SimReport
from .virtual import SimRequest, VirtualFleet

SCHEDULE_SCHEMA = "flexflow-load-schedule-v1"


@dataclasses.dataclass
class Scenario:
    """One fleet configuration to simulate."""

    name: str
    arm: str = "unified"            # "unified" | "disagg"
    replicas: int = 2               # unified pool width
    n_prefill: int = 1              # disagg pool widths
    n_decode: int = 1
    slots: int = 4
    max_queue: int = 16
    num_blocks: int = 64
    block_size: int = 8
    overload: Optional[OverloadConfig] = None
    poll_s: float = 0.05
    traffic_x: float = 1.0          # arrival-time compression (N x rate)

    def engines(self) -> int:
        return (
            self.replicas if self.arm == "unified"
            else self.n_prefill + self.n_decode
        )

    def describe(self) -> Dict:
        out = {
            "name": self.name,
            "arm": self.arm,
            "engines": self.engines(),
            "slots": self.slots,
            "max_queue": self.max_queue,
            "num_blocks": self.num_blocks,
            "traffic_x": self.traffic_x,
        }
        if self.arm == "unified":
            out["replicas"] = self.replicas
        else:
            out["n_prefill"] = self.n_prefill
            out["n_decode"] = self.n_decode
        if self.overload is not None:
            cfg = self.overload
            out["overload"] = {
                "limiter_interval_s": cfg.limiter_interval_s,
                "min_limit": cfg.min_limit,
                "min_queue_frac": cfg.min_queue_frac,
                "hard_queue_frac": cfg.hard_queue_frac,
                "up_threshold": cfg.up_threshold,
                "up_hold_s": cfg.up_hold_s,
                "down_threshold": cfg.down_threshold,
                "down_hold_s": cfg.down_hold_s,
                "autoscale_up_hold_s": cfg.autoscale_up_hold_s,
                "autoscale_down_hold_s": cfg.autoscale_down_hold_s,
            }
        return out


# ------------------------------------------------------------- schedules
@dataclasses.dataclass(frozen=True)
class ArrivalSpec:
    """Schedule-row shape the sim consumes (a loadgen Arrival without
    the token ids — the twin prices prompts by length)."""

    t: float
    priority: str
    prompt_len: int
    max_new: int
    deadline_s: Optional[float] = None


def coerce_schedule(schedule) -> List[ArrivalSpec]:
    """Accept loadgen ``Arrival`` objects, schedule-document dicts, a
    path to a recorded schedule, or ArrivalSpec rows; return sorted
    specs."""
    if isinstance(schedule, str):
        schedule = load_schedule(schedule)
    if isinstance(schedule, dict):
        if schedule.get("schema") != SCHEDULE_SCHEMA:
            raise ValueError(
                f"not a load schedule (schema={schedule.get('schema')!r})"
            )
        schedule = schedule.get("arrivals", [])
    specs: List[ArrivalSpec] = []
    for a in schedule:
        if isinstance(a, ArrivalSpec):
            specs.append(a)
            continue
        get = (lambda k, d=None: a.get(k, d)) if isinstance(a, dict) \
            else (lambda k, d=None: getattr(a, k, d))
        prompt = get("prompt")
        plen = len(prompt) if prompt is not None else int(get("prompt_len", 1))
        specs.append(ArrivalSpec(
            t=float(get("t", 0.0)),
            priority=str(get("priority", "standard")),
            prompt_len=plen,
            max_new=int(get("max_new", 1)),
            deadline_s=get("deadline_s"),
        ))
    specs.sort(key=lambda s: (s.t,))
    return specs


def load_schedule(path: str) -> List[Dict]:
    """Read a ``flexflow-load-schedule-v1`` document (the
    ``loadgen --record-schedule`` artifact) without importing the
    tools package."""
    with open(path) as f:
        doc = json.load(f)
    if doc.get("schema") != SCHEDULE_SCHEMA:
        raise ValueError(
            f"{path}: not a load schedule (schema={doc.get('schema')!r}); "
            "record one with: tools/loadgen.py --record-schedule FILE"
        )
    return doc["arrivals"]


def scale_schedule(specs: Sequence[ArrivalSpec],
                   x: float) -> List[ArrivalSpec]:
    """N x traffic: compress arrival times by ``x`` (the same requests,
    offered ``x`` times faster — the ROADMAP's "at N x traffic"
    question without re-drawing the workload)."""
    if x <= 0:
        raise ValueError(f"traffic multiplier must be positive, got {x}")
    if x == 1.0:
        return list(specs)
    return [dataclasses.replace(s, t=s.t / x) for s in specs]


# --------------------------------------------------------------- running
def run_scenario(
    schedule,
    costs: SimCosts,
    scenario: Scenario,
) -> SimReport:
    """Replay ``schedule`` against one virtual fleet. Deterministic:
    the only inputs are the schedule, the cost table, and the scenario
    — two calls return byte-identical event traces and reports."""
    specs = scale_schedule(coerce_schedule(schedule), scenario.traffic_x)
    duration = specs[-1].t if specs else 0.0
    loop = EventLoop()
    fleet = VirtualFleet(
        loop=loop, costs=costs, arm=scenario.arm,
        replicas=scenario.replicas, n_prefill=scenario.n_prefill,
        n_decode=scenario.n_decode, slots=scenario.slots,
        max_queue=scenario.max_queue, num_blocks=scenario.num_blocks,
        block_size=scenario.block_size, overload=scenario.overload,
        poll_s=scenario.poll_s, name=scenario.name,
    )
    requests: List[SimRequest] = [
        SimRequest.from_arrival(s, i) for i, s in enumerate(specs)
    ]
    submitted = [0]  # arrival cursor, shared with the poll terminator
    fleet.more_arrivals = lambda: submitted[0] < len(requests)

    if costs.tick_s is not None:
        dt = costs.tick_s

        def tick(t: float) -> None:
            # drive_virtual's loop as events: submit the arrivals now
            # due, step every replica once, advance by dt — arrival
            # times quantize to tick boundaries exactly like the live
            # virtual-clock drive
            while submitted[0] < len(requests) and \
                    requests[submitted[0]].t <= t + 1e-12:
                fleet.submit(requests[submitted[0]], t)
                submitted[0] += 1
            fleet.step_all(t)
            if submitted[0] < len(requests) or fleet.outstanding > 0:
                loop.after(dt, "tick", tick)

        loop.at(0.0, "tick", tick)
    else:
        for req in requests:
            def arrive(t: float, r: SimRequest = req) -> None:
                submitted[0] += 1
                fleet.submit(r, t)

            loop.at(req.t, "arrival", arrive, detail=req.rid)
    fleet.start_polling()
    loop.run()
    for req in requests:
        if req.outcome is None:
            req.outcome = "failed"  # starved in-sim: surface, don't hide
    return SimReport(
        requests=requests, fleet=fleet, loop=loop, costs=costs,
        duration_s=duration, scenario=scenario.describe(),
    )


# --------------------------------------------------------------- ranking
def sweep(
    schedule,
    costs: SimCosts,
    scenarios: Sequence[Scenario],
    *,
    target_ttft_p99_s: Optional[float] = None,
    target_shed_rate: float = 0.0,
) -> Dict:
    """Run every scenario and rank: configurations that meet the
    targets first (fewest engines, then lowest TTFT p99), then the
    misses (closest first). Returns the ranked rows plus full reports
    keyed by scenario name."""
    rows: List[Dict] = []
    reports: Dict[str, Dict] = {}
    for sc in scenarios:
        rep = run_scenario(schedule, costs, sc).render()
        reports[sc.name] = rep
        ttft_p99 = rep.get("ttft_p99_s")
        shed = rep.get("shed_rate", 0.0)
        feasible = shed <= target_shed_rate + 1e-12 and (
            target_ttft_p99_s is None
            or (ttft_p99 is not None and ttft_p99 <= target_ttft_p99_s)
        )
        rows.append({
            "scenario": sc.name,
            "arm": rep["arm"],
            "engines": rep["engines"],
            "traffic_x": sc.traffic_x,
            "feasible": feasible,
            "ttft_p50_s": rep.get("ttft_p50_s"),
            "ttft_p95_s": rep.get("ttft_p95_s"),
            "ttft_p99_s": ttft_p99,
            "tpot_p50_s": rep.get("tpot_p50_s"),
            "shed_rate": shed,
            "goodput_tokens_per_s": rep.get("goodput_tokens_per_s"),
            "max_degrade_level":
                rep["overload"]["total"].get("max_degrade_level", 0),
            "autoscale_max_signal": rep["autoscale"]["max_signal"],
        })
    big = 1e18
    rows.sort(key=lambda r: (
        not r["feasible"],
        r["engines"] if r["feasible"] else 0,
        r["ttft_p99_s"] if r["ttft_p99_s"] is not None else big,
        r["shed_rate"],
        r["scenario"],
    ))
    for i, r in enumerate(rows):
        r["rank"] = i + 1
    return {
        "targets": {
            "ttft_p99_s": target_ttft_p99_s,
            "shed_rate": target_shed_rate,
        },
        "ranked": rows,
        "reports": reports,
    }
