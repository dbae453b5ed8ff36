#!/usr/bin/env python
"""simfleet: the fleet digital twin's CLI over the port's twin
(``flexflow_tpu_torch/sim``; port of the JAX package's
``tools/simfleet.py``).

Answers capacity questions offline — replays a recorded loadgen
schedule against virtual fleets whose control plane (AIMD limiter,
degrade ladder, autoscale advisor) is the real serving code on a
virtual clock, with per-step costs from a calibrated source instead of
wall clocks. Deterministic: the same schedule + cost table + scenario
always produce byte-identical event traces and reports.

  python -m flexflow_tpu_torch.tools.simfleet demo [--out FILE]
      The usefulness demo: replay the canned overload storm (the
      package's copy of tests/data/storm_schedule.json) against 1-4
      unified replicas and a 1 prefill + 1 decode disaggregated pair on
      a pinned demo cost table: disagg beats unified at equal engine
      count on storm TTFT p95, and the shed rate becomes nonzero as
      replicas shrink.

  python -m flexflow_tpu_torch.tools.simfleet sweep --costs ledger.json
      [--schedule S.json] [--model NAME] [--expect-device KIND]
      [--demo-costs] [--arms unified,disagg] [--replicas 1,2,3,4]
      [--prefill N --decode N] [--slots N] [--max-queue N]
      [--num-blocks N] [--traffic-x 2.0]
      [--target-ttft-p99 0.5] [--target-shed 0.0] [--out FILE]
      "How many replicas for this SLO at N x traffic": run the scenario
      grid and rank configurations that meet the targets (fewest engines
      first). Costs come from an ``obsreport predict --export`` ledger
      snapshot (measured p50s; cross-device loads are refused: a card's
      export is tagged ``h100``) or the pinned demo table.

  python -m flexflow_tpu_torch.tools.simfleet tp ...
      "What TP degree per pool": needs the tensor-parallel serving
      layout search, which the port does not have yet (ROADMAP.md
      queue 1, item 4); it raises NotImplementedError.

  python -m flexflow_tpu_torch.tools.simfleet tune [--out FILE]
      Sweep OverloadConfig's degrade/admission thresholds in the twin on
      the storm at several traffic multipliers and check the serving
      defaults are the winner.

  python -m flexflow_tpu_torch.tools.simfleet simcheck [--bound 0.06]
      [--device cpu] [--out FILE]
      The honesty gate: replay the canned storm BOTH in the twin (tick
      mode, mirroring loadgen.drive_virtual) and live against a real
      in-process engine (on the GPU unless ``--device cpu``) on a
      virtual clock, then fail if sim-vs-live TTFT p50/p99 diverge
      beyond the pinned bound. The twin's percentiles are registered in
      the engine's PredictionLedger under ``sim:`` keys and paired with
      the live measurements, and the gate asserts they appear on GET
      /v2/debug/predictions with sim provenance.

Default outputs go to ``torch_tools_out/``.
"""
from __future__ import annotations

import argparse
import json
import os
import urllib.request

from flexflow_tpu_torch.serving.overload import OverloadConfig
from flexflow_tpu_torch.sim import Scenario, SimCosts, run_scenario, sweep
from flexflow_tpu_torch.sim.report import SIM_PROVENANCE, measure_live
from flexflow_tpu_torch.tools._common import STORM_SCHEDULE, Clock, out_path, pct, seeded_params

# chaoscheck's overload-storm scheduler knobs: the simcheck gate and the
# live drive must run the SAME control plane or divergence is config
# skew, not twin error
STORM_OVERLOAD = dict(
    limiter_interval_s=0.2, min_limit=14, min_queue_frac=0.2,
    up_hold_s=0.1, down_hold_s=0.5,
)
STORM_DT = 0.02
STORM_SLOTS = 3
STORM_MAX_QUEUE = 16
# pinned sim-vs-live divergence bound on the canned storm: measured
# exact agreement (0.000s on TTFT p50/p95/p99) at pin time; three
# virtual ticks of slack absorbs benign quantization drift while still
# failing on any real semantic change in either side
DEFAULT_BOUND_S = 0.06
# default output files of the commands that write one (in torch_tools_out/)
DEFAULT_OUT = {"tune": "SIM_TUNE.json", "simcheck": "SIM_REPORT.json"}


def demo_costs() -> SimCosts:
    """The pinned demo cost table (the JAX tool's, device tag
    ``v5e-sim`` included): fast small-bucket prefill, decode-dominated
    steady state — not a calibration artifact, and labeled as such."""
    return SimCosts(
        device_kind="v5e-sim",
        prefill_s={8: 0.004, 128: 0.045},
        decode_s=0.030,
        kv_swap_in_s=0.002,
        handoff_per_block_s=0.0005,
        source="pinned demo table (simfleet demo)",
    )


def _print_ranked(out: dict) -> None:
    print(f"targets: {out['targets']}")
    print("rank scenario        arm      eng  ttft_p50   ttft_p95   "
          "ttft_p99   shed    feasible")
    for r in out["ranked"]:
        print(
            f"{r['rank']:>4} {r['scenario']:<15} {r['arm']:<8} "
            f"{r['engines']:>3}  "
            f"{(r['ttft_p50_s'] or 0) * 1e3:7.1f}ms "
            f"{(r['ttft_p95_s'] or 0) * 1e3:8.1f}ms "
            f"{(r['ttft_p99_s'] or 0) * 1e3:8.1f}ms "
            f"{r['shed_rate']:6.3f}  {'yes' if r['feasible'] else 'NO'}"
        )


def _write(doc: dict, path: str) -> None:
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {path}")


# ------------------------------------------------------------------ demo
def cmd_demo(args) -> int:
    costs = demo_costs()
    scens = [
        Scenario(name=f"unified-x{n}", arm="unified", replicas=n)
        for n in (1, 2, 3, 4)
    ]
    scens.append(
        Scenario(name="disagg-1p1d", arm="disagg", n_prefill=1, n_decode=1)
    )
    out = sweep(args.schedule, costs, scens, target_ttft_p99_s=1.0)
    _print_ranked(out)
    rep = {r["scenario"]: r for r in out["ranked"]}
    disagg = rep["disagg-1p1d"]
    uni2 = rep["unified-x2"]
    ok = True
    if not disagg["ttft_p95_s"] < uni2["ttft_p95_s"]:
        print("FAIL: disagg did not beat unified x2 on storm TTFT p95")
        ok = False
    sheds = [rep[f"unified-x{n}"]["shed_rate"] for n in (4, 3, 2, 1)]
    if not (sheds[-1] > 0.0 and all(s == 0.0 for s in sheds[:-1])):
        print(f"FAIL: no clean capacity knee (shed by replicas 4..1: {sheds})")
        ok = False
    if ok:
        print("demo facts hold: disagg TTFT win + capacity knee at 1 replica")
    if args.out:
        _write(out, args.out)
    return 0 if ok else 1


# ----------------------------------------------------------------- sweep
def _load_costs(args) -> SimCosts:
    if args.demo_costs:
        return demo_costs()
    if not args.costs:
        raise SystemExit(
            "pass --costs ledger.json (python -m "
            "flexflow_tpu_torch.tools.obsreport predict --export) or --demo-costs"
        )
    return SimCosts.from_ledger_export(
        args.costs, model=args.model or None,
        expect_device=args.expect_device or None,
    )


def _grid(args) -> list:
    scens = []
    arms = [a.strip() for a in args.arms.split(",") if a.strip()]
    replicas = [int(n) for n in args.replicas.split(",")]
    for arm in arms:
        if arm == "unified":
            for n in replicas:
                scens.append(Scenario(
                    name=f"unified-x{n}", arm="unified", replicas=n,
                    slots=args.slots, max_queue=args.max_queue,
                    num_blocks=args.num_blocks, traffic_x=args.traffic_x,
                ))
        elif arm == "disagg":
            scens.append(Scenario(
                name=f"disagg-{args.prefill}p{args.decode}d", arm="disagg",
                n_prefill=args.prefill, n_decode=args.decode,
                slots=args.slots, max_queue=args.max_queue,
                num_blocks=args.num_blocks, traffic_x=args.traffic_x,
            ))
        else:
            raise SystemExit(f"unknown arm {arm!r} (unified|disagg)")
    return scens


def cmd_sweep(args) -> int:
    costs = _load_costs(args)
    print(f"cost table: {costs.describe()}")
    out = sweep(
        args.schedule, costs, _grid(args),
        target_ttft_p99_s=args.target_ttft_p99,
        target_shed_rate=args.target_shed,
    )
    _print_ranked(out)
    if args.out:
        _write(out, args.out)
    return 0


# -------------------------------------------------------------------- tp
def cmd_tp(args) -> int:
    """Rank candidate TP degrees for one pool: needs the strategy
    search's tensor-parallel serving layouts (``SimCosts.from_strategy``),
    which the port does not have yet."""
    raise NotImplementedError(
        "simfleet tp needs the tensor-parallel serving layout search "
        "(search/serving_strategy.py), which is not ported yet (ROADMAP.md "
        "queue 1, item 4)")


# -------------------------------------------------------------- simcheck
def _live_storm(schedule_path: str, device=None):
    """Replay the canned storm against a real in-process engine (on
    ``device``: the GPU by default; weights seeded from 0) on a virtual
    clock — chaoscheck's overload-storm drive — and return (metrics dict,
    engine)."""
    from flexflow_tpu_torch.generation import (
        ContinuousBatchingScheduler,
        GenerationEngine,
        SamplingParams,
    )
    from flexflow_tpu_torch.tools.loadgen import drive_virtual, load_schedule, tiny_config

    cfg = tiny_config(40)
    eng = GenerationEngine(
        seeded_params(cfg), cfg,
        max_batch_slots=STORM_SLOTS, block_size=8, prompt_buckets=(8, 32, 64),
        device=device,
    )
    eng.generate([[1, 2, 3]], SamplingParams(max_new_tokens=2))  # capture the steps
    clock = Clock()
    sched = ContinuousBatchingScheduler(
        eng, clock=clock, max_queue=STORM_MAX_QUEUE,
        overload=OverloadConfig(**STORM_OVERLOAD),
    )
    schedule = load_schedule(schedule_path)
    report = drive_virtual(
        sched, schedule, clock, dt=STORM_DT, sampling_cls=SamplingParams,
    )
    ttfts = [t for d in report.per.values() for t in d["ttft_s"]]
    submitted = sum(d["submitted"] for d in report.per.values())
    shed = sum(d["shed"] for d in report.per.values())
    metrics = {
        "ttft_p50_s": pct(ttfts, 0.50),
        "ttft_p95_s": pct(ttfts, 0.95),
        "ttft_p99_s": pct(ttfts, 0.99),
        "tpot_p50_s": None,  # trace TTFT only; tpot compared informationally
        "shed_rate": shed / submitted if submitted else 0.0,
        "completed": sum(d["completed"] for d in report.per.values()),
        "submitted": submitted,
    }
    sched.stop(drain=False)
    return metrics, eng


def cmd_tune(args) -> int:
    """Sweep OverloadConfig's degrade/admission thresholds in the twin
    and rank them on the canned storm replayed at several traffic
    multipliers. The objective is baseline-relative: a candidate is
    feasible only if its worst TTFT p99 across traffic levels does not
    exceed the CURRENT serving defaults' worst p99 (tuning may not buy
    shed by regressing the latency envelope operators already get);
    feasible candidates rank by total shed, then degrade-ladder churn
    (each transition flips serving behavior mid-stream), then distance
    from the incumbent defaults — an exact metric tie must not move
    the defaults. The ranked table is checked in as SIM_TUNE.json; a
    drift-guard test pins the serving defaults in
    flexflow_tpu/serving/overload.py to the winner, so the defaults
    can only change together with re-run evidence."""
    grid_up = [float(x) for x in args.up_thresholds.split(",")]
    grid_down = [float(x) for x in args.down_thresholds.split(",")]
    grid_mqf = [float(x) for x in args.min_queue_fracs.split(",")]
    traffic = [float(x) for x in args.traffic.split(",")]
    costs = SimCosts.fixed_tick(STORM_DT)
    default = OverloadConfig()
    defaults = {
        "up_threshold": default.up_threshold,
        "down_threshold": default.down_threshold,
        "min_queue_frac": default.min_queue_frac,
    }

    def evaluate(up: float, down: float, mqf: float) -> dict:
        # only the swept fields move; everything else stays at the
        # serving defaults so the winner maps 1:1 onto them
        cfg = OverloadConfig(
            up_threshold=up, down_threshold=down, min_queue_frac=mqf,
        )
        shed_total = churn_total = 0.0
        p99_max = 0.0
        levels = {}
        for tx in traffic:
            rep = run_scenario(args.schedule, costs, Scenario(
                name=f"tune-x{tx:g}", arm="unified", replicas=1,
                slots=STORM_SLOTS, max_queue=STORM_MAX_QUEUE,
                num_blocks=25, block_size=8, overload=cfg, traffic_x=tx,
            )).render()
            churn = rep["overload"]["total"]["degrade_transitions"]
            shed_total += rep["shed_rate"]
            churn_total += churn
            p99_max = max(p99_max, rep.get("ttft_p99_s") or 0.0)
            levels[f"x{tx:g}"] = {
                "shed_rate": rep["shed_rate"],
                "ttft_p50_s": rep.get("ttft_p50_s"),
                "ttft_p99_s": rep.get("ttft_p99_s"),
                "degrade_transitions": churn,
                "completed": rep["completed"],
                "submitted": rep["submitted"],
            }
        return {
            "scenario": f"up{up:g}-down{down:g}-mqf{mqf:g}",
            "up_threshold": up,
            "down_threshold": down,
            "min_queue_frac": mqf,
            "shed_total": round(shed_total, 6),
            "ttft_p99_max_s": round(p99_max, 6),
            "degrade_transitions": int(churn_total),
            "levels": levels,
        }

    baseline = evaluate(
        defaults["up_threshold"], defaults["down_threshold"],
        defaults["min_queue_frac"],
    )
    p99_budget = baseline["ttft_p99_max_s"] + 1e-9
    rows = []
    for up in grid_up:
        for down in grid_down:
            for mqf in grid_mqf:
                r = evaluate(up, down, mqf)
                r["feasible"] = r["ttft_p99_max_s"] <= p99_budget
                r["distance_from_default"] = round(
                    abs(up - defaults["up_threshold"])
                    + abs(down - defaults["down_threshold"])
                    + abs(mqf - defaults["min_queue_frac"]), 6)
                rows.append(r)
    rows.sort(key=lambda r: (
        not r["feasible"],
        r["shed_total"],
        r["degrade_transitions"],
        r["ttft_p99_max_s"],
        r["distance_from_default"],
        r["scenario"],
    ))
    for rank, r in enumerate(rows, 1):
        r["rank"] = rank
    winner = rows[0]
    matches = all(
        abs(winner[k] - defaults[k]) < 1e-12 for k in defaults
    )
    print(f"baseline (serving defaults): shed_total "
          f"{baseline['shed_total']:.3f}  ttft_p99_max "
          f"{baseline['ttft_p99_max_s'] * 1e3:.0f}ms")
    print("rank scenario                 shed_total  p99_max  churn  ok")
    for r in rows[:10]:
        print(
            f"{r['rank']:>4} {r['scenario']:<24} {r['shed_total']:9.3f} "
            f"{r['ttft_p99_max_s'] * 1e3:7.0f}ms {r['degrade_transitions']:5d}"
            f"  {'yes' if r['feasible'] else 'NO'}"
        )
    verdict = ("MATCH" if matches else
               "DIFFER: the winner is not flexflow_tpu_torch/serving/overload.py's defaults")
    print(f"winner: {winner['scenario']}  (serving defaults {verdict})")
    out = {
        "schema": "flexflow-sim-tune-v1",
        "schedule": os.path.basename(args.schedule),
        "traffic": traffic,
        "grid": {
            "up_thresholds": grid_up,
            "down_thresholds": grid_down,
            "min_queue_fracs": grid_mqf,
        },
        "baseline": baseline,
        "ttft_p99_budget_s": round(p99_budget, 6),
        "ranked": rows,
        "winner": {k: winner[k] for k in (
            "scenario", "up_threshold", "down_threshold", "min_queue_frac",
            "shed_total", "ttft_p99_max_s", "degrade_transitions",
        )},
        "serving_defaults": defaults,
        "defaults_match_winner": matches,
    }
    if args.out:
        _write(out, args.out)
    return 0 if matches or args.allow_drift else 1


def cmd_simcheck(args) -> int:
    failures = []

    def check(cond, msg):
        if not cond:
            failures.append(msg)

    # --- the twin: tick mode, same scheduler knobs as the live drive.
    # num_blocks matches the tiny storm engine's allocator so KV
    # pressure is comparable (the live engine derives ~25 blocks from
    # its cache config).
    costs = SimCosts.fixed_tick(STORM_DT)
    scenario = Scenario(
        name="simcheck-storm", arm="unified", replicas=1,
        slots=STORM_SLOTS, max_queue=STORM_MAX_QUEUE, num_blocks=25,
        block_size=8, overload=OverloadConfig(**STORM_OVERLOAD),
    )
    sim_report = run_scenario(args.schedule, costs, scenario)
    sim = sim_report.render()
    # determinism: a second replay must be byte-identical
    sim2 = run_scenario(args.schedule, costs, scenario).render()
    check(sim == sim2, "twin is nondeterministic: two replays differ")
    check(
        sim["trace_digest"] == sim2["trace_digest"],
        "twin event-trace digests differ between replays",
    )

    # --- the live storm (real engine, virtual clock)
    live, eng = _live_storm(args.schedule, device=args.device)

    # --- honesty loop: the twin's percentiles become ledger
    # predictions on the live engine, paired with the live measurements
    keys = sim_report.register_predictions(
        eng.ledger, prefix="storm", alarm=False,
    )
    paired = set(measure_live(eng.ledger, prefix="storm", live_metrics=live))
    check(keys, "twin registered no sim: predictions")
    check(paired, "live storm paired no sim: predictions")

    # the pairs must be visible where operators look: the server's
    # debug predictions endpoint, tagged with sim provenance
    from flexflow_tpu_torch.serving import GenerationModel, InferenceServer

    srv = InferenceServer(port=0)
    srv.register_generation(GenerationModel(eng, name="lm"))
    srv.start()
    try:
        with urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/v2/debug/predictions", timeout=30
        ) as r:
            payload = json.loads(r.read())
    finally:
        srv.stop()
    entries = {
        e["key"]: e
        for e in payload.get("models", {}).get("lm", {}).get("entries", [])
    }
    for key in keys:
        e = entries.get(key)
        check(e is not None, f"{key} missing from GET /v2/debug/predictions")
        if e is None:
            continue
        check(
            e.get("provenance") == SIM_PROVENANCE,
            f"{key} provenance is {e.get('provenance')!r}, "
            f"not {SIM_PROVENANCE!r}",
        )
        if key in paired:
            check(
                e.get("pairs", 0) > 0,
                f"{key} has no (predicted, measured) pair",
            )

    # --- the divergence gate
    divergence = {}
    for metric in ("ttft_p50_s", "ttft_p99_s"):
        s, lv = sim.get(metric), live.get(metric)
        check(s is not None, f"twin produced no {metric}")
        check(lv is not None, f"live storm produced no {metric}")
        if s is None or lv is None:
            continue
        diff = abs(s - lv)
        divergence[metric] = {"sim": s, "live": lv, "abs_diff_s": diff}
        check(
            diff <= args.bound,
            f"sim-vs-live divergence on {metric}: |{s:.4f} - {lv:.4f}| = "
            f"{diff:.4f}s > bound {args.bound}s",
        )

    doc = {
        "schema": "flexflow-sim-report-v1",
        "bound_s": args.bound,
        "divergence": divergence,
        "sim": sim,
        "live": live,
        "ledger_keys": keys,
        "failures": failures,
        "ok": not failures,
    }
    if args.out:
        _write(doc, args.out)
    for metric, d in divergence.items():
        print(
            f"{metric}: sim={d['sim']:.4f}s live={d['live']:.4f}s "
            f"diff={d['abs_diff_s']:.4f}s (bound {args.bound}s)"
        )
    print(
        f"shed_rate: sim={sim['shed_rate']:.3f} live={live['shed_rate']:.3f}"
        " (informational)"
    )
    if failures:
        print("simcheck FAILED:")
        for f in failures:
            print(f"  - {f}")
        return 1
    print(f"simcheck OK: twin within {args.bound}s of the live storm, "
          f"{len(keys)} sim: ledger pairs visible with sim provenance")
    return 0


# ------------------------------------------------------------------ main
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = ap.add_subparsers(dest="command", required=True)

    d = sub.add_parser("demo", help="checked-in usefulness demo")
    d.add_argument("--schedule", default=STORM_SCHEDULE)
    d.add_argument("--out", default="")
    d.set_defaults(fn=cmd_demo)

    s = sub.add_parser("sweep", help="scenario grid -> ranked configs")
    s.add_argument("--schedule", default=STORM_SCHEDULE)
    s.add_argument("--costs", default="",
                   help="obsreport predict --export snapshot")
    s.add_argument("--model", default="")
    s.add_argument("--expect-device", default="")
    s.add_argument("--demo-costs", action="store_true")
    s.add_argument("--arms", default="unified")
    s.add_argument("--replicas", default="1,2,3,4")
    s.add_argument("--prefill", type=int, default=1)
    s.add_argument("--decode", type=int, default=1)
    s.add_argument("--slots", type=int, default=4)
    s.add_argument("--max-queue", type=int, default=16)
    s.add_argument("--num-blocks", type=int, default=64)
    s.add_argument("--traffic-x", type=float, default=1.0)
    s.add_argument("--target-ttft-p99", type=float, default=None)
    s.add_argument("--target-shed", type=float, default=0.0)
    s.add_argument("--out", default="")
    s.set_defaults(fn=cmd_sweep)

    t = sub.add_parser("tp", help="rank TP degrees for one pool")
    t.add_argument("--schedule", default=STORM_SCHEDULE)
    t.add_argument("--mesh-devices", type=int, required=True)
    t.add_argument("--tp", default="1,2,4")
    t.add_argument("--layers", type=int, default=2)
    t.add_argument("--hidden", type=int, default=256)
    t.add_argument("--heads", type=int, default=8)
    t.add_argument("--vocab", type=int, default=512)
    t.add_argument("--buckets", type=int, nargs="+", default=[32, 128])
    t.add_argument("--replicas-per", type=int, default=1)
    t.add_argument("--slots", type=int, default=4)
    t.add_argument("--max-queue", type=int, default=16)
    t.add_argument("--num-blocks", type=int, default=64)
    t.add_argument("--traffic-x", type=float, default=1.0)
    t.add_argument("--out", default="")
    t.set_defaults(fn=cmd_tp)

    u = sub.add_parser(
        "tune", help="sweep OverloadConfig thresholds -> SIM_TUNE.json")
    u.add_argument("--schedule", default=STORM_SCHEDULE)
    u.add_argument("--traffic", default="0.5,0.75,1.0",
                   help="comma-separated traffic multipliers; metrics "
                        "aggregate across all of them")
    u.add_argument("--up-thresholds", default="0.7,0.8,0.9")
    u.add_argument("--down-thresholds", default="0.2,0.3,0.4")
    u.add_argument("--min-queue-fracs", default="0.0625,0.125,0.25")
    u.add_argument("--out", default=None)
    u.add_argument("--allow-drift", action="store_true",
                   help="exit 0 even when the winner differs from the "
                        "serving defaults (exploration runs)")
    u.set_defaults(fn=cmd_tune)

    c = sub.add_parser("simcheck", help="sim-vs-live divergence gate (CI)")
    c.add_argument("--schedule", default=STORM_SCHEDULE)
    c.add_argument("--bound", type=float, default=DEFAULT_BOUND_S)
    c.add_argument("--device", default=None,
                   help="the live storm's engine device (default: the GPU; 'cpu')")
    c.add_argument("--out", default=None)
    c.set_defaults(fn=cmd_simcheck)

    args = ap.parse_args(argv)
    if args.command in DEFAULT_OUT and args.out is None:
        args.out = out_path(DEFAULT_OUT[args.command])
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
