"""The serving tools' speed gates on the card, at their own defaults.

    PYTHONPATH=. python3 <this file> [--out DIR]

Runs each of genbench's A/B modes (``--speculate``, ``--shared-prefix``,
``--overlap``, ``--constrained``, ``--durable``, ``--trace-out``) and
loadgen's ``--disagg-ab`` once, each as its own process with the tool's
default geometry and gates (the JAX tools' defaults), and prints one line
per mode: the exit code, the gated numbers beside their defaults, and the
mode's seconds. A gate that fails is a finding, not an error: the probe
exits 0 whatever the modes return, and 1 only when a mode crashed
without writing its report. Prints the card's name and power limit
first. Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

# mode -> (extra argv, the report's gated keys with their defaults)
GENBENCH = {
    "speculate": (["--speculate"], {"tokens_per_step_speedup": ">= 1.5"}),
    "shared_prefix": (["--shared-prefix"], {"ttft_p50_improvement": ">= 2.0",
                                            "prefill_reuse_ratio": ">= 0.5"}),
    "overlap": (["--overlap"], {"tokens_per_s_ratio": ">= 0.9",
                                "host_s_per_hot_step_off": "> on",
                                "host_s_per_hot_step_on": "< off"}),
    "constrained": (["--constrained"], {"tokens_per_s_ratio": ">= 0.97"}),
    "durable": (["--durable"], {"tokens_per_s_ratio": ">= 0.97"}),
    "trace_overhead": (["--trace-out", "{dir}/trace.json"], {"tracing_overhead": "<= 0.03",
                                                             "journey_overhead_pct": "<= 0.03"}),
}
DISAGG = {"ttft_p95_ratio": ">= 1.0", "tpot_p50_ratio": ">= 1.0"}


def run(argv, timeout: int) -> tuple:
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m"] + argv, capture_output=True, text=True,
                          timeout=timeout)
    fails = [ln for ln in proc.stderr.splitlines() if ln.startswith("FAIL")]
    return proc.returncode, time.perf_counter() - t0, fails, proc.stderr[-2000:]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="", help="keep the reports here (default: a temporary dir)")
    args = ap.parse_args(argv)

    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("gates_probe: no CUDA device is available", file=sys.stderr)
        return 2
    card = cs.card_line()
    print(card, flush=True)
    d = args.out or tempfile.mkdtemp(prefix="gates-")
    os.makedirs(d, exist_ok=True)
    crashed = False
    results = {}
    for mode, (extra, gates) in GENBENCH.items():
        out = os.path.join(d, f"{mode}.json")
        extra = [a.format(dir=d) for a in extra]
        rc, secs, fails, tail = run(
            ["flexflow_tpu_torch.tools.genbench", *extra, "--out", out,
             "--bench-out", os.path.join(d, "bench.json"),
             "--history-out", os.path.join(d, "history.jsonl")], 1200)
        path = os.path.join(d, "trace.json") if mode == "trace_overhead" else out
        try:
            with open(path) as f:
                report = json.load(f)
            report = report.get("report", report)
        except (OSError, ValueError):
            crashed = True
            print(f"{card}: genbench --{mode}: exit {rc}, no report; stderr tail:\n{tail}")
            continue
        got = {k: report.get(k) for k in gates}
        results[mode] = {"rc": rc, "s": secs, "gated": got, "defaults": gates, "fails": fails}
        print(f"{card}: genbench --{mode.replace('_', '-')} (tool defaults): exit {rc} in "
              f"{secs:.1f} s; " + ", ".join(f"{k} {v} (default {gates[k]})" for k, v in
                                            got.items()) + (f"; {'; '.join(fails)}" if fails
                                                            else ""), flush=True)
    out = os.path.join(d, "disagg.json")
    rc, secs, fails, tail = run(
        ["flexflow_tpu_torch.tools.loadgen", "--disagg-ab", "--out", out,
         "--history-out", os.path.join(d, "history.jsonl")], 1200)
    try:
        with open(out) as f:
            report = json.load(f)
        got = {k: report.get(k) for k in DISAGG}
        results["disagg_ab"] = {"rc": rc, "s": secs, "gated": got, "defaults": DISAGG,
                                "problems": report.get("problems"),
                                "unified": report.get("unified"), "disagg": report.get("disagg")}
        print(f"{card}: loadgen --disagg-ab (tool defaults): exit {rc} in {secs:.1f} s; "
              + ", ".join(f"{k} {v} (default {DISAGG[k]})" for k, v in got.items())
              + f"; problems {report.get('problems')}", flush=True)
    except (OSError, ValueError):
        crashed = True
        print(f"{card}: loadgen --disagg-ab: exit {rc}, no report; stderr tail:\n{tail}")
    print(json.dumps({"card": card, "gates": results}, default=str))
    return 1 if crashed else 0


if __name__ == "__main__":
    sys.exit(main())
