#!/usr/bin/env python
"""perfwatch: noise-aware perf-regression sentry over the genbench
trajectory (port of the JAX package's ``tools/perfwatch.py``: the same
metrics, floors, verdicts and exit codes on the same history).

``python -m flexflow_tpu_torch.tools.genbench`` appends one line per run to
``torch_tools_out/BENCH_HISTORY.jsonl``
(timestamped, git-sha-stamped, keyed by mode + backend). This tool
compares the LATEST run of each (mode, backend) group against a rolling
baseline — the median of the previous ``--baseline-n`` runs — and exits
nonzero when any watched metric regresses past its noise floor. It is
the CI gate that turns the bench trajectory from an artifact pile into
an alarm.

Noise handling (wall clocks on shared CI hosts jitter):

  * the baseline is a MEDIAN, so one historically slow run cannot drag
    the reference;
  * each metric has a configured relative (or absolute) noise floor;
  * when >= 3 baseline samples exist, the floor widens to 3x the
    baseline's relative median-absolute-deviation — a metric that is
    historically noisy cannot false-fail, and a quiet one stays tight.

A metric regresses when it is WORSE than the baseline by more than the
effective floor in its bad direction (throughput down, latency/overhead
up). Improvements never fail, and missing metrics are skipped (an old
history format must not break the gate). With fewer than ``--min-prior``
prior runs (default 3 — the point where the spread widening has data)
for every group the gate passes with a note — there is nothing robust
to compare against yet; measured run-to-run tok/s noise on loaded CPU
hosts exceeds 30%, so gating off two samples would be a coin flip.

Usage:
  python -m flexflow_tpu_torch.tools.perfwatch
      [--history torch_tools_out/BENCH_HISTORY.jsonl] [--baseline-n 5]
      [--min-prior 3]

Stdlib only (no torch import): the sentry must be runnable anywhere the
history file is, including laptops triaging a CI failure.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Tuple

from flexflow_tpu_torch.tools._common import OUT_DIR

# metric -> (direction, floor kind, floor). "higher" metrics regress
# when they DROP below baseline * (1 - floor); "lower" metrics regress
# when they RISE past baseline * (1 + floor) ("abs": baseline + floor —
# for metrics that live near zero, where relative floors degenerate).
METRICS: Dict[str, Tuple[str, str, float]] = {
    "decode_tokens_per_s": ("higher", "rel", 0.12),
    "prefill_tokens_per_s": ("higher", "rel", 0.12),
    "tokens_per_step_speedup": ("higher", "rel", 0.10),
    "acceptance_rate": ("higher", "rel", 0.10),
    "ttft_p50_s": ("lower", "rel", 0.25),
    "mfu": ("higher", "rel", 0.25),
    "tracing_overhead": ("lower", "abs", 0.02),
    # request journeys: the journeys-on vs journeys-off arm
    # delta. Lives near zero like tracing_overhead, so it gets the same
    # absolute floor — a rise past baseline + 2 points means the
    # journey layer's per-hop cost crept onto the decode hot path.
    "journey_overhead_pct": ("lower", "abs", 0.02),
    # step anatomy: the tracing_overhead series now measures
    # the anatomy-on observability arm. The gated trajectory is the
    # UNCLAMPED hidden-host seconds per hot step — a RISE past the
    # floor means the decode hot path got more host-bound. (The bubble
    # ratio rides the history for humans but is NOT gated: it clamps to
    # [0, 1] and CPU CI hosts sit near 1.0, so a ratio gate could never
    # fire on the backend CI runs.) Wall-clock-derived -> the wide
    # relative floor wall clocks get.
    "host_s_per_hot_step": ("lower", "rel", 0.25),
    # overlap mode: the A/B tokens/s ratio is a ratio of
    # interleaved best-of-N runs (steadier than raw wall clocks); the
    # on-arm tok/s and hidden-host seconds are wall-clock-derived and
    # get the wide relative floor. A ratio drop past the floor means
    # the pipeline stopped winning; a host_s rise means hidden host
    # work crept back onto the decode critical path.
    "overlap_tokens_per_s_ratio": ("higher", "rel", 0.10),
    "overlap_decode_tokens_per_s": ("higher", "rel", 0.12),
    "overlap_host_s_per_hot_step": ("lower", "rel", 0.25),
    # shared-prefix mode (prefix caching): the improvement ratio and
    # reuse fraction are ratios of interleaved best-of-N runs, so they
    # are steadier than raw wall clocks; cached TTFT is a wall clock
    # and gets the same wide floor as ttft_p50_s
    "ttft_p50_improvement": ("higher", "rel", 0.15),
    "prefill_reuse_ratio": ("higher", "rel", 0.10),
    "ttft_p50_cached_s": ("lower", "rel", 0.25),
    # mesh mode: sharded-arm decode tokens/s and the
    # sharded/single ratio. On CPU CI the ratio sits well below 1
    # (collectives over host threads); the gate guards the TREND — a
    # drop past the floor means sharded execution got slower relative
    # to its own history, not that sharding must beat one device.
    # Wall-clock-derived -> the wide relative floors wall clocks get.
    "mesh_decode_tokens_per_s": ("higher", "rel", 0.25),
    "mesh_tokens_per_s_ratio": ("higher", "rel", 0.20),
    # disaggregated serving A/B: unified/disagg ratios of
    # interleaved best-of-N arms (steadier than raw wall clocks) — a
    # TTFT ratio drop past the floor means the prefill pool stopped
    # winning admissions, a TPOT ratio drop means the decode pool's
    # interference-free steps stopped paying for the handoff; the raw
    # disagg TTFT is a wall clock and gets the wide relative floor.
    "disagg_ttft_p95_ratio": ("higher", "rel", 0.15),
    "disagg_tpot_p50_ratio": ("higher", "rel", 0.12),
    "disagg_ttft_p95_s": ("lower", "rel", 0.25),
    # constrained decoding: the A/B ratio is a median of
    # per-pair interleaved runs (machine drift cancels within a pair),
    # so it gets a tight floor — a drop means the grammar mask's
    # per-step host cost grew. The constrained-arm tok/s is a raw wall
    # clock and gets the wide relative floor.
    "constrained_tokens_per_s_ratio": ("higher", "rel", 0.08),
    "constrained_decode_tokens_per_s": ("higher", "rel", 0.25),
    # durable serving: the WAL-on/WAL-off ratio is a median
    # of per-pair interleaved runs (machine drift cancels within a
    # pair), so it gets a tight floor — a drop means the group commit's
    # per-step host cost grew. fsync p50 is a physical disk latency:
    # noisy across CI boxes, wide relative floor — a rise past it means
    # commits started waiting on storage (or someone snuck extra fsyncs
    # into the step).
    "durable_tokens_per_s_ratio": ("higher", "rel", 0.08),
    "durable_fsync_p50_s": ("lower", "rel", 0.50),
}


def load_history(path: str) -> List[dict]:
    """Parse the JSONL trajectory, skipping malformed lines (a crashed
    bench writer must not take the sentry down with it). Runs the bench
    itself marked failed (``ok: false``) are kept — a failed latest run
    must still be gated and reported, not silently replaced by the
    previous good run — but ``check()`` excludes them from the rolling
    baseline."""
    entries: List[dict] = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    e = json.loads(line)
                except ValueError:
                    continue
                if isinstance(e, dict) and isinstance(e.get("metrics"), dict):
                    entries.append(e)
    except OSError:
        pass
    return entries


def _median(values: List[float]) -> float:
    s = sorted(values)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else (s[mid - 1] + s[mid]) / 2.0


def effective_floor(kind: str, floor: float, baseline: List[float]) -> float:
    """Configured floor, widened by observed spread when there is
    enough history to estimate it (3x relative MAD)."""
    if len(baseline) < 3:
        return floor
    med = _median(baseline)
    mad = _median([abs(v - med) for v in baseline])
    if kind == "abs":
        return max(floor, 3.0 * mad)
    if abs(med) < 1e-12:
        return floor
    return max(floor, 3.0 * mad / abs(med))


def check_metric(
    name: str, current: float, baseline: List[float]
) -> Tuple[bool, str]:
    """(regressed, human line) for one metric against its baseline."""
    direction, kind, floor = METRICS[name]
    base = _median(baseline)
    floor_eff = effective_floor(kind, floor, baseline)
    if kind == "abs":
        bound = base + floor_eff if direction == "lower" else base - floor_eff
        regressed = current > bound if direction == "lower" else current < bound
        floor_str = f"abs {floor_eff:g}"
    else:
        bound = (
            base * (1.0 + floor_eff) if direction == "lower"
            else base * (1.0 - floor_eff)
        )
        regressed = current > bound if direction == "lower" else current < bound
        floor_str = f"{floor_eff:.0%}"
    verdict = "REGRESSED" if regressed else "ok"
    line = (
        f"{name}: {current:g} vs baseline(median of {len(baseline)}) "
        f"{base:g}, floor {floor_str} -> {verdict}"
    )
    return regressed, line


def check(
    history: List[dict],
    baseline_n: int = 5,
    min_prior: int = 3,
) -> Tuple[bool, List[str], bool]:
    """Gate the latest run of every (mode, backend) group.

    Returns (ok, report lines, gated) — ``gated`` False when no group
    had enough prior history to compare at all."""
    groups: Dict[Tuple[str, str], List[dict]] = {}
    for e in history:
        groups.setdefault((e.get("mode", "?"), e.get("backend", "?")), []).append(e)
    ok, gated = True, False
    lines: List[str] = []
    for (mode, backend), runs in sorted(groups.items()):
        latest = runs[-1]
        # baseline: prior runs that PASSED their own bench gate — a
        # regressed run that failed must not median the regression into
        # the reference (the latest run is still gated even if ok=false)
        eligible = [r for r in runs[:-1] if r.get("ok") is not False]
        if len(eligible) < min_prior:
            lines.append(
                f"[{mode}/{backend}] {len(eligible)} eligible prior run(s) — "
                f"need {min_prior} to gate; skipping"
            )
            continue
        prior = eligible[-baseline_n:]
        flag = " (bench gate FAILED)" if latest.get("ok") is False else ""
        header = (
            f"[{mode}/{backend}] latest {latest.get('ts', '?')} "
            f"@{latest.get('git_sha', '?')}{flag} vs {len(prior)} prior run(s)"
        )
        lines.append(header)
        for name in METRICS:
            cur = latest["metrics"].get(name)
            if not isinstance(cur, (int, float)) or isinstance(cur, bool):
                continue  # missing or non-numeric: skip, never crash the gate
            base_vals = [
                r["metrics"][name] for r in prior
                if isinstance(r["metrics"].get(name), (int, float))
            ]
            if not base_vals:
                continue
            gated = True
            regressed, line = check_metric(name, float(cur), base_vals)
            lines.append("    " + line)
            if regressed:
                ok = False
    return ok, lines, gated


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    ap.add_argument("--history", default=os.path.join(OUT_DIR, "BENCH_HISTORY.jsonl"),
                    help="genbench trajectory (JSONL, one run per line)")
    ap.add_argument("--baseline-n", type=int, default=5,
                    help="rolling-baseline window (median of the last N prior runs)")
    ap.add_argument("--min-prior", type=int, default=3,
                    help="prior runs required before a group gates")
    args = ap.parse_args(argv)

    history = load_history(args.history)
    if not history:
        print(f"perfwatch: no readable history at {args.history}; nothing to gate")
        return 0
    ok, lines, gated = check(history, args.baseline_n, args.min_prior)
    for line in lines:
        print(line)
    if not gated:
        print("perfwatch: insufficient history to gate any metric; passing")
        return 0
    if not ok:
        print("perfwatch: FAIL — regression past the noise floor (see above)",
              file=sys.stderr)
        return 1
    print("perfwatch: OK — no metric regressed past its noise floor")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
