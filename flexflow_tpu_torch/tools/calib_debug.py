"""Decompose the calibration harness's measured time on the card.

The port's counterpart of the JAX package's ``tools/calib_debug.py``.
The card's calibration holds LayerNorm at many times its roofline while
its GEMMs sit near theirs; this script isolates the suspects, each timed
as ``search/calibration.py::measure_lowered_op`` times an op: ``inner``
calls captured into one CUDA graph, the graph replayed between CUDA
events, the fastest of the repetitions (on the CPU, loops on the host
clock):

  A  the launch floor: a graph of one tiny kernel, replayed;
  B  replay jitter: 10 repetitions of that replay;
  C  a bf16 matmul (the calibration suite's LINEAR, 2048 x 768 x 3072)
     at inner 8 / 32 / 128: the slope a call between the two largest
     trip counts against the fixed intercept;
  D  the same for LayerNorm over (16, 128, 768) bf16;
  E  the framework path on the same two ops: the cost model's
     prediction (``CostModel.op_cost_metrics``) and
     ``measure_lowered_op``, the error read back from the shared truth
     ledger (``GLOBAL_LEDGER``).

Usage:
    python -m flexflow_tpu_torch.tools.calib_debug [--device cpu] [--tiny] [--out PATH]

Runs on the card unless ``--device cpu``; ``--tiny`` shrinks every shape
(a CPU smoke run). Writes ``torch_tools_out/CALIB_DEBUG.json`` and prints
one summary JSON line.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

from ._common import out_path

INNERS = (8, 32, 128)


def _timer(device):
    """``timed(run, inner, reps) -> (best s a call, every rep's s a call)``
    on ``device``: a CUDA graph of ``inner`` calls replayed between CUDA
    events on the card, host loops on the CPU."""
    import torch

    def timed_cuda(run, inner, reps):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(2):
                run()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(inner):
                run()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        samples = []
        for _ in range(reps):
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            samples.append(start.elapsed_time(end) * 1e-3 / inner)
        return min(samples), samples

    def timed_host(run, inner, reps):
        run()
        samples = []
        for _ in range(reps):
            t0 = time.perf_counter()
            for _ in range(inner):
                run()
            samples.append((time.perf_counter() - t0) / inner)
        return min(samples), samples

    return timed_cuda if device.type == "cuda" else timed_host


def _slope(times: dict) -> tuple:
    """(seconds a call, fixed seconds) from the two largest trip counts:
    ``times[n]`` is the seconds a call at ``n`` calls a replay."""
    lo, hi = sorted(times)[-2:]
    total_lo, total_hi = times[lo] * lo, times[hi] * hi
    per_call = (total_hi - total_lo) / (hi - lo)
    return per_call, total_hi - hi * per_call


def run(device, tiny: bool = False) -> dict:
    import torch

    from ..core.tensor import TensorSpec
    from ..core.types import DataType, OpType
    from ..obs.truth import GLOBAL_LEDGER
    from ..ops.base import get_op_def
    from ..ops.linear import LinearParams
    from ..ops.norm import LayerNormParams
    from ..parallel.machine import MachineSpec
    from ..search.calibration import (
        chip_spec_for,
        load_or_calibrate,
        measure_lowered_op,
        op_ledger_key,
    )
    from ..search.cost_model import CostModel

    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    res = {"backend": "gpu" if device.type == "cuda" else "cpu", "device_kind": kind,
           "steps": {}}
    steps = res["steps"]
    timed = _timer(device)
    m, k, n = (64, 32, 96) if tiny else (2048, 768, 3072)
    ln_shape = (2, 8, 32) if tiny else (16, 128, 768)

    # A/B: the launch floor and its jitter
    x0 = torch.ones(8, device=device)
    floor, samples = timed(lambda: x0.mul(1.000001), 1, 10)
    steps["launch_floor_us"] = floor * 1e6
    steps["launch_jitter_us"] = [s * 1e6 for s in samples]

    # C: the calibration LINEAR's matmul, inner sweep
    gen = torch.Generator().manual_seed(0)
    a = torch.randn(m, k, generator=gen).to(device, torch.bfloat16)
    w = (torch.randn(k, n, generator=gen) * 0.02).to(device, torch.bfloat16)
    mm = {inner: timed(lambda: a @ w, inner, 3)[0] for inner in INNERS}
    per_call, intercept = _slope(mm)
    flops = 2.0 * m * k * n
    steps["matmul_loop_s"] = {str(i): t for i, t in mm.items()}
    steps["matmul_per_iter_us"] = per_call * 1e6
    steps["matmul_fixed_overhead_us"] = intercept * 1e6
    steps["matmul_achieved_tflops"] = flops / max(per_call, 1e-12) / 1e12

    # D: the calibration LayerNorm, inner sweep
    xs = torch.randn(*ln_shape, generator=gen).to(device, torch.bfloat16)
    g = torch.ones(ln_shape[-1], device=device, dtype=torch.bfloat16)
    b = torch.zeros(ln_shape[-1], device=device, dtype=torch.bfloat16)
    ln = {inner: timed(lambda: torch.nn.functional.layer_norm(xs, (ln_shape[-1],), g, b, 1e-5),
                       inner, 3)[0] for inner in INNERS}
    per_ln, intercept_ln = _slope(ln)
    nbytes = 2.0 * xs.numel() * xs.element_size()  # read x, write y
    steps["ln_loop_s"] = {str(i): t for i, t in ln.items()}
    steps["ln_per_iter_us"] = per_ln * 1e6
    steps["ln_fixed_overhead_us"] = intercept_ln * 1e6
    steps["ln_effective_gbps"] = nbytes / max(per_ln, 1e-12) / 1e9

    # E: the framework path on the same two ops; the error is read back
    # from the shared truth ledger, not compared here
    cm = CostModel(MachineSpec(num_nodes=1, devices_per_node=1, chip=chip_spec_for(kind)),
                   calibration=load_or_calibrate(device_kind=kind))
    suite = [
        ("linear", OpType.LINEAR,
         LinearParams(out_dim=n, use_bias=True, dtype=DataType.BFLOAT16),
         [TensorSpec((m, k), DataType.BFLOAT16)]),
        ("ln", OpType.LAYERNORM,
         LayerNormParams(axes=(2,), dtype=DataType.BFLOAT16),
         [TensorSpec(ln_shape, DataType.BFLOAT16)]),
    ]
    t0 = time.perf_counter()
    errors = {}
    for name, op_type, params, specs in suite:
        out_specs = get_op_def(op_type).infer_output_specs(params, list(specs))
        cm.op_cost_metrics(op_type, params, specs, out_specs, 1)  # predict side
        measure_lowered_op(op_type, params, specs, inner=32)      # measure side
        key = op_ledger_key(cm.calibration.device_kind, op_type, params, specs, 1)
        entry = next((e for e in GLOBAL_LEDGER.report()["entries"] if e["key"] == key), None)
        if entry is None or not entry["pairs"]:
            steps[f"framework_{name}_us"] = None
            continue
        steps[f"framework_{name}_us"] = entry["measured_p50_s"] * 1e6
        errors[name] = {
            "key": key,
            "predicted_us": entry["predicted_s"] * 1e6,
            "measured_p50_us": entry["measured_p50_s"] * 1e6,
            "rel_err": entry["rel_err_p50"],
            "provenance": entry["provenance"],
        }
    steps["prediction_error"] = errors
    steps["framework_seconds"] = time.perf_counter() - t0
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cpu for a smoke run (default: the card)")
    ap.add_argument("--tiny", action="store_true", help="small shapes (a CPU smoke run)")
    ap.add_argument("--out", default=None, help="default: torch_tools_out/CALIB_DEBUG.json")
    args = ap.parse_args(argv)

    from ..core.device import resolve_device

    res = run(resolve_device(args.device), tiny=args.tiny)
    path = args.out or out_path("CALIB_DEBUG.json")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(json.dumps(res, indent=1) + "\n")
    os.replace(tmp, path)
    print(json.dumps(res["steps"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
