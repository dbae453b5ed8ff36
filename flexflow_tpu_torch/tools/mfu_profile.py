"""Device-trace breakdown of one training window on the card: where does
the time outside the GEMMs go?

The port's counterpart of the JAX package's ``tools/mfu_profile.py``. It
builds BERT-Base (or BERT-Large with ``--large``) in bf16, times its
``train_batch_repeated`` window with the bench's helper
(``tools/_bench.py::bench_one``), reads the strategy simulator's step
prediction beside the measured steps from the executor's truth-ledger
entry (``executor[n].train_step``), then profiles one window of
``--iters`` steps under ``torch.profiler`` and groups the CUDA kernels'
time: ``gemm`` (cuBLAS / CUTLASS), ``flash`` (the port's ``ff_flash_*``
kernels), ``elementwise`` (PyTorch's elementwise kernels), ``copy``
(memcpy / memset) and ``other`` (reductions, softmax, layer norm and the
rest). These groups take the place of the XLA profiler's HLO categories.

Usage:
    python -m flexflow_tpu_torch.tools.mfu_profile [--searched] [--batch 32]
        [--large] [--seq 128] [--iters 10] [--device cpu] [--out PATH]

Runs on the card unless ``--device cpu`` (a smoke run: a CPU has no
CUDA kernels to group, so its breakdown is empty). The MFU divides by the
card's dense bf16 peak (``_bench.peak_flops_per_device``). Output: one
entry appended to ``torch_tools_out/MFU_PROFILE.json`` (the JAX
package's schema: ``ts``, ``backend``, ``device_kind``, ``config``,
``step_ms``, ``mfu``, ``prediction``, ``breakdown``) and a one-line
JSON summary on stdout.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from collections import defaultdict
from typing import Dict, Iterable, Tuple

from ._common import out_path


def kernel_category(name: str) -> str:
    """The group of one CUDA kernel (or copy) by its name."""
    low = name.lower()
    if "flash_" in low:  # flash_{fwd,bwd_dq,bwd_dkv}_*kernel, behind ff_flash_*
        return "flash"
    if any(k in low for k in ("gemm", "cutlass", "nvjet", "xmma", "cublas")):
        return "gemm"
    if "memcpy" in low or "memset" in low:
        return "copy"
    if "elementwise" in low:
        return "elementwise"
    return "other"


def breakdown(kernels: Iterable[Tuple[str, float]], top: int = 25) -> Dict:
    """The schema's ``breakdown`` block from (kernel name, device us)
    pairs: the total, each group's share, the ``top`` kernels."""
    per_op: Dict[Tuple[str, str], float] = defaultdict(float)
    cats: Dict[str, float] = defaultdict(float)
    for name, us in kernels:
        cat = kernel_category(name)
        cats[cat] += us
        per_op[(cat, name)] += us
    total = sum(cats.values())
    if total <= 0:
        return {"error": "the profiler recorded no device time"}
    ops = sorted(per_op.items(), key=lambda kv: -kv[1])[:top]
    return {
        "total_device_us": round(total, 1),
        "category_us": {k: round(v, 1) for k, v in sorted(cats.items(), key=lambda kv: -kv[1])},
        "category_fractions": {k: round(v / total, 4)
                               for k, v in sorted(cats.items(), key=lambda kv: -kv[1])},
        "top_ops": [{"category": k[0], "op": k[1][:120], "us": round(us, 1),
                     "frac": round(us / total, 4)} for k, us in ops],
    }


def profile_kernels(fn) -> list:
    """(name, device us) of every CUDA kernel and copy ``fn()`` runs,
    as torch.profiler records them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [(e.name, float(e.time_range.elapsed_us())) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def ledger_prediction(ex) -> Dict:
    """The executor's truth-ledger entry as the schema's ``prediction``
    block (None before a measured pair)."""
    from ..obs.truth import GLOBAL_LEDGER

    truth = next((e for e in GLOBAL_LEDGER.report()["entries"]
                  if e["key"] == f"{ex._prog_ns}.train_step"), None)
    if truth is None or not truth["pairs"]:
        return None
    return {
        "predicted_step_ms": round(truth["predicted_s"] * 1e3, 3),
        "measured_step_ms": round(truth["measured_p50_s"] * 1e3, 3),
        "rel_err": round(truth["rel_err_p50"], 3),
        "pairs": truth["pairs"],
        "provenance": truth["provenance"],
    }


def append_entry(path: str, entry: Dict) -> None:
    """Append ``entry`` to the file's ``runs`` (atomic replace)."""
    data = {"what": "torch.profiler breakdown of the timed training window", "runs": []}
    if os.path.exists(path):
        try:
            with open(path) as f:
                data = json.load(f)
        except json.JSONDecodeError:
            pass
    data["runs"].append(entry)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(json.dumps(data, indent=1) + "\n")
    os.replace(tmp, path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--searched", action="store_true")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--large", action="store_true")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--layers", type=int, default=None,
                    help="override the depth (a CPU smoke run)")
    ap.add_argument("--device", default=None, help="cpu for a smoke run (default: the card)")
    ap.add_argument("--out", default=None, help="default: torch_tools_out/MFU_PROFILE.json")
    args = ap.parse_args(argv)

    from ..core.device import resolve_device
    from ..generation import prng
    from ..ops.kernels import flash_attention as fa
    from . import _bench

    device = resolve_device(args.device)
    backend = "gpu" if device.type == "cuda" else "cpu"
    if device.type == "cuda":
        import torch

        kind = torch.cuda.get_device_name(device)
    else:
        kind = "cpu"
    peak = _bench.peak_flops_per_device(kind, backend)
    shape = dict(_bench.BERT_LARGE if args.large else _bench.BERT_BASE)
    if args.layers:
        shape["layers"] = args.layers
    cfg = _bench.bert_config(shape, args.seq)
    model = _bench.build_bert(cfg, args.batch, args.searched, device)
    ex = model.executor

    # the timed windows feed the truth ledger's measure side; the
    # executor registered the simulator's step prediction at compile
    step_s = _bench.bench_one(ex, args.batch, cfg, args.iters)
    prediction = ledger_prediction(ex)

    x, y = _bench.bench_inputs(args.batch, cfg, device)
    rng = prng.key(0)

    def window():
        ex.train_batch_repeated([x], y, rng, num_steps=args.iters)

    fa.reset_launch_counts()
    if device.type == "cuda":
        br = breakdown(profile_kernels(window))
    else:
        window()
        br = {"error": "no CUDA kernels on the CPU"}
    n_params = _bench.param_count(ex)
    fpt = _bench.train_flops_per_token(n_params, cfg.num_layers, cfg.seq_length,
                                       cfg.hidden_size)
    mfu = (args.batch * cfg.seq_length / step_s) * fpt / peak
    entry = {
        "ts": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "backend": backend, "device_kind": kind,
        "config": {"large": args.large, "batch": args.batch, "seq": args.seq,
                   "searched": args.searched, "layers": cfg.num_layers},
        "step_ms": round(step_s * 1e3, 3),
        "mfu": round(mfu, 4),
        "peak_flops": peak,
        "prediction": prediction,
        "breakdown": br,
        "flash_launches": {k: v for k, v in fa.LAUNCHES.items() if v},
    }
    append_entry(args.out or out_path("MFU_PROFILE.json"), entry)
    print(json.dumps({k: entry[k] for k in ("backend", "step_ms", "mfu", "prediction")}
                     | {"categories": br.get("category_fractions"),
                        "top3": br.get("top_ops", [])[:3]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
