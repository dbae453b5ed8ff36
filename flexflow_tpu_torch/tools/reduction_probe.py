"""Whether cuBLAS's reduced-precision reductions move the 2-byte training step.

    PYTHONPATH=. python3 -m flexflow_tpu_torch.tools.reduction_probe [--seed N]

PyTorch lets cuBLAS reduce split-K partial sums of fp16 and bf16 GEMMs in
the 2-byte type (``torch.backends.cuda.matmul.allow_fp16_reduced_precision_
reduction`` and its bf16 twin, both on by default); the products still
accumulate in fp32 within a split. This probe runs ``chip_smoke.py``'s
BERT-Base training cell (12 layers, hidden 768, batch 32, seq 128, SGD
0.01, MSE) in bf16 and in fp16 on one card, with the type's flag on (the
default) and off. From the same weights it takes one step with the flash
kernels twice (run to run) and one with plain attention, and prints per
dtype and flag: the losses, the kernel step's loss against the plain
step's (relative), the run-to-run difference, and the kernel step's
parameters against the plain step's as a share of the largest update;
per dtype, the kernel step's parameters with the flag on against off.
It also lists the split-K reduction kernels the profiler saw in a step.
One JSON line at the end holds these numbers. Run it from the repo's
root (it uses ``chip_smoke.py``'s configuration).
"""
from __future__ import annotations

import argparse
import json
import sys


def _step(ex, snap, x, y, backend):
    """The loss and a copy of the parameters after one step from ``snap``."""
    import torch

    with torch.no_grad():
        for k, g in ex.params.items():
            for n, p in g.items():
                p.copy_(snap[k][n])
    ex.backend = backend
    loss = float(ex.train_batch([x], y)["loss"])
    return loss, {(k, n): p.detach().float().clone()
                  for k, g in ex.params.items() for n, p in g.items()}


def _max_diff(a, b):
    return max(float((a[key] - b[key]).abs().max()) for key in a)


def probe(seed: int) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from flexflow_tpu_torch.config import FFConfig
    from flexflow_tpu_torch.core.types import DataType, LossType
    from flexflow_tpu_torch.models import build_transformer
    from flexflow_tpu_torch.runtime import SGDOptimizer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for dtype, flag in ((DataType.BFLOAT16, "allow_bf16_reduced_precision_reduction"),
                        (DataType.HALF, "allow_fp16_reduced_precision_reduction")):
        cfg = cs.bert_base(dtype)
        model = build_transformer(FFConfig(batch_size=32, seed=seed), cfg)
        model.compile(optimizer=SGDOptimizer(lr=0.01), loss_type=LossType.MEAN_SQUARED_ERROR)
        ex = model.executor
        gen = torch.Generator(device="cuda").manual_seed(seed)
        shape = (32, cfg.seq_length, cfg.hidden_size)
        x = torch.randn(shape, generator=gen, device="cuda").to(cfg.dtype.torch)
        y = torch.randn(shape, generator=gen, device="cuda").to(cfg.dtype.torch)
        snap = {k: {n: p.detach().clone() for n, p in g.items()} for k, g in ex.params.items()}
        start = {(k, n): p.float() for k, g in snap.items() for n, p in g.items()}
        tag = str(cfg.dtype.torch)[6:]
        rows, kernel_params = {}, {}
        for on in (True, False):
            setattr(torch.backends.cuda.matmul, flag, on)
            lk, pk = _step(ex, snap, x, y, "auto")
            lk2, pk2 = _step(ex, snap, x, y, "auto")
            lp, pp = _step(ex, snap, x, y, "plain")
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                _step(ex, snap, x, y, "auto")
                torch.cuda.synchronize()
            split_k = sorted({e.name[:100] for e in prof.events()
                              if e.device_type == torch.autograd.DeviceType.CUDA
                              and "splitK" in e.name})
            update = _max_diff(pp, start)
            rows["on" if on else "off"] = {
                "loss_kernel": lk, "loss_kernel_again": lk2, "loss_plain": lp,
                "kernel_vs_plain_rel": abs(lk - lp) / abs(lp),
                "run_to_run_rel": abs(lk - lk2) / abs(lk),
                "params_run_to_run_max": _max_diff(pk, pk2),
                "params_kernel_vs_plain_share_of_update": _max_diff(pk, pp) / update,
                "split_k_kernels": split_k,
            }
            kernel_params[on] = pk
            print(f"{tag} {flag}={on}: " + json.dumps(rows["on" if on else "off"]), flush=True)
        rows["kernel_params_on_vs_off_max"] = _max_diff(kernel_params[True], kernel_params[False])
        rows["kernel_loss_on_vs_off_rel"] = (abs(rows["on"]["loss_kernel"] - rows["off"]["loss_kernel"])
                                             / abs(rows["off"]["loss_kernel"]))
        setattr(torch.backends.cuda.matmul, flag, True)
        out[tag] = rows
        del model, ex, snap, x, y
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("reduction_probe: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as cs

    print(cs.card_line())
    print(json.dumps(probe(args.seed)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
