"""The heads and infer phases of ``chip_smoke.py`` by themselves.

    PYTHONPATH=. python3 <this file> [--seed N] [--cells bert-cls,infer,...]

Builds the kernels, then runs ``chip_smoke.py``'s heads phases (bert-cls
in fp32, its infer phase, bert-cls in bf16, bert-mlm, seq2seq; or the
``--cells`` named) with every gate of each, and prints a summary line a
cell: step ms, device ms a step and by kernel group, the dropout masks'
device ms (CUDA events), and for infer its requests/s and client latency.
Prints the card's name and power limit first. Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import sys
import time

CELLS = ("bert-cls", "infer", "bert-cls bf16", "bert-mlm", "seq2seq")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cells", default=",".join(CELLS),
                    help=f"comma-separated, of {CELLS} (infer needs bert-cls)")
    args = ap.parse_args(argv)
    cells = [c for c in args.cells.split(",") if c]
    if set(cells) - set(CELLS) or ("infer" in cells and "bert-cls" not in cells):
        ap.error(f"--cells takes {CELLS}; infer needs bert-cls")

    import torch

    import chip_smoke as cs
    from flexflow_tpu_torch.core.types import DataType
    from flexflow_tpu_torch.ops.kernels import _build

    if not torch.cuda.is_available():
        print("heads_probe: no CUDA device is available", file=sys.stderr)
        return 2
    card = cs.card_line()
    print(card, flush=True)
    # as chip_smoke.py: full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.load_library()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s", flush=True)
    model = None
    for cell in cells:
        t0 = time.perf_counter()
        if cell == "infer":
            r = cs.infer_phase(args.seed, model)
            print(f"{card}: infer: {r['requests_per_s']:.2f} requests/s, p50 "
                  f"{r['latency_p50_s']:.4f} s, p99 {r['latency_p99_s']:.4f} s, "
                  f"{r['requests_per_device_batch']:.2f} requests a device batch "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
            continue
        kind, dtype = (cell.split()[0], DataType.BFLOAT16) if cell.endswith("bf16") else (cell, None)
        h, m, _ = cs.heads_phase(args.seed, kind, dtype, steps=10 if kind == "bert-cls" else 5)
        model = m if cell == "bert-cls" else model
        del m
        torch.cuda.empty_cache()
        print(f"{card}: {cell}: step {h['step_ms']:.3f} ms, device {h['step_device_ms']:.3f} ms ("
              + ", ".join(f"{g} {ms:.3f}" for g, ms in h["step_device_ms_by_group"].items())
              + f"), masks {h['dropout_mask_ms_per_step_cuda_events']:.3f} ms (CUDA events) "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
