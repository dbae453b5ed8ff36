"""The window phase of ``chip_smoke.py`` by itself.

    PYTHONPATH=. python3 <this file> [--seed N] [--cells bert,nmt,dlrm]

Builds the kernels, then runs ``chip_smoke.py``'s window phase: the
executor's window path (each step kind captured once as a CUDA graph and
replayed once a step) against its eager steps from the same weights and
keys, with every gate: BERT-Base in fp32 and bf16 (with
``train_batch_repeated``, the eval window and Adam's
``set_learning_rate`` in bf16), NMT and DLRM at their builders' widths,
or the ``--cells`` named. Prints the card's name and power limit first.
Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

CELLS = ("bert", "nmt", "dlrm")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cells", default=",".join(CELLS), help=f"comma-separated, of {CELLS}")
    args = ap.parse_args(argv)
    cells = [c for c in args.cells.split(",") if c]
    if set(cells) - set(CELLS):
        ap.error(f"--cells takes {CELLS}")

    import torch

    import chip_smoke as cs
    from flexflow_tpu_torch.core.types import DataType
    from flexflow_tpu_torch.ops.kernels import _build

    if not torch.cuda.is_available():
        print("window_probe: no CUDA device is available", file=sys.stderr)
        return 2
    card = cs.card_line()
    print(card, flush=True)
    # as chip_smoke.py: full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.load_library()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s", flush=True)
    out = {}
    t0 = time.perf_counter()
    if "bert" in cells:
        out["bert-base fp32"] = cs.window_bert(args.seed, DataType.FLOAT)
        out["bert-base bf16"] = cs.window_bert(args.seed, DataType.BFLOAT16)
    if "nmt" in cells:
        out["nmt"] = cs.window_nmt(args.seed)
    if "dlrm" in cells:
        out["dlrm"] = cs.window_dlrm(args.seed)
    out["phase_s"] = time.perf_counter() - t0
    if set(cells) == set(CELLS):
        cs.print_window(card, out)
    print(json.dumps({"card": card, "window": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
