"""The trainer and vision phases of ``chip_smoke.py`` by themselves.

    PYTHONPATH=. python3 <this file> [--seed N] [--phases trainer,checkpoint,vision]

Builds the kernels, then runs ``chip_smoke.py``'s trainer phase (BERT-Base
remat on / off and gradient accumulation 4 / 1 in fp32 and bf16, the
DataLoader against staged batches), its checkpoint cell (bert-cls saved,
resumed in a fresh process, a torn newest, a failed save) and the vision
phase (ResNet-50 at 224 x 224, batch 32, fp32), or the ``--phases``
named, with every gate of each. Prints the card's name and power limit
first. Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import sys
import time

PHASES = ("trainer", "checkpoint", "vision")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default=",".join(PHASES), help=f"comma-separated, of {PHASES}")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    if set(phases) - set(PHASES):
        ap.error(f"--phases takes {PHASES}")

    import torch

    import chip_smoke as cs
    from flexflow_tpu_torch.core.types import DataType
    from flexflow_tpu_torch.ops.kernels import _build

    if not torch.cuda.is_available():
        print("trainer_probe: no CUDA device is available", file=sys.stderr)
        return 2
    print(cs.card_line(), flush=True)
    # as chip_smoke.py: full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.load_library()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s", flush=True)
    for phase in phases:
        t0 = time.perf_counter()
        if phase == "trainer":
            cs.trainer_phase(args.seed)
            cs.trainer_phase(args.seed, DataType.BFLOAT16)
        elif phase == "checkpoint":
            cs.checkpoint_phase(args.seed)
        else:
            cs.vision_phase(args.seed)
        torch.cuda.empty_cache()
        print(f"{phase}: {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
