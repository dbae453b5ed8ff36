"""The tpt phase of ``chip_smoke.py`` by itself, for repeated runs on one card.

    PYTHONPATH=. python3 flexflow_tpu_torch/tools/tpt_probe.py [--seed N]

Builds the kernels, then runs the tpt phase with every gate of it:
tensor-parallel ranks sharing the one card over gloo, BERT-Base at a
global batch of 32 under ``megatron_strategy`` (tp=2 in fp32 and bf16,
tp=2 with sp in fp32, dp=2 x tp=2 in fp32) against one rank (losses,
gathered parameters, bit-identical shards, each rank's flash launches on
its 6 heads), the step ms at N=1 and tp=2 in turns with each rank's
collective ms and bytes a step by kind, its parameter bytes and peak
memory, and the NCCL leg where there are two GPUs. Prints the card's
name and power limit first and the phase's seconds last. Needs one CUDA
device.
"""
from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    import chip_smoke as cs
    from flexflow_tpu_torch.ops.kernels import _build

    if not torch.cuda.is_available():
        print("tpt_probe: no CUDA device is available", file=sys.stderr)
        return 2
    card = cs.card_line()
    print(card, flush=True)
    # as chip_smoke.py: full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.load_library()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    tpt = cs.tpt_phase(args.seed)
    cs.print_tpt(card, tpt)
    print(card, f"tpt phase: {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
