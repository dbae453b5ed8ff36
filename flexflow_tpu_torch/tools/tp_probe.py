"""The tp phase of ``chip_smoke.py`` by itself, for repeated runs on one card.

    PYTHONPATH=. python3 <this file> [--seed N]

Builds the kernels, runs ``chip_smoke.py``'s serving phase (whose graph
engine and streams are the tp=1 reference of the serving cell), then the
tp phase with every gate of it: each rank's head slice through the paged
kernels at tp 2, 3 and 4, GPT-2 small behind a tp=2 engine (two ranks on
the one card over gloo) over the serving cell, k = 4 speculation, the
prefix cell, a ``generation.collective`` restart and one HTTP generate,
then the steady decode ms a step of the tp=1 and tp=2 engines in turns,
each rank's peak memory and the NCCL leg where there are two GPUs.
Prints the card's name and power limit first and the phase's seconds
last. Needs one CUDA device.
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
    from flexflow_tpu_torch.generation.decoder import init_decoder_params, params_to
    from flexflow_tpu_torch.ops.kernels import _build

    if not torch.cuda.is_available():
        print("tp_probe: no CUDA device is available", file=sys.stderr)
        return 2
    card = cs.card_line()
    print(card, flush=True)
    # as chip_smoke.py: full fp32, TF32 would move the streams
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.load_library()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s", flush=True)
    cfg = cs.gpt2_small()
    params = params_to(init_decoder_params(torch.Generator().manual_seed(args.seed), cfg), "cuda")
    t0 = time.perf_counter()
    engines, _, cell = cs.serving_phase(args.seed, params)
    print(f"serving phase: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    cs.tp_phase(args.seed, params, cell, engines["graph"])
    print(card, f"tp phase: {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
