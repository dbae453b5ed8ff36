"""The search phase of ``chip_smoke.py`` by itself.

    PYTHONPATH=. python3 <this file> [--seed N]

Builds the CUDA kernels, then runs ``chip_smoke.search_phase`` with
every gate: ``calibrate()`` of the default suite on the card (its
attention entry through ``ff_flash_fwd_bf16``), a data-parallel and a
``search_budget=8`` build of BERT-Base bf16 trained 4 steps each from the
same weights, and the search for 8 H100s with its strategy file's round
trip and refusal. Prints the card's name and power limit first. Needs
one CUDA device.
"""
from __future__ import annotations

import argparse
import json
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
        print("search_probe: no CUDA device is available", file=sys.stderr)
        return 2
    card = cs.card_line()
    print(card, flush=True)
    # as chip_smoke.py: full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.load_library()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s", flush=True)
    t0 = time.perf_counter()
    search = cs.search_phase(args.seed)
    phase_s = time.perf_counter() - t0
    cs.print_search(card, search)
    print(f"{card}: search phase {phase_s:.1f} s")
    print(json.dumps({"card": card, "search": search, "phase_s": phase_s}, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
