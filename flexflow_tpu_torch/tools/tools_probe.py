"""The tools phase of ``chip_smoke.py`` by itself, for repeated runs on one card.

    PYTHONPATH=. python3 <this file> [--seed N] [--repeats N]

Builds the kernels, makes the GPT-2-small weights from ``--seed`` and runs
``chip_smoke.py``'s tools phase ``--repeats`` times (default 1) with every
gate: genbench's base mode twice, loadgen ``--url`` against an
InferenceServer over its engine (an under-capacity and an overload leg),
obsreport's views and the card's ledger export calibrating the fleet
twin, ``simfleet simcheck`` with its live storm on the card, chaoscheck's
recovery sweep and perfwatch. Prints the card's name and power limit
first and each repeat's phase seconds. Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--repeats", type=int, default=1)
    args = ap.parse_args(argv)

    import torch

    import chip_smoke as cs
    from flexflow_tpu_torch.generation.decoder import init_decoder_params, params_to
    from flexflow_tpu_torch.ops.kernels import _build

    if not torch.cuda.is_available():
        print("tools_probe: no CUDA device is available", file=sys.stderr)
        return 2
    card = cs.card_line()
    print(card, flush=True)
    # as chip_smoke.py: full fp32, TF32 would move the streams
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.load_library()
    params = params_to(init_decoder_params(torch.Generator().manual_seed(args.seed),
                                           cs.gpt2_small()), "cuda")
    for rep in range(args.repeats):
        t = cs.tools_phase(args.seed, params, card)
        print(f"tools phase {rep}: {t['phase_s']:.1f} s", flush=True)
        print(json.dumps({"tools": t}, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
