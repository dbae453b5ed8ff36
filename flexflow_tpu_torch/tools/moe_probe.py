"""The moe and keras phases of ``chip_smoke.py``, and ResNet-50's per-op
forward profile, by themselves.

    PYTHONPATH=. python3 <this file> [--seed N] [--phases moe,keras,profile]

Runs ``chip_smoke.py``'s mixture-of-experts phase (examples/moe.py's
shape: card against CPU with routing first, the window path against
eager steps, batched against per-expert, the recompile, AggregateSpec
alone, elastic recovery, the profiling flag), its Keras phase
(keras_mnist's Sequential model card against CPU with the dropout masks
bit for bit, the functional CNN) and ``FFModel.profile`` of ResNet-50's
forward at batch 32, with every gate, or the ``--phases`` named. None of
them launches a hand-written kernel, so nothing is built. Prints the
card's name and power limit first. Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

PHASES = ("moe", "keras", "profile")


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

    if not torch.cuda.is_available():
        print("moe_probe: no CUDA device is available", file=sys.stderr)
        return 2
    card = cs.card_line()
    print(card, flush=True)
    # as chip_smoke.py: full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    t0 = time.perf_counter()
    if "moe" in phases:
        out["moe"] = cs.moe_phase(args.seed)
    if "keras" in phases:
        out["keras"] = cs.keras_phase(args.seed)
    if "profile" in phases:
        from flexflow_tpu_torch.config import FFConfig
        from flexflow_tpu_torch.core.types import CompMode
        from flexflow_tpu_torch.models import build_resnet50

        m = build_resnet50(FFConfig(batch_size=32, seed=args.seed), 1000, 224)
        m.compile(comp_mode=CompMode.INFERENCE)
        x = torch.randn((32, 3, 224, 224), generator=torch.Generator(device="cuda")
                        .manual_seed(args.seed), device="cuda")
        out["profile"] = cs.resnet_forward_profile(m, x)
        print(out["profile"]["table_head"])
    out["phases_s"] = time.perf_counter() - t0
    if set(phases) == set(PHASES):
        cs.print_moe_keras(card, out["moe"], out["keras"], out["profile"])
    print(json.dumps({"card": card, **{k: v for k, v in out.items()}}, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
