"""The programs phase of ``chip_smoke.py`` by itself.

    PYTHONPATH=. python3 <this file> [--seed N]

Builds the CUDA kernels, calibrates the default suite on the card (the
search phase's first step, whose table the phase predicts from), then
runs ``chip_smoke.programs_phase`` with every gate: the executor's
program registry and truth ledger on a windowed BERT-Base bf16 fit,
``mfu_profile``, ``calib_debug``, ``evidence.py --quick``, the port's C
driver and the DataLoader's native gather. Prints the card's name and
power limit first. Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    import chip_smoke as cs
    from flexflow_tpu_torch.ops.kernels import _build
    from flexflow_tpu_torch.search import calibration as calib

    if not torch.cuda.is_available():
        print("programs_probe: no CUDA device is available", file=sys.stderr)
        return 2
    card = cs.card_line()
    print(card, flush=True)
    # as chip_smoke.py: full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.load_library()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s", flush=True)
    cache = tempfile.mkdtemp(prefix="ff_probe_cal_")
    os.environ["FLEXFLOW_TPU_TORCH_CACHE"] = cache
    try:
        t0 = time.perf_counter()
        table = calib.calibrate().to_json()
        print(f"calibration: {time.perf_counter() - t0:.2f} s", flush=True)
    finally:
        del os.environ["FLEXFLOW_TPU_TORCH_CACHE"]
        shutil.rmtree(cache, ignore_errors=True)
    programs = cs.programs_phase(args.seed, table)
    cs.print_programs(card, programs)
    print(json.dumps({"card": card, "programs": programs}, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
