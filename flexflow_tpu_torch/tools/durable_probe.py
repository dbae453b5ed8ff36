"""The durable phase of ``chip_smoke.py`` by itself, for repeated runs on one card.

    PYTHONPATH=. python3 <this file> [--seed N] [--repeats N]

Builds the kernels, runs ``chip_smoke.py``'s serving phase (whose
streams are the fault-free reference) and then its durable phase
``--repeats`` times (default 2): a serving process SIGKILLed mid-stream
and warm-restarted, with every gate of the phase, then the steady 4-slot
stretches with durability off, with fsync and without, and journeys on
and off. Prints each phase's summary line, then one line per stretch:
ms per step, the dispatch ms, the device's busy share, the garbage
collector's pauses, and with durability the flush_step host ms (p50, p99,
max), its WAL write's max and the fsyncs a second. Prints the card's name
and power limit first. Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import sys
import time

FIELDS = ("ms_per", "dispatch", "device_busy", "gc", "flush", "wal_w", "fsyncs")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--repeats", type=int, default=2)
    args = ap.parse_args(argv)

    import torch

    import chip_smoke as cs
    from flexflow_tpu_torch.generation.decoder import init_decoder_params, params_to
    from flexflow_tpu_torch.ops.kernels import _build

    if not torch.cuda.is_available():
        print("durable_probe: no CUDA device is available", file=sys.stderr)
        return 2
    card = cs.card_line()
    print(card, flush=True)
    # as chip_smoke.py: full fp32, TF32 would move the streams
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.load_library()
    params = params_to(
        init_decoder_params(torch.Generator().manual_seed(args.seed), cs.gpt2_small()), "cuda")
    engines, _, cell = cs.serving_phase(args.seed, params)
    del engines
    for rep in range(args.repeats):
        t0 = time.perf_counter()
        d = cs.durable_phase(args.seed, params, cell)
        print(f"durable phase {rep}: {time.perf_counter() - t0:.1f} s", flush=True)
        for name, runs in d["steady"].items():
            for r in runs:
                print(card, name, {k: (round(v, 4) if isinstance(v, float) else v)
                                   for k, v in r.items() if k.startswith(FIELDS)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
