"""The fleet phase of ``chip_smoke.py`` by itself, for repeated runs on one card.

    PYTHONPATH=. python3 <this file> [--seed N] [--repeats N]

Builds the kernels, runs ``chip_smoke.py``'s serving phase (whose
streams are the fault-free reference of the serving cell), serves the
prefix cell once through a 4-slot graph engine (its reference streams:
the prefix phase gates them equal with the prefix cache on and off), and
then runs the fleet phase ``--repeats`` times (default 1) with every gate
of the phase: the single engine, ``Fleet(factory, 2)`` over the serving
and the prefix cell, failover with a replacement spawned while the
survivor serves, ``DisaggregatedFleet`` clean and with a corrupted
handoff block, and the fleet over HTTP. Prints the card's name and power
limit first, each leg's summary line, then one line per repeat: tokens/s,
TTFT p50 and steady decode ms per step of the single engine, the fleet
and the disaggregated fleet, the handoff's pack and import ms, and the
replacement's spawn-and-capture seconds. Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--repeats", type=int, default=1)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    import chip_smoke as cs
    from flexflow_tpu_torch.generation.decoder import init_decoder_params, params_to
    from flexflow_tpu_torch.generation.engine import GenerationEngine
    from flexflow_tpu_torch.ops.kernels import _build

    if not torch.cuda.is_available():
        print("fleet_probe: no CUDA device is available", file=sys.stderr)
        return 2
    card = cs.card_line()
    print(card, flush=True)
    # as chip_smoke.py: full fp32, TF32 would move the streams
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.load_library()
    cfg = cs.gpt2_small()
    params = params_to(init_decoder_params(torch.Generator().manual_seed(args.seed), cfg), "cuda")
    engines, _, cell = cs.serving_phase(args.seed, params)
    del engines
    prompts, samplings = cs.prefix_cell_requests(np.random.RandomState(args.seed + 8),
                                                 cfg.vocab_size)
    engine = GenerationEngine(params, cfg, max_batch_slots=4, block_size=16, prefix_cache=False)
    cs.warm(engine, np.random.RandomState(args.seed + 9))
    handles = cs.serve(engine, prompts, samplings)[0]
    prefix_cell = (prompts, samplings, [h.result(0) for h in handles])
    del engine, handles
    torch.cuda.empty_cache()
    for rep in range(args.repeats):
        t0 = time.perf_counter()
        f = cs.fleet_phase(args.seed, params, cell, prefix_cell)
        print(f"fleet phase {rep}: {time.perf_counter() - t0:.1f} s", flush=True)
        print(card, json.dumps({
            name: {"tokens_per_s": f[name]["tokens_per_s"], "ttft_p50_s": f[name]["ttft_p50_s"],
                   "steady_ms_per_step": f[name]["steady"]["ms_per_step"]}
            for name in ("single", "fleet", "disagg")}))
        d = f["disagg"]
        print(card, json.dumps({k: d[k] for k in ("payload_bytes", "pack_ms_p50", "pack_ms_max",
                                                  "import_ms_p50", "import_ms_max")}),
              "replacement spawn+capture s", f["failover"]["replacement_spawn_capture_s"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
