"""Does torch.profiler see every kernel of a replayed decode step, with
the overlap pipeline on and off? On one NVIDIA GPU:

    python3 -m flexflow_tpu_torch.tools.profile_loss_probe [--reps 10]

A 1-slot GPT-2-small engine (graph steps, random weights from seed 0,
the long-context cell's split-KV path) takes an 880-token prompt and 12
new tokens per window; after the prefill, the window's decode steps run
under torch.profiler, pipelined (``overlap=True``) or sequential, with
or without a device sync before the profiler stops. Each window prints
(decode steps, paged-kernel records, device records): every step replays
12 paged kernels, so a window whose paged records are not 12 per step
lost records. ``chip_smoke.py`` profiles its exact-count windows with
the pipeline off because of what this probe shows.
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from flexflow_tpu_torch.generation.decoder import init_decoder_params, params_to
    from flexflow_tpu_torch.generation.engine import GenerationEngine, SamplingParams
    from flexflow_tpu_torch.generation.scheduler import ContinuousBatchingScheduler
    from flexflow_tpu_torch.models.transformer import TransformerConfig
    from flexflow_tpu_torch.tools.flash_probe import _card

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10, help="profiled windows per setting")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_loss_probe: no CUDA device is available", file=sys.stderr)
        return 2
    print(_card())
    cfg = TransformerConfig(num_layers=12, hidden_size=768, num_heads=12, ff_size=3072,
                            seq_length=1024, vocab_size=50257, causal=True)
    params = params_to(init_decoder_params(torch.Generator().manual_seed(0), cfg), "cuda")
    engine = GenerationEngine(params, cfg, max_batch_slots=1, block_size=16, prefix_cache=False)
    rs = np.random.RandomState(1)
    lens = [min(b, engine.max_seq_len - 8) for b in engine.buckets]
    engine.generate([rs.randint(0, cfg.vocab_size, n).tolist() for n in lens],
                    SamplingParams(max_new_tokens=4))  # every signature captured
    for overlap in (True, False):
        for sync in (False, True):
            windows = []
            for _ in range(args.reps):
                sched = ContinuousBatchingScheduler(engine, overlap=overlap)
                h = sched.submit(rs.randint(0, cfg.vocab_size, 880).tolist(),
                                 SamplingParams(max_new_tokens=12))
                sched.step()  # the prefill and a first decode step
                decode0 = engine.step_counts["decode"]
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    while not h.done():
                        sched.step()
                    if sync:
                        torch.cuda.synchronize()
                steps = engine.step_counts["decode"] - decode0
                ops = [e for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA]
                paged = sum("paged_append_kernel" in e.name for e in ops)
                windows.append((steps, paged, len(ops)))
            lost = sum(paged != cfg.num_layers * steps for steps, paged, _ in windows)
            print(f"overlap={overlap} sync={sync}: {lost} of {len(windows)} windows lost "
                  f"records; (steps, paged records, device records): {windows}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
