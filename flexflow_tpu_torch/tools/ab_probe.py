"""Times of one checkout of the port, for comparing two checkouts on one card.

    PYTHONPATH=. python3 <this file> [--seed N] [--parts kernels,prefix,train_bf16]

Run it from the root of each checkout in turn, one after another on one card
(for example parent, change, change, parent), each in its own process,
so that each builds and loads its own kernels: with ``PYTHONPATH=.`` the
package and ``chip_smoke.py`` come from the checkout it runs in, whichever
checkout holds this file. It uses only entry points
that the port has had since its paged kernels took any window and the
flash kernels took bf16 (``chip_smoke.py``'s helpers, the kernel
wrappers, the engine, the scheduler and the training phase). It prints one
JSON line with the parts asked for (``kernels,prefix`` by default):

* ``kernels``: device ms (a CUDA graph of 16 calls replayed between CUDA
  events, over 8 copies of the cache, as ``chip_smoke.py`` times) of the
  paged kernels at decode (B=4 W=1), W=5 and split (S=8) in each cache
  form, and at W = 1024 from positions 0 and 512; the flash forward, dQ
  and dK/dV kernels, fp32 and bf16, at BERT-Base's training shape and at
  causal S=512, beside SDPA's forward (the same graph timing) and
  backward (dq, dk, dv together; device time by torch.profiler) in the
  same dtype;
* ``train_bf16``: ``chip_smoke.py``'s bf16 BERT-Base training cell (one
  step against plain attention, 10 timed steps, a profiled pair): step
  ms on the host clock, device ms a step by kernel group, the busy share
  and the flash launches (by body where the checkout counts them);
* ``prefix``: the prefix cell of ``chip_smoke.py`` (8 requests on a
  shared 512-token system prompt and a 700-token suffix after a 64-token
  prefix, 32 new tokens each) through a 4-slot graph engine at
  GPT-2-small width with the prefix cache on and off: TTFT p50, prefill
  step ms per request (CUDA events) and the suffix prefill's ms by suffix
  bucket.
"""
from __future__ import annotations

import argparse
import json
import sys


def _kernels(cs, seed: int) -> dict:
    import numpy as np
    import torch

    from flexflow_tpu_torch.ops.kernels import decode_attention as da
    from flexflow_tpu_torch.ops.kernels import flash_attention as fa

    rs = np.random.RandomState(seed)
    gen = torch.Generator().manual_seed(seed)
    nb, bs, h, d, mb = 257, 16, 12, 64, 64

    def tables_for(ctx_lens):
        t = np.zeros((len(ctx_lens), mb), np.int32)
        perm = rs.permutation(np.arange(1, nb)).astype(np.int32)
        used = 0
        for i, n in enumerate(ctx_lens):
            nblk = -(-int(n) // bs)
            t[i, :nblk] = perm[used:used + nblk]
            used += nblk
        return t

    cases = {}
    ctx = np.asarray([731, 18, 0, 377], np.int32)
    cases["decode"] = (tables_for(ctx), (ctx - 1)[:, None].astype(np.int32), 1)
    base = np.asarray([700, 40, 0, 300], np.int32)
    qpos = (base[:, None] + np.arange(5, dtype=np.int32)[None, :]).astype(np.int32)
    qpos[1, 3:] = -1
    qpos[2, :] = -1
    cases["append_w5"] = (tables_for(base + 5), qpos, 1)
    ctx1 = np.asarray([931], np.int32)
    cases["split"] = (tables_for(ctx1), (ctx1 - 1)[:, None].astype(np.int32), 8)
    for start in (0, 512):
        n_real = min(1024 - 1024 // 6, mb * bs - start)
        qpos = np.full((1, 1024), -1, np.int32)
        qpos[0, :n_real] = start + np.arange(n_real)
        cases[f"wide_w1024_start{start}"] = (tables_for([start + n_real]), qpos, 1)
    out = {}
    for kv_dtype, form in ((torch.float32, ""), (torch.bfloat16, "_bf16"),
                           (torch.float16, "_f16")):
        for case, (tables, qpos, s) in cases.items():
            sets = cs.paged_inputs(gen, nb, bs, h, d, tables, qpos, 8, kv_dtype)
            out[case + form], _ = cs.time_ms(
                lambda *a, s=s: da.paged_append_attention(*a, kv_splits=s), sets)
            del sets
    for label, (b, s, causal) in (("train", (32, 128, False)), ("causal512", (4, 512, True))):
        for dtype, form in ((torch.float32, ""), (torch.bfloat16, "_bf16")):
            q, k, v, do = (torch.randn(b, s, 12, 64, generator=gen).cuda().to(dtype)
                           for _ in range(4))
            scale = 64 ** -0.5
            qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True) for t in (q, k, v))
            dot = do.transpose(1, 2).contiguous()
            out[f"{label} sdpa_fwd{form}"], _ = cs.time_ms(
                lambda *_: torch.nn.functional.scaled_dot_product_attention(
                    qt.detach(), kt.detach(), vt.detach(), is_causal=causal), [()])
            ot = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
            out[f"{label} sdpa_bwd{form}"] = cs.profiled_device_ms(
                lambda: torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True))
            del qt, kt, vt, dot, ot
            o, lse = fa.flash_forward_kernel(q, k, v, causal, scale)
            delta = fa.flash_delta(do, o)
            for name, fn in (
                    ("flash_fwd", lambda: fa.flash_forward_kernel(q, k, v, causal, scale)),
                    ("flash_bwd_dq", lambda: fa.flash_backward_dq_kernel(
                        q, k, v, do, lse, delta, causal, scale)),
                    ("flash_bwd_dkv", lambda: fa.flash_backward_dkv_kernel(
                        q, k, v, do, lse, delta, causal, scale))):
                out[f"{label} {name}{form}"], _ = cs.time_ms(lambda *_, fn=fn: fn(), [()])
    return out


def _prefix(cs, seed: int, params) -> dict:
    import numpy as np
    import torch

    from flexflow_tpu_torch.generation.engine import GenerationEngine, SamplingParams

    cfg = cs.gpt2_small()
    v = cfg.vocab_size
    rs = np.random.RandomState(seed + 8)
    system = rs.randint(0, v, 512).tolist()
    prompts = [system + rs.randint(0, v, n).tolist() for n in (20, 40, 90, 150, 260, 300, 480)]
    prompts.append(list(system))
    prompts.append(system[:64] + rs.randint(0, v, 700).tolist())
    samplings = [SamplingParams(max_new_tokens=32)] * len(prompts)
    out = {}
    for on in (True, False):
        engine = GenerationEngine(params, cfg, max_batch_slots=4, block_size=16, prefix_cache=on)
        cs.warm(engine, rs)
        wsys = rs.randint(0, v, 512).tolist()
        engine.generate([wsys + rs.randint(0, v, n).tolist() for n in (9, 20, 40, 90, 150, 300)]
                        + [list(wsys), wsys[:64] + rs.randint(0, v, 700).tolist()],
                        SamplingParams(max_new_tokens=2))
        prefill_one, rec = engine.prefill_one, []

        def timed(prompt, *a, prefix_len=0, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            token = prefill_one(prompt, *a, prefix_len=prefix_len, **kw)
            end.record()
            end.synchronize()
            rec.append((engine.bucket_for(len(prompt) - prefix_len) if prefix_len else 0,
                        start.elapsed_time(end)))
            return token

        engine.prefill_one = timed
        runs = []
        for _ in range(2):
            cs.clear_prefix_cache(engine)
            rec.clear()
            _, _, ttft, _ = cs.serve(engine, prompts, samplings)
            runs.append({
                "ttft_p50_s": float(np.median(ttft)),
                "prefill_ms_per_request": float(np.mean([ms for _, ms in rec])),
                "suffix_prefill_ms_by_bucket": {
                    str(w): float(np.mean([ms for b, ms in rec if b == w]))
                    for w in sorted({b for b, _ in rec if b})},
            })
        out["on" if on else "off"] = runs
        del engine
        torch.cuda.empty_cache()
    return out


def _train_bf16(cs, seed: int) -> dict:
    t = cs.training_phase(seed, bf16=True)
    keep = ("step_ms", "samples_per_s", "step_device_ms", "step_device_ms_by_group",
            "device_busy_share_of_timed_step", "launches", "launches_by_body")
    return {key: t[key] for key in keep if key in t}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--parts", default="kernels,prefix",
                    help="comma-separated: kernels, prefix, train_bf16")
    args = ap.parse_args(argv)
    parts = args.parts.split(",")
    if set(parts) - {"kernels", "prefix", "train_bf16"}:
        ap.error(f"unknown parts in {args.parts!r}")
    import torch

    if not torch.cuda.is_available():
        print("ab_probe: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from flexflow_tpu_torch.generation.decoder import init_decoder_params, params_to
    from flexflow_tpu_torch.ops.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.load_library()
    out = {"card": cs.card_line()}
    if "kernels" in parts:
        out["kernels"] = _kernels(cs, args.seed)
    if "train_bf16" in parts:
        out["train_bf16"] = _train_bf16(cs, args.seed)
    if "prefix" in parts:
        params = params_to(init_decoder_params(torch.Generator().manual_seed(args.seed),
                                               cs.gpt2_small()), "cuda")
        out["prefix"] = _prefix(cs, args.seed, params)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
