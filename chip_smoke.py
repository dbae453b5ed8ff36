#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (flexflow_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each raising on failure (the script then exits non-zero and
prints no result line):

1. device: the card's name and power limit (nvidia-smi), the time to
   build the CUDA kernels from ``flexflow_tpu_torch/ops/kernels/csrc``,
   and the built flash library's SASS (cuobjdump), which must hold
   tensor-core HMMA instructions in every instance of the forward and
   dK/dV kernels.
2. kernels: each paged attention kernel against its plain PyTorch
   version on the card, fp32, atol 1e-4 + rtol 1e-4 (the kernel sums in
   another order), at the serving path's shapes; then the device time
   (CUDA events around a replayed CUDA graph of the calls) of the
   kernel, the plain version and one PyTorch library call over the same
   inputs (scaled_dot_product_attention on the gathered K/V, a yardstick
   the port never calls), beside the card's bound.
3. serving: a GPT-2-small-width decoder (12 x 768, 12 heads, vocab
   50257, 1024 positions, random weights from --seed, fp32) behind a
   4-slot engine and the continuous-batching scheduler; 8 requests of
   16-700 prompt tokens and 32 new tokens each (6 greedy, 2 seeded
   temperature 0.8 / top-k 50). The launch counters must show one paged
   kernel launch per layer per decode step, and one decode step's
   logits must agree with the plain attention path within 1e-3.
4. long context: the same model in a 1-slot engine with a ~900-token
   prompt, where the split-KV (flash-decoding) kernel is selected.
5. anatomy: torch.profiler over a short 4-slot run — the device's busy
   share of the wall time and the device time by kernel.
6. flash kernels: the flash-attention forward, dQ and dK/dV kernels
   against their plain PyTorch versions (atol 1e-4 + rtol 1e-4) at the
   training path's shape (B=32, S=128, H=12, D=64) and at a causal
   S=512 shape and edge shapes (S=100 D=128, Sq=64 Sk=200, D=256, S=1,
   S=65 plain and causal, D=8); then device times of kernel, plain
   version and the library yardstick (scaled_dot_product_attention
   forward, and its backward: its kernels' durations by torch.profiler),
   beside the card's bound for fp32-accurate products on the tensor cores
   (and for the same operations on the fp32 CUDA cores).
7. training: BERT-Base width (12 layers, hidden 768, 12 heads, ff 3072,
   seq 128, batch 32, fp32, weights from --seed) through FFModel ->
   compile (SGD lr 0.01, MSE) -> fit: one step with the kernels and one
   with the plain attention from the same weights must agree; then
   warm-up and 10 timed steps on one random batch, where every flash
   launch counter must rise by 12 per step and the loss must fall; and a
   profiled pair of steps for the device's busy share.

Prints a ``{"kernels": [...]}`` line, then, as its last line,
``{"ok": true, "device": {...}}``. Needs one CUDA device; exits non-zero
without one.
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import re
import subprocess
import sys
import time

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_FP32_FLOPS = 67e12  # fp32 outside the tensor cores, H100 SXM data sheet
H100_TF32_FLOPS = 495e12  # dense TF32 on the tensor cores, H100 SXM data sheet
TF32_PRODUCTS = 3  # TF32 products per fp32-accurate product (3xTF32 split)
ATOL = 1e-4
RTOL = 1e-4
LOGITS_ATOL = 1e-3
SOURCE = "flexflow_tpu_torch/ops/kernels/csrc/paged_attention.cu"
FLASH_SOURCE = "flexflow_tpu_torch/ops/kernels/csrc/flash_attention.cu"
LOSS_RTOL = 1e-5  # train-step loss, kernel vs plain attention
# parameters after one SGD step, kernel vs plain attention: within this
# share of the largest update the step made (fp32 summation order only)
PARAM_STEP_RTOL = 1e-3


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, arg_sets, iters: int = 16, reps: int = 5):
    """(device ms, eager ms) per call, by CUDA events, cycling over
    ``arg_sets`` (distinct copies of the inputs, together larger than
    the 50 MB L2, so each call reads its K/V from device memory).

    Device ms: ``iters`` calls captured in one CUDA graph and replayed,
    so the time is the device's, free of Python and launch overhead.
    Eager ms: the same calls issued one by one from Python, which on a
    slow host measures the host's issue rate instead."""
    import torch

    for a in arg_sets[:3]:
        fn(*a)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    end.synchronize()
    eager = start.elapsed_time(end) / iters
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up on the capture stream's side
        for a in arg_sets[:2]:
            fn(*a)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    device = start.elapsed_time(end) / (reps * iters)
    del graph
    return device, eager


def check_close(name: str, got, want) -> float:
    import torch

    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite output")
    err = (got - want).abs()
    bad = err > ATOL + RTOL * want.abs()
    if bad.any():
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements outside atol {ATOL} + rtol {RTOL}; "
            f"max abs err {float(err.max()):.3e}"
        )
    return float(err.max())


def paged_inputs(gen, num_blocks, bs, heads, head_dim, tables_np, qpos_np, copies):
    """``copies`` distinct (q, k_cache, v_cache, block_tables, q_positions)
    sets on the card, sharing tables and positions."""
    import torch

    dev = torch.device("cuda")
    b, w = qpos_np.shape
    tables = torch.from_numpy(tables_np).to(dev)
    qpos = torch.from_numpy(qpos_np).to(dev)
    sets = []
    for _ in range(copies):
        k = torch.randn((num_blocks, bs, heads, head_dim), generator=gen).to(dev)
        v = torch.randn((num_blocks, bs, heads, head_dim), generator=gen).to(dev)
        q = torch.randn((b, w, heads, head_dim), generator=gen).to(dev)
        sets.append((q, k, v, tables, qpos))
    return sets


def bound(qpos_np, max_blocks, bs, heads, head_dim):
    """(bound_ms, bound_by) of one paged append attention call: bytes of
    q, the live K/V rows (each read once), the tables, the positions and
    the output, over the card's memory rate; against the fp32 operations
    QK and PV need for these positions, over its fp32 rate."""
    import numpy as np

    b, w = qpos_np.shape
    live = np.minimum(qpos_np.max(axis=1) + 1, max_blocks * bs).clip(min=0)
    nbytes = 4 * (
        2 * b * w * heads * head_dim  # q in, output out
        + 2 * int(live.sum()) * heads * head_dim  # K and V rows
        + b * max_blocks + b * w  # tables, positions
    )
    flops = 4 * int((qpos_np + 1).clip(min=0).sum()) * heads * head_dim
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sdpa_inputs(sets):
    """The library yardstick's inputs: K/V gathered contiguous per
    sequence, [B, H, S, D], and the same position mask [B, 1, W, S]."""
    import torch

    out = []
    for q, k, v, tables, qpos in sets:
        b, mb = tables.shape
        kk = k[tables.long()].reshape(b, mb * k.shape[1], *k.shape[2:]).transpose(1, 2)
        vv = v[tables.long()].reshape(b, mb * v.shape[1], *v.shape[2:]).transpose(1, 2)
        pos = torch.arange(kk.shape[2], device=q.device)
        mask = (pos[None, None, :] <= qpos[:, :, None])[:, None]
        out.append((q.transpose(1, 2).contiguous(), kk.contiguous(), vv.contiguous(), mask))
    return out


def kernel_phase(seed: int):
    """Each kernel against its plain version, then times. Returns the
    per-kernel records (launches filled in by the serving phases)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from flexflow_tpu_torch.ops.kernels import decode_attention as da

    rs = np.random.RandomState(seed)
    gen = torch.Generator().manual_seed(seed)
    nb, bs, h, d, mb = 257, 16, 12, 64, 64
    copies = 8  # 8 x 2 x 12.6 MB of cache: well past the L2

    def tables_for(ctx_lens):
        t = np.zeros((len(ctx_lens), mb), np.int32)  # past coverage: scratch
        perm = rs.permutation(np.arange(1, nb)).astype(np.int32)
        used = 0
        for i, n in enumerate(ctx_lens):
            nblk = -(-int(n) // bs)
            t[i, :nblk] = perm[used:used + nblk]
            used += nblk
        return t

    cases = {}
    # decode, as the 4-slot engine runs it: mixed context lengths, one
    # inactive slot (context 0), scratch entries past each table's end
    ctx = np.asarray([731, 18, 0, 377], np.int32)
    cases["decode"] = (tables_for(ctx), (ctx - 1)[:, None].astype(np.int32), 1)
    # a W = 5 append window with padding queries and an all-padding slot
    base = np.asarray([700, 40, 0, 300], np.int32)
    qpos = base[:, None] + np.arange(5, dtype=np.int32)[None, :]
    qpos[1, 3:] = -1
    qpos[2, :] = -1
    cases["append_w5"] = (tables_for(base + 5), qpos.astype(np.int32), 1)
    # single-stream long context: the split-KV form, S = default_kv_splits(1, 64)
    splits = da.default_kv_splits(1, mb)
    if splits != 8:
        raise AssertionError(f"default_kv_splits(1, 64) = {splits}, expected 8")
    ctx1 = np.asarray([931], np.int32)
    cases["split"] = (tables_for(ctx1), (ctx1 - 1)[:, None].astype(np.int32), splits)

    rows = {}
    for name, (tables, qpos, s) in cases.items():
        sets = paged_inputs(gen, nb, bs, h, d, tables, qpos, copies)
        q, k, v, bt, qp = sets[0]
        if s == 1:
            got = da.paged_append_attention(q, k, v, bt, qp)
            want = da.reference_paged_append_attention(q, k, v, bt, qp)
            err = check_close(f"{name} kernel vs plain", got, want)
            plain = da.reference_paged_append_attention
        else:
            acc, m, l = da.paged_append_partials_kernel(q, k, v, bt, qp, s, d ** -0.5)
            pacc, pm, pl = da.reference_paged_append_partials(q, k, v, bt, qp, s)
            err = max(
                check_close(f"{name} acc partials", acc, pacc),
                check_close(f"{name} l partials", l, pl),
                float((m - pm).abs().max()),
            )
            if not torch.allclose(m, pm, atol=ATOL, rtol=RTOL):
                raise AssertionError(f"{name}: m partials differ")
            got = da.paged_append_attention(q, k, v, bt, qp, kv_splits=s)
            want = da.reference_paged_append_attention(q, k, v, bt, qp)
            err = max(err, check_close(f"{name} combined vs single-pass plain", got, want))

            def plain(q_, k_, v_, bt_, qp_, s=s):
                return da._combine_splits(
                    *da.reference_paged_append_partials(q_, k_, v_, bt_, qp_, s),
                    qp_, q_.dtype,
                )

            split_kernel_ms, _ = time_ms(
                lambda *a, s=s: da.paged_append_partials_kernel(*a, s, d ** -0.5), sets
            )
        pad = torch.from_numpy(qpos < 0).cuda()
        if pad.any() and not bool((got[pad] == 0).all()):
            raise AssertionError(f"{name}: padding queries must give exact zeros")
        ms, eager_ms = time_ms(lambda *a: da.paged_append_attention(*a, kv_splits=s), sets)
        plain_ms, plain_eager_ms = time_ms(plain, sets)
        lib_sets = sdpa_inputs(sets[:4])
        library_ms, _ = time_ms(
            lambda qq, kk, vv, mask: F.scaled_dot_product_attention(qq, kk, vv, attn_mask=mask),
            lib_sets,
        )
        bound_ms, bound_by = bound(qpos, mb, bs, h, d)
        rows[name] = {
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "eager_ms": eager_ms, "plain_eager_ms": plain_eager_ms,
            "shape": {"B": int(qpos.shape[0]), "W": int(qpos.shape[1]), "H": h, "D": d,
                      "bs": bs, "MB": mb, "splits": s,
                      "live_positions": int(np.minimum(qpos.max(1) + 1, mb * bs).clip(0).sum())},
        }
        if s > 1:  # ms covers kernel + plain combine; this is the kernel alone
            rows[name]["partials_kernel_ms"] = split_kernel_ms
        print(f"kernel {name}: " + json.dumps(rows[name]))
        del sets, lib_sets
    edge_shapes(seed)
    torch.cuda.empty_cache()
    return rows


def edge_shapes(seed: int) -> None:
    """Correctness only, off the serving path's shapes: the widest window
    and head_dim the kernel takes, a head_dim that is not a multiple of 4
    (scalar K loads), an odd block size, and a split count that does not
    divide the table — each against the plain version."""
    import numpy as np
    import torch

    from flexflow_tpu_torch.ops.kernels import decode_attention as da

    rs = np.random.RandomState(seed + 7)
    gen = torch.Generator().manual_seed(seed + 7)
    # (B, W, H, D, bs, MB, splits)
    for b, w, h, d, bs, mb, s in [
        (2, 32, 2, 256, 8, 12, 1),
        (3, 17, 3, 100, 5, 20, 1),
        (2, 3, 4, 128, 7, 30, 4),
        (1, 1, 1, 1, 1, 9, 2),
    ]:
        nb = b * mb + 1
        tables = rs.randint(1, nb, (b, mb)).astype(np.int32)
        tables[:, -1] = 0
        base = rs.randint(0, mb * bs - w, b)
        qpos = (base[:, None] + np.arange(w)[None, :]).astype(np.int32)
        qpos[rs.rand(b, w) < 0.2] = -1
        q, k, v, bt, qp = paged_inputs(gen, nb, bs, h, d, tables, qpos, 1)[0]
        got = da.paged_append_attention(q, k, v, bt, qp, kv_splits=s)
        want = da.reference_paged_append_attention(q, k, v, bt, qp)
        err = check_close(f"edge shape B={b} W={w} H={h} D={d} bs={bs} MB={mb} S={s}", got, want)
        print(f"kernel edge shape B={b} W={w} H={h} D={d} bs={bs} MB={mb} S={s}: "
              f"max abs err {err:.3e}")


def gpt2_small():
    from flexflow_tpu_torch.models.transformer import TransformerConfig

    return TransformerConfig(
        num_layers=12, hidden_size=768, num_heads=12, ff_size=3072,
        seq_length=1024, vocab_size=50257, causal=True,
    )


def check_decode_logits(engine, sched, name: str) -> float:
    """Recompute one decode step of the scheduler's live batch twice, on
    clones of the cache: through the kernel path and through the plain
    attention. The logits must agree within LOGITS_ATOL."""
    import torch

    from flexflow_tpu_torch.generation.decoder import decode_step

    order = sorted(sched._running.values(), key=lambda s: s.slot)
    if not order:
        raise AssertionError(f"{name}: no running sequence to check")
    tokens, positions, tables, active = sched._collect_slots(order)[:4]
    tok, pos, bt, ctx = engine.decode_inputs(tokens, positions, tables, active)
    out = {}
    for backend in ("auto", "plain"):
        ck, cv = engine.cache.k.clone(), engine.cache.v.clone()
        logits, _, _ = decode_step(engine.params, tok, pos, ck, cv, bt, ctx, backend=backend)
        out[backend] = logits[torch.from_numpy(active).to(logits.device)]
        del ck, cv
    k, p = out["auto"], out["plain"]
    if k.shape != (len(order), engine.cfg.vocab_size) or not torch.isfinite(k).all():
        raise AssertionError(f"{name}: logits {tuple(k.shape)} not finite / wrong shape")
    err = float((k - p).abs().max())
    scale = float(p.abs().max())
    print(f"{name}: decode logits kernel vs plain attention: max abs err {err:.3e} "
          f"(logits up to {scale:.2f}, {len(order)} live slots)")
    if err > LOGITS_ATOL:
        raise AssertionError(f"{name}: logits differ by {err} > {LOGITS_ATOL}")
    torch.cuda.empty_cache()
    return err


def serve(engine, prompts, samplings):
    """Submit every prompt at once and step the scheduler to the end.
    Returns (handles, wall seconds, per-request TTFT seconds)."""
    import torch

    from flexflow_tpu_torch.generation.scheduler import ContinuousBatchingScheduler

    torch.cuda.synchronize()
    sched = ContinuousBatchingScheduler(engine)
    t0 = time.perf_counter()
    handles = [sched.submit(p, s) for p, s in zip(prompts, samplings)]
    ttft = [None] * len(handles)
    for _ in range(10_000):
        if all(h.done() for h in handles):
            break
        sched.step()  # ends in a device sync (tokens come back to the host)
        now = time.perf_counter()
        for i, h in enumerate(handles):
            if ttft[i] is None and h._request.generated:
                ttft[i] = now - t0
    wall = time.perf_counter() - t0
    if not all(h.done() for h in handles):
        raise AssertionError("requests did not finish")
    return handles, wall, ttft


def serving_phase(seed: int, params):
    """The 4-slot engine behind the scheduler: 8 mixed requests."""
    import numpy as np

    from flexflow_tpu_torch.generation.engine import GenerationEngine, SamplingParams
    from flexflow_tpu_torch.generation.scheduler import ContinuousBatchingScheduler
    from flexflow_tpu_torch.ops.kernels import decode_attention as da

    cfg = gpt2_small()
    engine = GenerationEngine(params, cfg, max_batch_slots=4, block_size=16)
    if engine.cache_config.num_blocks != 257:
        raise AssertionError(f"cache holds {engine.cache_config.num_blocks} blocks, expected 257")
    rs = np.random.RandomState(seed)
    engine.generate([rs.randint(0, cfg.vocab_size, 40).tolist()],
                    SamplingParams(max_new_tokens=4))  # warm-up: cuBLAS and allocator
    lens = [16, 700, 64, 300, 128, 512, 40, 220]
    prompts = [rs.randint(0, cfg.vocab_size, n).tolist() for n in lens]
    samplings = [SamplingParams(max_new_tokens=32)] * 6 + [
        SamplingParams(max_new_tokens=32, temperature=0.8, top_k=50, seed=1234),
        SamplingParams(max_new_tokens=32, temperature=0.8, top_k=50, seed=5678),
    ]
    decode0, dsec0 = engine.step_counts["decode"], engine.step_seconds["decode"]
    da.reset_launch_counts()
    handles, wall, ttft = serve(engine, prompts, samplings)
    launches = dict(da.LAUNCHES)
    steps = engine.step_counts["decode"] - decode0
    outs = [h.result(0) for h in handles]
    for out in outs:
        if len(out) != 32 or not all(0 <= t < cfg.vocab_size for t in out):
            raise AssertionError(f"bad stream {out}")
    if launches["paged_append"] != cfg.num_layers * steps or launches["paged_append_split"] != 0:
        raise AssertionError(
            f"launches {launches} != {cfg.num_layers} layers x {steps} decode steps"
        )
    tokens = sum(len(o) for o in outs)
    stats = {
        "requests": len(outs), "prompt_lens": lens, "new_tokens": tokens,
        "decode_steps": steps, "launches": launches, "wall_s": wall,
        "tokens_per_s": tokens / wall,
        "ttft_p50_s": float(np.median(ttft)), "ttft_max_s": float(max(ttft)),
        "decode_step_ms": 1e3 * (engine.step_seconds["decode"] - dsec0) / steps,
    }
    print("serving (4 slots): " + json.dumps(stats))
    # a live batch's decode step, kernel vs plain attention
    sched = ContinuousBatchingScheduler(engine)
    extra = [sched.submit(rs.randint(0, cfg.vocab_size, n).tolist(), SamplingParams(max_new_tokens=4))
             for n in (100, 37, 250, 16)]
    sched.step()
    stats["logits_max_abs_err"] = check_decode_logits(engine, sched, "serving")
    while not all(h.done() for h in extra):
        sched.step()
    return engine, stats


def anatomy_phase(engine, seed: int):
    """Where a serving run's time goes: torch.profiler over a short run
    of the 4-slot engine (4 requests, 16 new tokens each). Reports the
    device's busy share of the wall time (the sum of the GPU kernel and
    copy durations over the run's wall, profiler overhead included in
    the wall) and the device time by kernel name. ``device_busy_share``
    is null where the profiler saw no device activity."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from flexflow_tpu_torch.generation.engine import SamplingParams

    rs = np.random.RandomState(seed + 2)
    prompts = [rs.randint(0, engine.cfg.vocab_size, n).tolist() for n in (300, 64, 700, 128)]
    samplings = [SamplingParams(max_new_tokens=16)] * 3 + [
        SamplingParams(max_new_tokens=16, temperature=0.8, top_k=50, seed=99)
    ]
    decode0 = engine.step_counts["decode"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall, _ = serve(engine, prompts, samplings)
    steps = engine.step_counts["decode"] - decode0
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_us = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    stats = {
        "wall_s": wall, "decode_steps": steps,
        "device_busy_s": busy_us / 1e6,
        "device_busy_share": (busy_us / 1e6 / wall) if busy_us > 0 else None,
        "top_device_us": {name[:80]: us for name, us in top},
    }
    print("anatomy (profiled, 4 slots): " + json.dumps(stats))
    return stats


def long_context_phase(seed: int, params):
    """One ~900-token stream in a 1-slot engine: the split-KV kernel."""
    import numpy as np

    from flexflow_tpu_torch.generation.engine import GenerationEngine, SamplingParams
    from flexflow_tpu_torch.generation.scheduler import ContinuousBatchingScheduler
    from flexflow_tpu_torch.ops.kernels import decode_attention as da

    cfg = gpt2_small()
    engine = GenerationEngine(params, cfg, max_batch_slots=1, block_size=16)
    rs = np.random.RandomState(seed + 1)
    prompt = rs.randint(0, cfg.vocab_size, 900).tolist()
    decode0, dsec0 = engine.step_counts["decode"], engine.step_seconds["decode"]
    da.reset_launch_counts()
    handles, wall, ttft = serve(engine, [prompt], [SamplingParams(max_new_tokens=32)])
    launches = dict(da.LAUNCHES)
    steps = engine.step_counts["decode"] - decode0
    if launches["paged_append_split"] != cfg.num_layers * steps or steps == 0:
        raise AssertionError(
            f"split launches {launches} != {cfg.num_layers} layers x {steps} decode steps"
        )
    if launches["paged_append"] != 0:
        raise AssertionError(f"single-pass kernel ran in the 1-slot engine: {launches}")
    stats = {
        "prompt_len": len(prompt), "new_tokens": len(handles[0].result(0)),
        "decode_steps": steps, "launches": launches, "wall_s": wall,
        "ttft_s": ttft[0],
        "decode_step_ms": 1e3 * (engine.step_seconds["decode"] - dsec0) / steps,
    }
    print("long context (1 slot): " + json.dumps(stats))
    sched = ContinuousBatchingScheduler(engine)
    h = sched.submit(rs.randint(0, cfg.vocab_size, 880).tolist(), SamplingParams(max_new_tokens=4))
    sched.step()
    stats["logits_max_abs_err"] = check_decode_logits(engine, sched, "long context")
    while not h.done():
        sched.step()
    return stats


def flash_bound(kind: str, b: int, sq: int, sk: int, h: int, d: int, causal: bool):
    """(bound_ms, bound_by, fp32_cuda_core_ms) of one flash kernel call:
    each input read once and each output written once over the card's
    memory rate, against the multiply-adds the kernel does on the
    unmasked (query, key) pairs (2 flops each: QK and PV forward; QK,
    dO.V and dS.K for dQ; QK, dO.V, P^T dO and dS^T Q for dK/dV) taken
    to fp32 accuracy on the tensor cores, three TF32 products each at
    the dense TF32 rate (datasheet figures). fp32_cuda_core_ms is the
    larger of the byte time and those operations at the fp32 CUDA-core
    rate."""
    pairs = b * h * (sq * (sq + 1) // 2 if causal else sq * sk)
    q_elems, kv_elems, rows = b * sq * h * d, b * sk * h * d, b * sq * h
    if kind == "fwd":
        flops = 2 * 2 * d * pairs
        nbytes = 4 * (2 * q_elems + 2 * kv_elems + rows)  # q, o; k, v; lse
    elif kind == "dq":
        flops = 3 * 2 * d * pairs
        nbytes = 4 * (3 * q_elems + 2 * kv_elems + 2 * rows)  # q, dO, dq; k, v; lse, delta
    else:
        flops = 4 * 2 * d * pairs
        nbytes = 4 * (2 * q_elems + 4 * kv_elems + 2 * rows)  # q, dO; k, v, dk, dv; lse, delta
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = TF32_PRODUCTS * flops / H100_TF32_FLOPS * 1e3
    fp32_ms = max(t_bytes, flops / H100_FP32_FLOPS * 1e3)
    return (t_bytes, "bytes", fp32_ms) if t_bytes >= t_ops else (t_ops, "operations", fp32_ms)


def tensor_core_check() -> dict:
    """The built flash library's SASS (cuobjdump -sass) must hold
    tensor-core HMMA instructions in every instance of the forward and
    dK/dV tensor-core kernels; raises where one has none. Returns
    {kernel<head-dim pad>: HMMA count}."""
    from flexflow_tpu_torch.ops.kernels import _build

    src = next(p for p in _build.kernel_sources() if p.name == "flash_attention.cu")
    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(_build.library_path(src))],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : .*?(flash_[a-z_]+_kernel)ILi(\d+)E", line)
        if m:
            name = f"{m.group(1)}<{m.group(2)}>"
            counts[name] = 0
        elif "Function : " in line:
            name = None
        elif name is not None and "HMMA" in line:
            counts[name] += 1
    found = {}
    for kernel in ("flash_fwd_tc_kernel", "flash_bwd_dkv_tc_kernel"):
        inst = {n: c for n, c in counts.items() if n.startswith(kernel + "<")}
        if not inst or not all(inst.values()):
            raise AssertionError(f"{kernel}: no tensor-core HMMA in the SASS of "
                                 f"{inst or 'the built library'}")
        found.update(inst)
    return found


def time_eager_ms(fn, iters: int = 20) -> float:
    """ms per call by CUDA events around ``iters`` eager calls: the
    device's time where the host issues ahead of it, else the host's."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def profiled_device_ms(fn, iters: int = 20) -> float:
    """Device ms per call: the durations of the GPU kernels and copies
    that torch.profiler records over ``iters`` eager calls, summed (one
    stream, so they do not overlap), for a call a CUDA graph cannot
    capture (autograd's backward)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    if us <= 0:
        raise AssertionError("the profiler saw no device activity")
    return us / 1e3 / iters


def flash_inputs(gen, b, sq, sk, h, d, causal, scale, copies=1):
    """``copies`` sets of (q, k, v, dO, lse, delta) on the card; lse and
    delta come from the plain forward."""
    import torch

    from flexflow_tpu_torch.ops.kernels import flash_attention as fa

    sets = []
    for _ in range(copies):
        q = torch.randn((b, sq, h, d), generator=gen).cuda()
        k = torch.randn((b, sk, h, d), generator=gen).cuda()
        v = torch.randn((b, sk, h, d), generator=gen).cuda()
        do = torch.randn((b, sq, h, d), generator=gen).cuda()
        o, lse = fa.reference_flash_forward(q, k, v, causal, scale)
        sets.append((q, k, v, do, lse, fa.flash_delta(do, o)))
    return sets


def check_flash(name, sets, causal, scale):
    """The three kernels against their plain versions on the first set;
    returns {kernel: max abs err}."""
    from flexflow_tpu_torch.ops.kernels import flash_attention as fa

    q, k, v, do, lse, delta = sets[0]
    o, klse = fa.flash_forward_kernel(q, k, v, causal, scale)
    po, plse = fa.reference_flash_forward(q, k, v, causal, scale)
    dq = fa.flash_backward_dq_kernel(q, k, v, do, lse, delta, causal, scale)
    dk, dv = fa.flash_backward_dkv_kernel(q, k, v, do, lse, delta, causal, scale)
    pdq, pdk, pdv = fa.reference_flash_backward(q, k, v, do, lse, delta, causal, scale)
    return {
        "flash_fwd": max(check_close(f"{name} forward o", o, po),
                         check_close(f"{name} forward lse", klse, plse)),
        "flash_bwd_dq": check_close(f"{name} dq", dq, pdq),
        "flash_bwd_dkv": max(check_close(f"{name} dk", dk, pdk), check_close(f"{name} dv", dv, pdv)),
    }


def flash_phase(seed: int):
    """The flash kernels against their plain versions at the training
    shape and edge shapes; device times at the training shape and the
    causal S=512 shape. Returns per-kernel records (launches filled in by
    the training phase)."""
    import torch
    import torch.nn.functional as F

    from flexflow_tpu_torch.ops.kernels import flash_attention as fa

    gen = torch.Generator().manual_seed(seed + 11)
    rows = {}
    for label, (b, s, h, d, causal, copies) in {
        "train": (32, 128, 12, 64, False, 3),  # 3 x 50 MB of q/k/v/dO: past the L2
        "causal512": (4, 512, 12, 64, True, 3),
    }.items():
        scale = d ** -0.5
        sets = flash_inputs(gen, b, s, s, h, d, causal, scale, copies)
        errs = check_flash(f"flash {label}", sets, causal, scale)
        lib_sets = [tuple(t.transpose(1, 2).contiguous() for t in st[:4]) for st in sets]
        for qq, kk, vv, _ in lib_sets:
            for t in (qq, kk, vv):
                t.requires_grad_(True)
        sdpa_fwd, _ = time_ms(
            lambda qq, kk, vv, _do: F.scaled_dot_product_attention(qq, kk, vv, is_causal=causal),
            [tuple(t.detach() for t in st) for st in lib_sets])
        outs = [F.scaled_dot_product_attention(qq, kk, vv, is_causal=causal)
                for qq, kk, vv, _ in lib_sets]
        calls = itertools.count()

        def sdpa_bwd():
            i = next(calls) % len(lib_sets)
            torch.autograd.grad(outs[i], lib_sets[i][:3], lib_sets[i][3], retain_graph=True)

        # SDPA's backward on the device (autograd cannot be captured into a
        # CUDA graph here): its kernels' durations by torch.profiler; the
        # eager figure (host issue included) is kept beside it
        sdpa_bwd_eager_ms = time_eager_ms(sdpa_bwd)
        sdpa_bwd_ms = profiled_device_ms(sdpa_bwd)
        timed = {
            "flash_fwd": (
                lambda q, k, v, do, lse, de: fa.flash_forward_kernel(q, k, v, causal, scale),
                lambda q, k, v, do, lse, de: fa.reference_flash_forward(q, k, v, causal, scale),
                sdpa_fwd, "fwd"),
            "flash_bwd_dq": (
                lambda *a: fa.flash_backward_dq_kernel(*a, causal, scale),
                lambda *a: fa.reference_flash_backward_dq(*a, causal, scale),
                sdpa_bwd_ms, "dq"),
            "flash_bwd_dkv": (
                lambda *a: fa.flash_backward_dkv_kernel(*a, causal, scale),
                lambda *a: fa.reference_flash_backward_dkv(*a, causal, scale),
                sdpa_bwd_ms, "dkv"),
        }
        shape = {"B": b, "S": s, "H": h, "D": d, "causal": causal}
        for name, (kern, plain, lib_ms, kind) in timed.items():
            ms, eager_ms = time_ms(kern, sets)
            plain_ms, _ = time_ms(plain, sets)
            bound_ms, bound_by, fp32_bound_ms = flash_bound(kind, b, s, s, h, d, causal)
            row = {"max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
                   "fp32_cuda_core_bound_ms": fp32_bound_ms,
                   "eager_ms": eager_ms, "shape": shape}
            print(f"flash {label} {name}: " + json.dumps(row))
            rows.setdefault(label, {})[name] = row
        print(f"flash {label}: SDPA forward {sdpa_fwd:.4f} ms, backward (dq, dk, dv together) "
              f"{sdpa_bwd_ms:.4f} ms on the device ({sdpa_bwd_eager_ms:.4f} ms eager)")
        del sets, lib_sets, outs
    # edge shapes, correctness only: ragged S with D = 128, Sq != Sk, D = 256
    # (the CUDA-core forward and dK/dV), one query row, a ragged tile past
    # 64 rows, D = 8
    for b, sq, sk, h, d, causal in [(2, 100, 100, 3, 128, False), (2, 64, 200, 4, 64, False),
                                    (2, 128, 128, 2, 256, False), (2, 1, 1, 3, 64, False),
                                    (2, 65, 65, 3, 64, False), (2, 65, 65, 3, 64, True),
                                    (2, 128, 128, 2, 8, False)]:
        sets = flash_inputs(gen, b, sq, sk, h, d, causal, d ** -0.5)
        tag = f"Sq={sq} Sk={sk} D={d}" + (" causal" if causal else "")
        errs = check_flash(f"flash edge {tag}", sets, causal, d ** -0.5)
        print(f"flash edge B={b} H={h} {tag}: max abs err "
              + json.dumps({k: f"{e:.3e}" for k, e in errs.items()}))
    torch.cuda.empty_cache()
    return rows


def bert_base():
    from flexflow_tpu_torch.models import TransformerConfig

    return TransformerConfig(num_layers=12, hidden_size=768, num_heads=12, ff_size=3072,
                             seq_length=128)


def training_phase(seed: int):
    """BERT-Base width through FFModel -> compile -> fit on the card."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from flexflow_tpu_torch.config import FFConfig
    from flexflow_tpu_torch.core.types import LossType, MetricsType
    from flexflow_tpu_torch.models import build_transformer
    from flexflow_tpu_torch.ops.kernels import flash_attention as fa
    from flexflow_tpu_torch.runtime import SGDOptimizer

    cfg, batch, warm, steps = bert_base(), 32, 2, 10
    t0 = time.perf_counter()
    model = build_transformer(FFConfig(batch_size=batch, seed=seed, printing_interval=5), cfg)
    model.compile(optimizer=SGDOptimizer(lr=0.01), loss_type=LossType.MEAN_SQUARED_ERROR,
                  metrics=[MetricsType.MEAN_SQUARED_ERROR])
    ex = model.executor
    n_params = sum(p.numel() for g in ex.params.values() for p in g.values())
    gen = torch.Generator(device="cuda").manual_seed(seed)
    shape = (batch, cfg.seq_length, cfg.hidden_size)
    x = torch.randn(shape, generator=gen, device="cuda")
    y = torch.randn(shape, generator=gen, device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    # one step from the same weights, kernel attention vs plain attention
    snap = {k: {n: p.detach().clone() for n, p in g.items()} for k, g in ex.params.items()}

    def restore():
        with torch.no_grad():
            for k, g in ex.params.items():
                for n, p in g.items():
                    p.copy_(snap[k][n])

    after = {}
    for backend in ("auto", "plain"):
        restore()
        ex.backend = backend
        fa.reset_launch_counts()
        loss = float(ex.train_batch([x], y)["loss"])
        launches = dict(fa.LAUNCHES)
        after[backend] = (loss, {k: {n: p.detach().clone() for n, p in g.items()}
                                 for k, g in ex.params.items()})
        want = cfg.num_layers if backend == "auto" else 0
        if any(v != want for v in launches.values()):
            raise AssertionError(f"{backend} step launched {launches}, expected {want} each")
    ex.backend = "auto"
    restore()
    (lk, pk), (lp, pp) = after["auto"], after["plain"]
    param_err = max(float((pk[k][n] - pp[k][n]).abs().max()) for k in pk for n in pk[k])
    moved = max(float((pk[k][n] - snap[k][n]).abs().max()) for k in pk for n in pk[k])
    print(f"training: one step, kernel vs plain attention: loss {lk:.7f} vs {lp:.7f}, "
          f"params max abs diff {param_err:.3e} (the step moved them by up to {moved:.3e})")
    if not (np.isfinite(lk) and abs(lk - lp) <= LOSS_RTOL * abs(lp)):
        raise AssertionError(f"train-step loss kernel {lk} vs plain {lp} beyond rtol {LOSS_RTOL}")
    if not 0 < moved or param_err > PARAM_STEP_RTOL * moved:
        raise AssertionError(f"params after one step differ by {param_err}, more than "
                             f"{PARAM_STEP_RTOL} of the step's largest update {moved}")
    del after, snap, pk, pp

    # warm-up, then the timed steps on one random batch (repeated, so the
    # loss of plain gradient descent must fall)
    model.fit(x.repeat(warm, 1, 1), y.repeat(warm, 1, 1), verbose=False)
    xs, ys = x.repeat(steps, 1, 1), y.repeat(steps, 1, 1)
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    model.fit(xs, ys, trace_window=steps)
    launches = dict(fa.LAUNCHES)
    losses = model.step_losses
    for name, n in launches.items():
        if n != cfg.num_layers * steps:
            raise AssertionError(f"{name}: {n} launches in {steps} steps, expected "
                                 f"{cfg.num_layers} per step ({launches})")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"training losses not finite or not falling: {losses}")
    elapsed = model.last_elapsed

    # a profiled pair of steps: the device's busy share and time by kernel
    # (the profiler slows the host, so the share is also taken against the
    # unprofiled step's wall)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tp = time.perf_counter()
        model.fit(x.repeat(2, 1, 1), y.repeat(2, 1, 1), verbose=False)
        prof_wall = time.perf_counter() - tp
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_us = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    groups = {"flash kernels": 0.0, "GEMMs (cuBLAS fp32)": 0.0, "other": 0.0}
    for name, us in by_name.items():
        group = ("flash kernels" if "flash_" in name else
                 "GEMMs (cuBLAS fp32)" if ("gemm" in name or "cutlass" in name) else "other")
        groups[group] += us / 1e3 / 2
    step_device_ms = busy_us / 1e3 / 2
    stats = {
        "layers": cfg.num_layers, "hidden": cfg.hidden_size, "heads": cfg.num_heads,
        "ff": cfg.ff_size, "seq": cfg.seq_length, "batch": batch, "params": n_params,
        "setup_s": setup_s, "warmup_steps": warm, "timed_steps": steps, "elapsed_s": elapsed,
        "step_ms": 1e3 * elapsed / steps, "samples_per_s": steps * batch / elapsed,
        "tokens_per_s": steps * batch * cfg.seq_length / elapsed,
        "loss_first": losses[0], "loss_last": losses[-1], "launches": launches,
        "kernel_vs_plain": {"loss_kernel": lk, "loss_plain": lp, "param_max_abs_diff": param_err,
                            "param_max_update": moved},
        "profiled_steps": 2, "profiled_wall_s": prof_wall, "device_busy_s": busy_us / 1e6,
        "device_busy_share": (busy_us / 1e6 / prof_wall) if busy_us > 0 else None,
        "step_device_ms": step_device_ms,
        # device time of a profiled step over the unprofiled step's wall
        "device_busy_share_of_timed_step": (
            step_device_ms / (1e3 * elapsed / steps) if busy_us > 0 else None),
        "step_device_ms_by_group": groups,
        "top_device_us": {name[:80]: us for name, us in top},
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    print("training (BERT-Base width): " + json.dumps(stats))
    del model, ex, x, y, xs, ys
    torch.cuda.empty_cache()
    return stats


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0, help="seed for weights, prompts and inputs")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from flexflow_tpu_torch.generation.decoder import init_decoder_params
    from flexflow_tpu_torch.ops.kernels import _build

    # full fp32 everywhere: TF32 would move the logits past the checks
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    print(card)
    t0 = time.perf_counter()
    _build.load_library()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.last_build_seconds:.2f} s)")
    for line in _build.last_build_log.splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            print("  ptxas:", line.strip())
    hmma = tensor_core_check()
    print("tensor cores: HMMA instructions in the SASS of " + json.dumps(hmma))

    rows = kernel_phase(args.seed)
    params = init_decoder_params(torch.Generator().manual_seed(args.seed), gpt2_small())
    engine, serving = serving_phase(args.seed, params)
    long_ctx = long_context_phase(args.seed, engine.params)
    anatomy = anatomy_phase(engine, args.seed)
    del engine, params
    torch.cuda.empty_cache()
    flash = flash_phase(args.seed)
    training = training_phase(args.seed)

    def record(name, replaces, row, launches, source=SOURCE):
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        }

    kernels = [
        record("paged_append", "flexflow_tpu/ops/kernels/decode_attention.py:368",
               dict(rows["decode"], max_abs_err=max(rows["decode"]["max_abs_err"],
                                                    rows["append_w5"]["max_abs_err"])),
               serving["launches"]["paged_append"]),
        record("paged_append_split", "flexflow_tpu/ops/kernels/decode_attention.py:338",
               rows["split"], long_ctx["launches"]["paged_append_split"]),
    ] + [
        record(name, f"flexflow_tpu/ops/kernels/flash_attention.py:{line}",
               dict(flash["train"][name], max_abs_err=max(
                   flash["train"][name]["max_abs_err"], flash["causal512"][name]["max_abs_err"])),
               training["launches"][name], FLASH_SOURCE)
        for name, line in (("flash_fwd", 158), ("flash_bwd_dq", 262), ("flash_bwd_dkv", 278))
    ]
    print(json.dumps({"card": card, "serving": serving, "long_context": long_ctx,
                      "anatomy": anatomy, "kernel_shapes": rows, "flash_shapes": flash,
                      "training": training}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
