#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (flexflow_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each raising on failure (the script then exits non-zero and
prints no result line):

1. device: the card's name and power limit (nvidia-smi), and the time
   to build the CUDA kernels from ``flexflow_tpu_torch/ops/kernels/csrc``.
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

Prints a ``{"kernels": [...]}`` line, then, as its last line,
``{"ok": true, "device": {...}}``. Needs one CUDA device; exits non-zero
without one.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_FP32_FLOPS = 67e12  # fp32 outside the tensor cores, H100 SXM data sheet
ATOL = 1e-4
RTOL = 1e-4
LOGITS_ATOL = 1e-3
SOURCE = "flexflow_tpu_torch/ops/kernels/csrc/paged_attention.cu"


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

    rows = kernel_phase(args.seed)
    params = init_decoder_params(torch.Generator().manual_seed(args.seed), gpt2_small())
    engine, serving = serving_phase(args.seed, params)
    long_ctx = long_context_phase(args.seed, engine.params)
    anatomy = anatomy_phase(engine, args.seed)

    def record(name, replaces, row, launches):
        return {
            "name": name, "route": "cuda", "source": SOURCE, "replaces": replaces,
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
    ]
    print(json.dumps({"card": card, "serving": serving, "long_context": long_ctx,
                      "anatomy": anatomy, "kernel_shapes": rows}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
