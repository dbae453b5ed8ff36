#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (flexflow_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each raising on failure (the script then exits non-zero and
prints no result line):

1. device: the card's name and power limit (nvidia-smi), the time to
   build the CUDA kernels from ``flexflow_tpu_torch/ops/kernels/csrc``,
   and the built flash library's SASS (cuobjdump), which must hold
   tensor-core HMMA instructions in every instance of the forward, dQ
   and dK/dV tensor-core kernels, and the CUDA-core dQ only for head
   dims above 128.
2. kernels: each paged attention kernel against its plain PyTorch
   version on the card, fp32, atol 1e-4 + rtol 1e-4 (the kernel sums in
   another order), at the serving path's shapes (with the cluster size
   each launched), at windows past the kernel's 32-query tile (a suffix
   prefill's W = 33, 64, 256 and 1024 from positions 0 and 512, then
   padding queries; 40- and 41-query verify windows over 4 slots; the split
   form at W = 64) and at edge shapes, among them contexts that leave
   blocks of a cluster without a live position, split counts up to the
   table's width, windows of padding only and a 60000-column table
   through both kernels; the split-KV path must run as one device
   kernel; then the device time
   (CUDA events around a replayed CUDA graph of the calls) of the
   kernel, the plain version and one PyTorch library call over the same
   inputs (scaled_dot_product_attention on the gathered K/V, a yardstick
   the port never calls), beside the card's bound.
3. serving: a GPT-2-small-width decoder (12 x 768, 12 heads, vocab
   50257, 1024 positions, random weights from --seed, fp32) behind a
   4-slot engine and the continuous-batching scheduler; 8 requests of
   16-700 prompt tokens and 32 new tokens each (6 greedy, 2 seeded
   temperature 0.8 / top-k 50), through an engine whose steps replay
   captured CUDA graphs (the default) and one built with
   eager_steps=True, in the order graph, eager, eager, graph, each
   engine warmed first with a prompt in every prefill bucket (so every
   graph is captured before the timed runs). The streams of both must be
   identical, the launch counters must show one paged kernel launch per
   layer per decode step, and one decode step's logits must agree with
   the plain attention path within 1e-3.
4. long context: the same model in a 1-slot engine with a ~900-token
   prompt, where the split-KV (flash-decoding) kernel is selected (one
   launch per layer per decode step, combined on-chip); graph and eager
   engines as in 3.
5. step graphs: prefill (four buckets), decode and verify steps replayed
   from their graphs against the same steps run eagerly, at GPT-2-small
   width: tokens, logits and the KV cache bit-identical, one capture per
   signature, num_layers paged launches counted per replay; and the
   device time of the threefry Gumbel draws a decode step ([4, V]) and a
   verify step (2 x [4, 5, V]) make.
6. speculation: 4 slots, k = 4, the n-gram drafter, 4 prompts of
   repeated segments, 48 new greedy tokens each: plain, then speculative
   through the graph engine and through the eager engine. The greedy
   streams must equal the plain ones, decode and verify logits must agree
   with the plain attention path within 1e-3, and the paged launches must
   be num_layers x (decode + verify steps). Reports the verify step ms,
   the acceptance rate and the tokens per verify step.
7. prefix cache: the same model behind 4 slots with the cross-request
   prefix cache on and off, on graph and on eager steps: 8 requests
   sharing a 512-token system prompt (suffixes of 20-480 tokens, and one
   exact repeat, whose boundary block is copied), and a 64-token shared
   prefix with a 700-token suffix (suffix bucket 1024), 32 new tokens
   each (6 greedy + 2 seeded among the 8). Streams must be identical
   on/off and graph/eager, the hit, reuse and copy counters > 0, each
   suffix prefill num_layers paged launches, one capture per suffix
   bucket. Reports TTFT p50 and the prefill step's time per request
   (CUDA events) on and off. Then the host tier: three 512-token
   prefixes cycled twice through an 80-block cache, streams equal to the
   uncached engine's, swaps out and in > 0 (and the pinned
   host-to-device rate beside the swap model's).
   The earlier serving phases run with the cache off: they repeat their
   prompts across runs.
8. anatomy: torch.profiler over a short 4-slot run — the device's busy
   share of the wall time and the device time by kernel; eight decode
   steps of four live slots under the profiler, replayed and eager
   (device and wall ms a step, device kernels a step, one paged kernel a
   layer); then, in the long-context engine, a second stream's replayed
   decode steps under the profiler (device ms and device kernels per
   step, one paged kernel per layer) and ten split-KV attention calls,
   whose device kernels must all be the paged kernel. The profiler runs
   only after the timed phases: once started, it slows the host's later
   launches.
9. flash kernels: the flash-attention forward, dQ and dK/dV kernels
   against their plain PyTorch versions (atol 1e-4 + rtol 1e-4) at the
   training path's shape (B=32, S=128, H=12, D=64) and at a causal
   S=512 shape and edge shapes (S=100 D=128, Sq=64 Sk=200, D=256, S=1,
   S=65 plain and causal, D=8); then device times of kernel, plain
   version and the library yardstick (scaled_dot_product_attention
   forward, and its backward: its kernels' durations by torch.profiler),
   beside the card's bound for fp32-accurate products on the tensor cores
   (and for the same operations on the fp32 CUDA cores).
10. training: BERT-Base width (12 layers, hidden 768, 12 heads, ff 3072,
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
    # windows past the 32-query tile, as a suffix prefill gives them: a
    # causal run from `start` (one sixth of the window left as padding),
    # then padding queries (-1)
    for w in (33, 64, 256, 1024):
        for start in (0, 512):
            n_real = min(w - w // 6, mb * bs - start)
            qpos = np.full((1, w), -1, np.int32)
            qpos[0, :n_real] = start + np.arange(n_real)
            cases[f"wide_w{w}_start{start}"] = (tables_for([start + n_real]), qpos, 1)
    # 40- and 41-query verify windows (41: max_spec_tokens = 40) over four
    # slots, with padding queries and an inactive slot
    for w in (40, 41):
        base = np.asarray([640, 120, 0, 300], np.int32)
        qpos = base[:, None] + np.arange(w, dtype=np.int32)[None, :]
        qpos[1, 20:] = -1
        qpos[2, :] = -1
        cases[f"verify_w{w}"] = (tables_for(base + w), qpos.astype(np.int32), 1)
    # the split form over a 64-query window
    qpos = np.full((1, 64), -1, np.int32)
    qpos[0, :54] = 700 + np.arange(54)
    cases["split_w64"] = (tables_for([754]), qpos, splits)

    rows = {}
    for name, (tables, qpos, s) in cases.items():
        sets = paged_inputs(gen, nb, bs, h, d, tables, qpos, copies)
        q, k, v, bt, qp = sets[0]
        got = da.paged_append_attention(q, k, v, bt, qp, kv_splits=s)
        want = da.reference_paged_append_attention(q, k, v, bt, qp)
        if s == 1:
            err = check_close(f"{name} kernel vs plain", got, want)
            plain = da.reference_paged_append_attention
        else:
            def plain(q_, k_, v_, bt_, qp_, s=s):
                return da._combine_splits(
                    *da.reference_paged_append_partials(q_, k_, v_, bt_, qp_, s),
                    qp_, q_.dtype,
                )

            err = max(check_close(f"{name} kernel vs plain split + combine", got,
                                  plain(q, k, v, bt, qp)),
                      check_close(f"{name} kernel vs single-pass plain", got, want))
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
        # blocks per (head, sequence): the cluster of either kernel
        ctas = da.kernel_cluster_size(mb, bs) if s == 1 else da.split_plan(s, mb)[0]
        rows[name] = {
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "eager_ms": eager_ms, "plain_eager_ms": plain_eager_ms,
            "shape": {"B": int(qpos.shape[0]), "W": int(qpos.shape[1]), "H": h, "D": d,
                      "bs": bs, "MB": mb, "splits": s, "ctas_per_head": ctas,
                      "live_positions": int(np.minimum(qpos.max(1) + 1, mb * bs).clip(0).sum())},
        }
        print(f"kernel {name}: " + json.dumps(rows[name]))
        del sets, lib_sets
    edge_shapes(seed)
    torch.cuda.empty_cache()
    return rows


def device_kernels(fn, calls: int) -> list:
    """Names of the device kernels that ``calls`` calls of ``fn`` run, as
    torch.profiler records them (after a warm-up call). The profiler can
    drop events at the edges of its window, so a caller checks what the
    recorded kernels are, not that each call's last one is there."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def edge_shapes(seed: int) -> None:
    """Correctness only, off the serving path's shapes: the widest window
    and head_dim the kernel takes, a head_dim that is not a multiple of 4
    (4-byte copies), odd block sizes, a cluster that does not divide the
    table, split counts that do not divide it, 16 splits and as many
    splits as columns (blocks taking several splits each), a padding-only
    sequence, contexts that leave blocks of a cluster without a live
    position (0, 1, 15, 16, 17, and one position into the second block's
    share) beside a long one, and a table of 60000 columns through the
    single-pass kernel and the split kernel — each against the plain
    version; padding queries must give exact zeros."""
    import numpy as np
    import torch

    from flexflow_tpu_torch.ops.kernels import decode_attention as da

    rs = np.random.RandomState(seed + 7)
    gen = torch.Generator().manual_seed(seed + 7)

    def check(tag, tables, qpos, h, d, bs, s):
        q, k, v, bt, qp = paged_inputs(gen, tables.shape[0] * tables.shape[1] + 1, bs, h, d,
                                       tables, qpos, 1)[0]
        got = da.paged_append_attention(q, k, v, bt, qp, kv_splits=s)
        want = da.reference_paged_append_attention(q, k, v, bt, qp)
        err = check_close(f"edge shape {tag}", got, want)
        if s > 1:
            partials = da.reference_paged_append_partials(q, k, v, bt, qp, s)
            err = max(err, check_close(f"edge shape {tag} vs plain split + combine", got,
                                       da._combine_splits(*partials, qp, q.dtype)))
            del partials
        pad = torch.from_numpy(qpos < 0).cuda()
        if not bool((got[pad] == 0).all()):
            raise AssertionError(f"edge shape {tag}: padding queries must give exact zeros")
        ctas = (da.kernel_cluster_size(tables.shape[1], bs) if s == 1
                else da.split_plan(s, tables.shape[1])[0])
        print(f"kernel edge shape {tag} ({ctas} blocks a head): max abs err {err:.3e}")

    # (B, W, H, D, bs, MB, splits); the second: a 3-block cluster over 61
    # columns; from the fourth: split counts that do not divide the table,
    # 16 splits and as many splits as columns; the last two: windows of two
    # and of four query tiles (D = 256, odd block sizes)
    for b, w, h, d, bs, mb, s in [
        (2, 32, 2, 256, 8, 12, 1),
        (3, 32, 2, 256, 5, 61, 1),
        (3, 17, 3, 100, 5, 20, 1),
        (2, 3, 4, 128, 7, 30, 4),
        (1, 1, 1, 1, 1, 9, 2),
        (2, 1, 12, 64, 16, 64, 16),
        (2, 1, 12, 64, 16, 64, 64),
        (3, 5, 4, 100, 7, 30, 30),
        (3, 32, 2, 256, 5, 61, 7),
        (2, 33, 2, 256, 5, 30, 1),
        (3, 100, 4, 64, 7, 40, 5),
    ]:
        nb = b * mb + 1
        tables = rs.randint(1, nb, (b, mb)).astype(np.int32)
        tables[:, -1] = 0
        base = rs.randint(0, mb * bs - w, b)
        qpos = (base[:, None] + np.arange(w)[None, :]).astype(np.int32)
        qpos[rs.rand(b, w) < 0.2] = -1
        if b > 2:
            qpos[-1] = -1  # a padding-only sequence
        check(f"B={b} W={w} H={h} D={d} bs={bs} MB={mb} S={s}", tables, qpos, h, d, bs, s)
    # a window of padding only, two query tiles wide, through both kernels
    tables = rs.randint(1, 17, (2, 8)).astype(np.int32)
    for s in (1, 4):
        check(f"all padding B=2 W=70 S={s}", tables, np.full((2, 70), -1, np.int32), 4, 64, 16, s)
    # decode over 64 columns of 16 (8 blocks of 128 positions a cluster)
    mb, bs = 64, 16
    for ctx in (0, 1, 15, 16, 17, 129):
        tables = rs.permutation(np.arange(1, 2 * mb + 1)).reshape(2, mb).astype(np.int32)
        qpos = np.asarray([[ctx - 1], [730]], np.int32)
        check(f"decode contexts {ctx} and 731, MB={mb} bs={bs}", tables, qpos, 12, 64, bs, 1)
        # the split form, whose blocks take fixed column ranges: short
        # contexts leave most of them empty
        check(f"split decode contexts {ctx} and 731, MB={mb} bs={bs}", tables, qpos, 12, 64, bs,
              da.default_kv_splits(2, mb))
    # a table of 60000 columns of one position: a block of either kernel
    # holds at most 2048 table columns in shared memory and reads the rest
    # from device memory
    mb = 60000
    tables = rs.randint(1, mb + 1, (1, mb)).astype(np.int32)
    qpos = np.asarray([[57000, 59999, -1]], np.int32)
    for s in (1, 16, mb):
        check(f"wide table B=1 W=3 H=2 D=64 bs=1 MB={mb} S={s}", tables, qpos, 2, 64, 1, s)


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
    x = engine.decode_arrays(tokens, positions, tables, active)
    tok, pos, bt, ctx = (torch.from_numpy(x[k]).to(engine.device)
                         for k in ("tokens", "positions", "tables", "context_lens"))
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


def serve(engine, prompts, samplings, speculation=None):
    """Submit every prompt at once and step the scheduler to the end.
    Returns (handles, wall seconds, per-request TTFT seconds, scheduler)."""
    import torch

    from flexflow_tpu_torch.generation.scheduler import ContinuousBatchingScheduler

    torch.cuda.synchronize()
    sched = ContinuousBatchingScheduler(engine)
    t0 = time.perf_counter()
    handles = [sched.submit(p, s, speculation=speculation) for p, s in zip(prompts, samplings)]
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
    return handles, wall, ttft, sched


def warm(engine, rs, speculation=None) -> None:
    """A prompt in every prefill bucket through the engine (and decode
    steps, and verify steps with ``speculation``), so every step
    signature is captured — and cuBLAS and the allocator warmed — before
    a timed run."""
    from flexflow_tpu_torch.generation.engine import SamplingParams

    lens = [min(b, engine.max_seq_len - 8) for b in engine.buckets]
    engine.generate([rs.randint(0, engine.cfg.vocab_size, n).tolist() for n in lens],
                    SamplingParams(max_new_tokens=4), speculation=speculation)


def engine_pair(params, **kw):
    """{"graph": an engine replaying captured CUDA graphs (the default),
    "eager": the same engine with eager steps}, sharing the weights. The
    prefix cache is off unless ``prefix_cache=True`` is passed: the
    serving, long-context, step-graph and speculation phases repeat their
    prompts across runs and engines, and with the cache on a repeat would
    reuse the earlier run's blocks (the prefix phase measures that path)."""
    from flexflow_tpu_torch.generation.engine import GenerationEngine

    cfg = gpt2_small()
    kw.setdefault("prefix_cache", False)
    return {"graph": GenerationEngine(params, cfg, **kw),
            "eager": GenerationEngine(params, cfg, eager_steps=True, **kw)}


def run_stats(engine, handles, wall, ttft, decode0, dsec0, launches) -> dict:
    """A timed scheduler run's numbers (engine counters read before it:
    decode0 steps, dsec0 seconds)."""
    import numpy as np

    steps = engine.step_counts["decode"] - decode0
    tokens = sum(len(h.result(0)) for h in handles)
    return {"decode_steps": steps, "launches": launches, "wall_s": wall,
            "new_tokens": tokens, "tokens_per_s": tokens / wall,
            "ttft_p50_s": float(np.median(ttft)), "ttft_max_s": float(max(ttft)),
            "decode_step_ms": 1e3 * (engine.step_seconds["decode"] - dsec0) / max(steps, 1)}


def serving_phase(seed: int, params):
    """The 4-slot engine behind the scheduler: 8 mixed requests, through
    the graph engine and the eager engine in turns (graph, eager, eager,
    graph). Returns (engines, stats)."""
    import numpy as np

    from flexflow_tpu_torch.generation.engine import SamplingParams
    from flexflow_tpu_torch.generation.scheduler import ContinuousBatchingScheduler
    from flexflow_tpu_torch.ops.kernels import decode_attention as da

    cfg = gpt2_small()
    engines = engine_pair(params, max_batch_slots=4, block_size=16)
    if engines["graph"].cache_config.num_blocks != 257:
        raise AssertionError(f"cache holds {engines['graph'].cache_config.num_blocks} blocks, "
                             "expected 257")
    rs = np.random.RandomState(seed)
    for engine in engines.values():
        warm(engine, rs)
    lens = [16, 700, 64, 300, 128, 512, 40, 220]
    prompts = [rs.randint(0, cfg.vocab_size, n).tolist() for n in lens]
    samplings = [SamplingParams(max_new_tokens=32)] * 6 + [
        SamplingParams(max_new_tokens=32, temperature=0.8, top_k=50, seed=1234),
        SamplingParams(max_new_tokens=32, temperature=0.8, top_k=50, seed=5678),
    ]
    runs, streams = {"graph": [], "eager": []}, None
    for name in ("graph", "eager", "eager", "graph"):
        engine = engines[name]
        decode0, dsec0 = engine.step_counts["decode"], engine.step_seconds["decode"]
        da.reset_launch_counts()
        handles, wall, ttft, _ = serve(engine, prompts, samplings)
        launches = dict(da.LAUNCHES)
        stats = run_stats(engine, handles, wall, ttft, decode0, dsec0, launches)
        outs = [h.result(0) for h in handles]
        for out in outs:
            if len(out) != 32 or not all(0 <= t < cfg.vocab_size for t in out):
                raise AssertionError(f"bad stream {out}")
        steps = stats["decode_steps"]
        if launches["paged_append"] != cfg.num_layers * steps or launches["paged_append_split"]:
            raise AssertionError(
                f"{name}: launches {launches} != {cfg.num_layers} layers x {steps} decode steps")
        if streams is None:
            streams = outs
        elif outs != streams:
            raise AssertionError(f"{name} engine's streams differ from the graph engine's")
        runs[name].append(stats)
        print(f"serving (4 slots, {name} steps): " + json.dumps(stats))
    graph = engines["graph"]
    if graph.trace_counts.get("decode") != 1 or graph.recompiles():
        raise AssertionError(f"graph engine signatures {graph.trace_counts}")
    stats = {"requests": len(prompts), "prompt_lens": lens, "graph": runs["graph"],
             "eager": runs["eager"], "launches": runs["graph"][0]["launches"],
             "captures": dict(graph.trace_counts)}
    # a live batch's decode step, kernel vs plain attention
    sched = ContinuousBatchingScheduler(graph)
    extra = [sched.submit(rs.randint(0, cfg.vocab_size, n).tolist(), SamplingParams(max_new_tokens=4))
             for n in (100, 37, 250, 16)]
    sched.step()
    stats["logits_max_abs_err"] = check_decode_logits(graph, sched, "serving")
    while not all(h.done() for h in extra):
        sched.step()
    return engines, stats


def decode_window_profile(engine, seed: int, steps: int = 8) -> dict:
    """``steps`` decode steps of four live slots under torch.profiler:
    device and wall ms a step, the device's busy share of the wall,
    device kernels a step, and num_layers paged kernels a step."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from flexflow_tpu_torch.generation.engine import SamplingParams
    from flexflow_tpu_torch.generation.scheduler import ContinuousBatchingScheduler

    cfg = engine.cfg
    rs = np.random.RandomState(seed + 4)
    sched = ContinuousBatchingScheduler(engine)
    handles = [sched.submit(rs.randint(0, cfg.vocab_size, n).tolist(),
                            SamplingParams(max_new_tokens=steps + 4)) for n in (300, 64, 700, 128)]
    sched.step()  # the four prefills and a first decode
    torch.cuda.synchronize()
    decode0 = engine.step_counts["decode"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            sched.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n = engine.step_counts["decode"] - decode0
    ops = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    paged = sum("paged_append_kernel" in e.name for e in ops)
    if n != steps or paged != cfg.num_layers * n:
        raise AssertionError(f"profiled: {paged} paged kernels in {n} decode steps")
    device_us = sum(e.time_range.elapsed_us() for e in ops)
    while not all(h.done() for h in handles):
        sched.step()
    return {"decode_steps": n, "device_ms_per_step": device_us / 1e3 / n,
            "wall_ms_per_step": 1e3 * wall / n, "device_busy_share": device_us / 1e6 / wall,
            "device_ops_per_step": len(ops) / n, "paged_kernels_per_step": paged / n}


def anatomy_phase(engines, seed: int):
    """Where a serving run's time goes: torch.profiler over a short run
    of the 4-slot graph engine (4 requests, 16 new tokens each). Reports
    the device's busy share of the wall time (the sum of the GPU kernel
    and copy durations over the run's wall, profiler overhead included in
    the wall) and the device time by kernel name; then a window of decode
    steps alone, replayed and eager. ``device_busy_share`` is null where
    the profiler saw no device activity."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from flexflow_tpu_torch.generation.engine import SamplingParams

    engine = engines["graph"]
    rs = np.random.RandomState(seed + 2)
    prompts = [rs.randint(0, engine.cfg.vocab_size, n).tolist() for n in (300, 64, 700, 128)]
    samplings = [SamplingParams(max_new_tokens=16)] * 3 + [
        SamplingParams(max_new_tokens=16, temperature=0.8, top_k=50, seed=99)
    ]
    decode0 = engine.step_counts["decode"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall, _, _ = serve(engine, prompts, samplings)
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
    print("anatomy (profiled, 4 slots, graph steps): " + json.dumps(stats))
    for name in ("graph", "eager"):
        stats[f"decode_window_{name}"] = decode_window_profile(engines[name], seed)
        print(f"anatomy: profiled decode steps, 4 live slots, {name} steps: "
              + json.dumps(stats[f"decode_window_{name}"]))
    return stats


def long_context_phase(seed: int, params):
    """One ~900-token stream in a 1-slot engine: the split-KV kernel,
    graph and eager steps in turns. Returns (stats, graph engine)."""
    import numpy as np

    from flexflow_tpu_torch.generation.engine import SamplingParams
    from flexflow_tpu_torch.generation.scheduler import ContinuousBatchingScheduler
    from flexflow_tpu_torch.ops.kernels import decode_attention as da

    cfg = gpt2_small()
    engines = engine_pair(params, max_batch_slots=1, block_size=16)
    rs = np.random.RandomState(seed + 1)
    for engine in engines.values():
        warm(engine, rs)
    prompt = rs.randint(0, cfg.vocab_size, 900).tolist()
    runs, stream = {"graph": [], "eager": []}, None
    for name in ("graph", "eager", "eager", "graph"):
        engine = engines[name]
        decode0, dsec0 = engine.step_counts["decode"], engine.step_seconds["decode"]
        da.reset_launch_counts()
        handles, wall, ttft, _ = serve(engine, [prompt], [SamplingParams(max_new_tokens=32)])
        launches = dict(da.LAUNCHES)
        stats = run_stats(engine, handles, wall, ttft, decode0, dsec0, launches)
        steps = stats["decode_steps"]
        if launches["paged_append_split"] != cfg.num_layers * steps or steps == 0:
            raise AssertionError(
                f"split launches {launches} != {cfg.num_layers} layers x {steps} decode steps")
        if launches["paged_append"] != 0:
            raise AssertionError(f"single-pass kernel ran in the 1-slot engine: {launches}")
        out = handles[0].result(0)
        if stream is None:
            stream = out
        elif out != stream:
            raise AssertionError(f"{name} engine's long-context stream differs")
        runs[name].append(stats)
        print(f"long context (1 slot, {name} steps): " + json.dumps(stats))
    graph = engines["graph"]
    stats = {"prompt_len": len(prompt), "graph": runs["graph"], "eager": runs["eager"],
             "launches": runs["graph"][0]["launches"]}
    sched = ContinuousBatchingScheduler(graph)
    h = sched.submit(rs.randint(0, cfg.vocab_size, 880).tolist(), SamplingParams(max_new_tokens=4))
    sched.step()
    stats["logits_max_abs_err"] = check_decode_logits(graph, sched, "long context")
    while not h.done():
        sched.step()
    return stats, graph


def long_context_profile(engine, seed: int) -> dict:
    """A second ~880-token stream in the long-context graph engine, its
    replayed decode steps under torch.profiler: device time and device
    kernels per step, with one paged kernel a layer; then attention calls
    of that stream over the engine's cache, whose device kernels must all
    be the paged kernel (the split path runs no PyTorch op after its
    launch). Run after the timed phases and the anatomy: a profiler, once
    started, slows the host's later launches."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from flexflow_tpu_torch.generation.engine import SamplingParams
    from flexflow_tpu_torch.generation.scheduler import ContinuousBatchingScheduler
    from flexflow_tpu_torch.ops.kernels import decode_attention as da

    cfg = engine.cfg
    rs = np.random.RandomState(seed + 3)
    sched = ContinuousBatchingScheduler(engine)
    h = sched.submit(rs.randint(0, cfg.vocab_size, 880).tolist(), SamplingParams(max_new_tokens=12))
    sched.step()  # the prefill
    # the stream's table and positions at the first profiled step
    x = engine.decode_arrays(*sched._collect_slots(list(sched._running.values()))[:4])
    bt = torch.from_numpy(x["tables"]).cuda()
    qp = torch.from_numpy(x["context_lens"][:, None] - 1).cuda()
    decode0 = engine.step_counts["decode"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        while not h.done():
            sched.step()
    steps = engine.step_counts["decode"] - decode0
    ops = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    paged = sum("paged_append_kernel" in e.name for e in ops)
    if steps == 0 or paged != cfg.num_layers * steps:
        raise AssertionError(f"profiled: {paged} paged kernels in {steps} decode steps")
    stats = {
        "decode_steps": steps,
        "device_ms_per_step": sum(e.time_range.elapsed_us() for e in ops) / 1e3 / steps,
        "device_ops_per_step": len(ops) / steps,
        "paged_kernels_per_step": paged / steps,
    }
    print("long context, profiled replayed decode steps: " + json.dumps(stats))
    splits = da.default_kv_splits(bt.shape[0], bt.shape[1])
    q = torch.randn((bt.shape[0], 1, cfg.num_heads, cfg.hidden_size // cfg.num_heads),
                    device=bt.device)
    calls = 10
    launched = device_kernels(lambda: da.paged_append_attention(
        q, engine.cache.k[0], engine.cache.v[0], bt, qp, kv_splits=splits), calls)
    others = sorted({n[:60] for n in launched if "paged_append_kernel" not in n})
    if splits < 2 or not launched or others:
        raise AssertionError(f"{calls} split-path calls (S={splits}) ran {len(launched)} device "
                             f"kernels, other than the paged kernel: {others}")
    stats["split_calls_profiled"] = calls
    stats["split_call_device_kernels"] = sorted({n[:80] for n in launched})
    stats["split_call_kernels_recorded"] = len(launched)
    return stats


def step_graph_phase(engines, seed: int) -> dict:
    """White box, at GPT-2-small width: the same prefill, decode and
    verify steps on the graph engine and the eager engine (the serving
    phase's, warmed) must give the same tokens, logits and KV cache bit
    for bit; each replay counts num_layers paged launches. Then the
    device time of the threefry Gumbel draws of a decode step and of a
    verify step."""
    import numpy as np
    import torch

    from flexflow_tpu_torch.generation import prng
    from flexflow_tpu_torch.generation.engine import SamplingParams, derive_keys, derive_window_keys
    from flexflow_tpu_torch.ops.kernels import decode_attention as da

    graph, eager = engines["graph"], engines["eager"]
    cfg, b, w = graph.cfg, graph.max_batch_slots, graph.spec_window
    layers, mb = cfg.num_layers, graph.max_blocks_per_seq
    rs = np.random.RandomState(seed + 6)
    lens = (40, 100, 300, 700)
    sps = [SamplingParams(), SamplingParams(temperature=0.8, top_k=50, seed=3),
           SamplingParams(), SamplingParams(temperature=1.0, seed=2**31 + 7)]
    tables = np.zeros((b, mb), np.int32)
    tokens = np.zeros((b,), np.int32)
    held = []
    for i, (n, sp) in enumerate(zip(lens, sps)):
        prompt = rs.randint(0, cfg.vocab_size, n).tolist()
        blocks = graph.allocator.allocate(graph.cache_config.blocks_for(n + 40))
        held += blocks
        tables[i, : len(blocks)] = blocks
        tokens[i] = graph.prefill_one(prompt, blocks, sp, 0)
        if eager.prefill_one(prompt, blocks, sp, 0) != tokens[i] or not torch.equal(
                graph.last_logits, eager.last_logits):
            raise AssertionError(f"prefill[{graph.bucket_for(n)}]: replay differs from eager")
    positions = np.asarray(lens, np.int32)
    active = np.ones((b,), bool)
    temps = np.asarray([sp.temperature for sp in sps], np.float32)
    top_ks = np.asarray([sp.top_k for sp in sps], np.int32)
    seeds = np.asarray([sp.seed & 0xFFFFFFFF for sp in sps], np.uint32)
    kinds = {"decode": 0, "verify": 0}
    for step in range(8):
        counts = np.full((b,), 1 + step, np.int32)
        args = (tokens, positions, tables, active, temps, top_ks, seeds, counts)
        da.reset_launch_counts()
        out = graph.decode(*args)
        if da.LAUNCHES["paged_append"] != layers:
            raise AssertionError(f"a decode replay counted {da.LAUNCHES}, expected {layers}")
        if not np.array_equal(out, eager.decode(*args)) or not torch.equal(
                graph.last_logits, eager.last_logits):
            raise AssertionError(f"decode step {step}: replay differs from eager")
        kinds["decode"] += 1
        tokens, positions = out.astype(np.int32), positions + 1
    for step, nd in enumerate(([4, 2, 0, 4], [1, -1, 4, 3], [4, 4, 4, 4])):
        n_draft = np.asarray(nd, np.int32)
        window = np.zeros((b, w), np.int32)
        window[:, 0] = tokens
        window[:, 1:] = rs.randint(0, cfg.vocab_size, (b, w - 1))
        counts = np.full((b,), 20 + step, np.int32)
        args = (window, positions, n_draft, tables, temps, top_ks, seeds, counts)
        da.reset_launch_counts()
        out, n = graph.verify(*args)
        if step > 0 and da.LAUNCHES["paged_append"] != layers:
            raise AssertionError(f"a verify replay counted {da.LAUNCHES}, expected {layers}")
        eout, en = eager.verify(*args)
        if not (np.array_equal(out, eout) and np.array_equal(n, en)
                and torch.equal(graph.last_logits, eager.last_logits)):
            raise AssertionError(f"verify step {step}: replay differs from eager")
        kinds["verify"] += 1
        positions = positions + np.where(n_draft >= 0, n, 0)
        tokens = out[np.arange(b), np.maximum(n - 1, 0)].astype(np.int32)
    idx = torch.tensor(held, device=graph.device)  # the blocks these steps wrote
    if not (torch.equal(graph.cache.k[:, idx], eager.cache.k[:, idx])
            and torch.equal(graph.cache.v[:, idx], eager.cache.v[:, idx])):
        raise AssertionError("the KV caches of the graph and eager engines differ")
    graph.allocator.free(held)
    if graph.recompiles() or graph.trace_counts.get("verify") != 1:
        raise AssertionError(f"graph engine signatures {graph.trace_counts}")
    # the threefry draws on the device, alone (a CUDA graph of 16 calls)
    dev = graph.device
    s_t = torch.from_numpy(seeds.astype(np.int64)).to(dev)
    c_t = torch.arange(b, dtype=torch.int32, device=dev)
    v = cfg.vocab_size
    decode_draw_ms, _ = time_ms(lambda s, c: prng.gumbel(derive_keys(s, c), (v,)), [(s_t, c_t)])

    def verify_draws(s, c):
        keys = derive_window_keys(s, c, w)
        return prng.gumbel(prng.fold_in(keys, 2), (v,)), prng.gumbel(keys, (v,))

    verify_draw_ms, _ = time_ms(verify_draws, [(s_t, c_t)])
    stats = {"checked": {"prefill_buckets": sorted({graph.bucket_for(n) for n in lens}), **kinds},
             "bit_identical": True, "captures": dict(graph.trace_counts),
             "threefry_decode_ms": decode_draw_ms, "threefry_verify_ms": verify_draw_ms}
    print("step graphs: " + json.dumps(stats))
    return stats


def check_verify_logits(engine, sched) -> float:
    """The scheduler's next verify step of its live batch (the drafter's
    proposals, padded with random tokens to as many drafts as the slot's
    blocks hold) on clones of the cache, through the kernel path and the
    plain attention: the logits at every real window position must agree
    within LOGITS_ATOL."""
    import numpy as np
    import torch

    from flexflow_tpu_torch.generation.decoder import verify_step

    sched._plan_speculation()
    sched._grow()  # blocks for each slot's next window, as step() grows them
    order = sorted(sched._running.values(), key=lambda s: s.slot)
    last, start, tables = sched._collect_slots(order)[:3]
    b, w = engine.max_batch_slots, engine.spec_window
    bs = engine.cache_config.block_size
    rs = np.random.RandomState(17)
    window = rs.randint(0, engine.cfg.vocab_size, (b, w)).astype(np.int32)
    window[:, 0] = last
    n_draft = np.full((b,), -1, np.int32)
    for state in order:
        req = state.req
        draft = req.drafter.propose(req.original_prompt + req.generated, w - 1) if req.drafter else []
        window[state.slot, 1: 1 + len(draft)] = draft
        # positions past the slot's blocks would map to scratch block 0,
        # where the slots' writes collide and land in any order
        n_draft[state.slot] = min(w - 1, len(state.blocks) * bs - state.cached_len - 1)
    offs = np.arange(w)[None, :]
    positions = np.where(offs <= n_draft[:, None], start[:, None] + offs, -1).astype(np.int32)
    dev = engine.device
    out = {}
    for backend in ("auto", "plain"):
        ck, cv = engine.cache.k.clone(), engine.cache.v.clone()
        logits, _, _ = verify_step(engine.params, torch.from_numpy(window).to(dev),
                                   torch.from_numpy(positions).to(dev), ck, cv,
                                   torch.from_numpy(tables).to(dev), backend=backend)
        out[backend] = logits[torch.from_numpy(positions >= 0).to(dev)]
        del ck, cv
    if not torch.isfinite(out["auto"]).all():
        raise AssertionError("verify logits not finite")
    err = float((out["auto"] - out["plain"]).abs().max())
    print(f"speculation: verify logits kernel vs plain attention: max abs err {err:.3e} "
          f"({out['auto'].shape[0]} window positions, drafts {n_draft.tolist()})")
    if err > LOGITS_ATOL:
        raise AssertionError(f"verify logits differ by {err} > {LOGITS_ATOL}")
    torch.cuda.empty_cache()
    return err


def speculation_phase(seed: int, params) -> dict:
    """4 slots, k = 4, the n-gram drafter: 4 prompts of repeated segments,
    48 new greedy tokens each, plain and then speculative through the
    graph and the eager engines."""
    import numpy as np

    from flexflow_tpu_torch.generation.engine import SamplingParams
    from flexflow_tpu_torch.generation.scheduler import ContinuousBatchingScheduler
    from flexflow_tpu_torch.generation.speculative import SpeculationConfig
    from flexflow_tpu_torch.ops.kernels import decode_attention as da

    cfg = gpt2_small()
    engines = engine_pair(params, max_batch_slots=4, block_size=16, max_spec_tokens=4)
    spec = SpeculationConfig(k=4)
    rs = np.random.RandomState(seed + 5)
    for engine in engines.values():
        warm(engine, rs)
        warm(engine, rs, speculation=spec)
    prompts = []
    for seg_len, reps in ((24, 4), (40, 3), (16, 6), (60, 2)):
        seg = rs.randint(0, cfg.vocab_size, seg_len).tolist()
        prompts.append(seg * reps + seg[:6])
    greedy = [SamplingParams(max_new_tokens=48)] * len(prompts)
    graph = engines["graph"]
    da.reset_launch_counts()
    decode0, dsec0 = graph.step_counts["decode"], graph.step_seconds["decode"]
    handles, wall, ttft, _ = serve(graph, prompts, greedy)
    plain = run_stats(graph, handles, wall, ttft, decode0, dsec0, dict(da.LAUNCHES))
    plain_streams = [h.result(0) for h in handles]
    print("speculation: plain greedy (graph steps): " + json.dumps(plain))
    runs = {}
    for name in ("graph", "eager"):
        engine = engines[name]
        decode0, dsec0 = engine.step_counts["decode"], engine.step_seconds["decode"]
        verify0, vsec0 = engine.step_counts["verify"], engine.step_seconds["verify"]
        da.reset_launch_counts()
        handles, wall, ttft, sched = serve(engine, prompts, greedy, speculation=spec)
        launches = dict(da.LAUNCHES)
        stats = run_stats(engine, handles, wall, ttft, decode0, dsec0, launches)
        vsteps = engine.step_counts["verify"] - verify0
        steps = stats["decode_steps"] + vsteps
        if [h.result(0) for h in handles] != plain_streams:
            raise AssertionError(f"{name}: speculative greedy streams differ from plain ones")
        if launches["paged_append"] != cfg.num_layers * steps or launches["paged_append_split"]:
            raise AssertionError(f"{name}: launches {launches} != {cfg.num_layers} layers x "
                                 f"({stats['decode_steps']} decode + {vsteps} verify steps)")
        c = sched.counts
        stats.update({
            "verify_steps": vsteps,
            "verify_step_ms": 1e3 * (engine.step_seconds["verify"] - vsec0) / max(vsteps, 1),
            "drafted": c.get("spec_proposed", 0), "accepted": c.get("spec_accepted", 0),
            "acceptance_rate": c.get("spec_accepted", 0) / max(c.get("spec_proposed", 0), 1),
            "tokens_per_verify_step": c.get("spec_emitted", 0) / max(vsteps, 1),
            "tokens_per_slot_window": c.get("spec_emitted", 0) / max(c.get("spec_windows", 0), 1),
        })
        runs[name] = stats
        print(f"speculation (k=4, n-gram, {name} steps): " + json.dumps(stats))
    if graph.trace_counts.get("verify") != 1 or graph.recompiles():
        raise AssertionError(f"graph engine signatures {graph.trace_counts}")
    # a live speculating batch: decode and verify logits, kernel vs plain
    sched = ContinuousBatchingScheduler(graph)
    live = [sched.submit(p, SamplingParams(max_new_tokens=8), speculation=spec) for p in prompts]
    sched.step()
    errs = {"decode": check_decode_logits(graph, sched, "speculation"),
            "verify": check_verify_logits(graph, sched)}
    while not all(h.done() for h in live):
        sched.step()
    return {"prompt_lens": [len(p) for p in prompts], "k": spec.k, "plain": plain,
            "graph": runs["graph"], "eager": runs["eager"], "logits_max_abs_err": errs,
            "launches": runs["graph"]["launches"]}


def instrument_prefills(engine) -> dict:
    """Wrap ``engine.prefill_one``: per prefill step, its time by CUDA
    events around the step (the device is idle before it, as every step
    ends in a sync, so this is the step's span on the device, upload and
    readback included), and per suffix prefill (``prefix_len`` > 0) the
    paged launches it counted. Returns the record lists, which a caller
    empties between runs."""
    import torch

    from flexflow_tpu_torch.ops.kernels import decode_attention as da

    rec = {"prefill_ms": [], "suffix_launches": []}
    prefill_one = engine.prefill_one

    def timed(*a, prefix_len=0, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        launches = da.LAUNCHES["paged_append"]
        start.record()
        out = prefill_one(*a, prefix_len=prefix_len, **kw)
        end.record()
        end.synchronize()
        rec["prefill_ms"].append(start.elapsed_time(end))
        if prefix_len > 0:
            rec["suffix_launches"].append(da.LAUNCHES["paged_append"] - launches)
        return out

    engine.prefill_one = timed
    return rec


def clear_prefix_cache(engine) -> None:
    """Start a run from an empty prefix cache and a full free list (no
    sequence may be running)."""
    engine.prefix_cache.reset()
    engine.allocator.reset()


def h2d_pinned_gb_per_s(nbytes: int = 64 << 20, reps: int = 5) -> float:
    """The host-to-device copy rate from pinned memory, by CUDA events."""
    import torch

    src = torch.empty((nbytes // 4,), dtype=torch.float32, pin_memory=True)
    dst = torch.empty_like(src, device="cuda")
    dst.copy_(src, non_blocking=True)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        dst.copy_(src, non_blocking=True)
    end.record()
    end.synchronize()
    return nbytes * reps / (start.elapsed_time(end) / 1e3) / 1e9


def prefix_phase(seed: int, params) -> dict:
    """Cross-request prefix caching at GPT-2-small width behind the 4-slot
    engine: 8 requests sharing one 512-token system prompt (suffixes of
    20-480 tokens, and one exact repeat: the copy-on-write boundary),
    and a 64-token shared prefix with a 700-token suffix (the 1024 suffix
    bucket), 32 new tokens each. Engines with the cache on and off, on
    graph and on eager steps, each warmed (every step signature captured)
    and cleared before each run. Then the host tier: three 512-token
    prefixes cycled through an 80-block cache."""
    import numpy as np

    from flexflow_tpu_torch.generation.cache import CacheConfig
    from flexflow_tpu_torch.generation.engine import GenerationEngine, SamplingParams
    from flexflow_tpu_torch.ops.kernels import decode_attention as da

    cfg = gpt2_small()
    v, layers = cfg.vocab_size, cfg.num_layers
    rs = np.random.RandomState(seed + 8)
    system = rs.randint(0, v, 512).tolist()
    prompts = [system + rs.randint(0, v, n).tolist() for n in (20, 40, 90, 150, 260, 300, 480)]
    prompts.append(list(system))  # fully covered: the boundary block is copied
    prompts.append(system[:64] + rs.randint(0, v, 700).tolist())  # suffix bucket 1024
    greedy = SamplingParams(max_new_tokens=32)
    samplings = [greedy] * len(prompts)
    samplings[1] = SamplingParams(max_new_tokens=32, temperature=0.8, top_k=50, seed=1234)
    samplings[7] = SamplingParams(max_new_tokens=32, temperature=0.8, top_k=50, seed=5678)
    engines, recs = {}, {}
    wsys = rs.randint(0, v, 512).tolist()  # the warm-up's own system prompt
    warm_prompts = [wsys + rs.randint(0, v, n).tolist() for n in (9, 20, 40, 90, 150, 300)]
    warm_prompts[1:1] = [list(wsys)]
    warm_prompts.append(wsys[:64] + rs.randint(0, v, 700).tolist())
    for on in (True, False):
        for mode in ("graph", "eager"):
            engine = GenerationEngine(params, cfg, max_batch_slots=4, block_size=16,
                                      prefix_cache=on, eager_steps=mode == "eager")
            warm(engine, rs)
            engine.generate(warm_prompts, SamplingParams(max_new_tokens=2))
            engines[on, mode] = engine
            recs[on, mode] = instrument_prefills(engine)
    runs, streams = {}, None
    for on, mode in ((True, "graph"), (False, "graph"), (False, "graph"), (True, "graph"),
                     (True, "eager"), (False, "eager")):
        engine, rec = engines[on, mode], recs[on, mode]
        clear_prefix_cache(engine)
        pc = engine.prefix_cache
        before = pc.snapshot()
        for v_ in rec.values():
            v_.clear()
        decode0, dsec0 = engine.step_counts["decode"], engine.step_seconds["decode"]
        da.reset_launch_counts()
        handles, wall, ttft, _ = serve(engine, prompts, samplings)
        launches = dict(da.LAUNCHES)
        stats = run_stats(engine, handles, wall, ttft, decode0, dsec0, launches)
        after = pc.snapshot()
        delta = {k: after[k] - before[k] for k in (
            "hits", "lookups", "tokens_reused_total", "blocks_reused_total", "cow_copies_total",
            "swaps_in_total", "swaps_out_total", "recompute_fallbacks")}
        n_suffix = len(rec["suffix_launches"])
        name = f"prefix {'on' if on else 'off'}, {mode} steps"
        outs = [h.result(0) for h in handles]
        if streams is None:
            streams = outs
        elif outs != streams:
            raise AssertionError(f"{name}: streams differ from the first run's")
        if any(n != layers for n in rec["suffix_launches"]):
            raise AssertionError(f"{name}: paged launches per suffix prefill "
                                 f"{rec['suffix_launches']}, expected {layers} each")
        want = layers * (stats["decode_steps"] + n_suffix)
        if launches["paged_append"] != want or launches["paged_append_split"]:
            raise AssertionError(f"{name}: launches {launches} != {layers} layers x "
                                 f"({stats['decode_steps']} decode steps + {n_suffix} suffix "
                                 "prefills)")
        if on and not (delta["hits"] > 0 and delta["tokens_reused_total"] > 0
                       and delta["cow_copies_total"] > 0 and n_suffix == delta["hits"]):
            raise AssertionError(f"{name}: prefix counters {delta}, {n_suffix} suffix prefills")
        if not on and (n_suffix or after["lookups"]):
            raise AssertionError(f"{name}: a disabled cache did prefix work: {after}")
        stats.update({
            "prefix": delta, "suffix_prefills": n_suffix,
            "paged_launches_per_suffix_prefill": sorted(set(rec["suffix_launches"])),
            "prefill_steps": len(rec["prefill_ms"]),
            "prefill_ms_per_request": float(np.mean(rec["prefill_ms"])),
            "prefill_ms_p50": float(np.median(rec["prefill_ms"])),
            "prefill_ms_total": float(np.sum(rec["prefill_ms"])),
        })
        runs.setdefault(name, []).append(stats)
        print(f"{name}: " + json.dumps(stats))
    graph = engines[True, "graph"]
    captures = {k: n for k, n in graph.trace_counts.items() if k.startswith("prefix_prefill")}
    if not captures or any(n != 1 for n in captures.values()) or graph.recompiles():
        raise AssertionError(f"graph engine signatures {graph.trace_counts}")
    # the host tier: three 512-token prefixes cycled through 80 usable
    # blocks (two prefixes and a live request fill it), so the coldest
    # prefix is offloaded to the host and swapped back in when it returns
    h2d = h2d_pinned_gb_per_s()
    small = GenerationEngine(
        params, cfg, cache_config=CacheConfig(num_layers=layers, num_heads=cfg.num_heads,
                                              head_dim=cfg.hidden_size // cfg.num_heads,
                                              num_blocks=81, block_size=16),
        max_batch_slots=4, block_size=16)
    off = engines[False, "graph"]
    clear_prefix_cache(off)
    prefixes = [rs.randint(0, v, 512).tolist() for _ in range(3)]
    tier_prompts = [p + rs.randint(0, v, 16).tolist() for _ in range(2) for p in prefixes]
    tier_sp = [greedy, samplings[1], greedy] * 2
    for prompt, sp in zip(tier_prompts, tier_sp):
        got = small.generate([prompt], sp)
        if got != off.generate([prompt], sp):
            raise AssertionError("host tier: a stream differs from the uncached engine's")
    tier = small.prefix_cache.snapshot()
    if not (tier["swaps_out_total"] > 0 and tier["swaps_in_total"] > 0):
        raise AssertionError(f"host tier: no offload and swap-in: {tier}")
    host = {k: tier[k] for k in ("swaps_out_total", "swaps_in_total", "recompute_fallbacks",
                                 "swap_in_failures", "hits", "tokens_reused_total",
                                 "offloaded_blocks", "host_bytes")}
    host.update(requests=len(tier_prompts), cache_blocks=80,
                host_link_bytes_per_s_model=small.prefix_cache.host_link_bytes_per_s,
                h2d_pinned_gb_per_s_measured=h2d)
    print("prefix host tier: " + json.dumps(host))
    return {"prompt_lens": [len(p) for p in prompts], "runs": runs,
            "captures": captures, "host_tier": host,
            "launches": runs["prefix on, graph steps"][0]["launches"]}


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
    tensor-core HMMA instructions in every instance of the forward, dQ
    and dK/dV tensor-core kernels, and the CUDA-core dQ must exist only
    for head dims above 128 (5..8 columns of 32); raises otherwise.
    Returns {kernel<head-dim pad>: HMMA count}."""
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
    for kernel in ("flash_fwd_tc_kernel", "flash_bwd_dq_tc_kernel", "flash_bwd_dkv_tc_kernel"):
        inst = {n: c for n, c in counts.items() if n.startswith(kernel + "<")}
        if not inst or not all(inst.values()):
            raise AssertionError(f"{kernel}: no tensor-core HMMA in the SASS of "
                                 f"{inst or 'the built library'}")
        found.update(inst)
    simt_dq = sorted(int(n[n.index("<") + 1:-1]) for n in counts
                     if n.startswith("flash_bwd_dq_kernel<"))
    if simt_dq != [5, 6, 7, 8]:
        raise AssertionError(f"CUDA-core dQ instances {simt_dq}: expected only D > 128 (5..8)")
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
    from flexflow_tpu_torch.generation.decoder import init_decoder_params, params_to
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
    params = params_to(params, "cuda")  # one copy on the card, shared by every engine
    engines, serving = serving_phase(args.seed, params)
    long_ctx, long_engine = long_context_phase(args.seed, params)
    graphs = step_graph_phase(engines, args.seed)
    speculation = speculation_phase(args.seed, params)
    prefix = prefix_phase(args.seed, params)
    anatomy = anatomy_phase(engines, args.seed)
    long_ctx["profiled"] = long_context_profile(long_engine, args.seed)
    del engines, long_engine, params
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

    single = [r for name, r in rows.items() if r["shape"]["splits"] == 1]
    kernels = [
        record("paged_append", "flexflow_tpu/ops/kernels/decode_attention.py:368",
               dict(rows["decode"], max_abs_err=max(r["max_abs_err"] for r in single)),
               serving["launches"]["paged_append"] + speculation["launches"]["paged_append"]
               + prefix["launches"]["paged_append"]),
        record("paged_append_split", "flexflow_tpu/ops/kernels/decode_attention.py:338",
               rows["split"], long_ctx["launches"]["paged_append_split"]),
    ] + [
        record(name, f"flexflow_tpu/ops/kernels/flash_attention.py:{line}",
               dict(flash["train"][name], max_abs_err=max(
                   flash["train"][name]["max_abs_err"], flash["causal512"][name]["max_abs_err"])),
               training["launches"][name], FLASH_SOURCE)
        for name, line in (("flash_fwd", 158), ("flash_bwd_dq", 262), ("flash_bwd_dkv", 278))
    ]
    for label, run in (("graph", "graph"), ("eager", "eager")):
        print(f"{card}: 4-slot serving, {label} steps: decode step ms "
              + ", ".join(f"{r['decode_step_ms']:.3f}" for r in serving[run])
              + "; TTFT p50 s " + ", ".join(f"{r['ttft_p50_s']:.4f}" for r in serving[run])
              + "; tokens/s " + ", ".join(f"{r['tokens_per_s']:.1f}" for r in serving[run]))
        print(f"{card}: 1-slot long context, {label} steps: decode step ms "
              + ", ".join(f"{r['decode_step_ms']:.3f}" for r in long_ctx[run]))
        sp = speculation[run]
        print(f"{card}: speculation k=4, {label} steps: verify step ms {sp['verify_step_ms']:.3f}, "
              f"acceptance {sp['acceptance_rate']:.4f}, tokens per verify step "
              f"{sp['tokens_per_verify_step']:.3f}, tokens/s {sp['tokens_per_s']:.1f}")
        for on in ("on", "off"):
            rs_ = prefix["runs"][f"prefix {on}, {label} steps"]
            print(f"{card}: shared 512-token system prompt, prefix cache {on}, {label} steps: "
                  "TTFT p50 s " + ", ".join(f"{r['ttft_p50_s']:.4f}" for r in rs_)
                  + "; prefill step ms per request "
                  + ", ".join(f"{r['prefill_ms_per_request']:.3f}" for r in rs_)
                  + "; tokens/s " + ", ".join(f"{r['tokens_per_s']:.1f}" for r in rs_))
    for name, r in rows.items():
        if name.startswith(("wide", "verify_w4", "split_w64")):
            print(f"{card}: paged kernel {name} ms {r['ms']:.4f} (bound {r['bound_ms']:.4f} "
                  f"by {r['bound_by']}, plain {r['plain_ms']:.4f}, SDPA {r['library_ms']:.4f})")
    print(json.dumps({"card": card, "serving": serving, "long_context": long_ctx,
                      "step_graphs": graphs, "speculation": speculation, "prefix": prefix,
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
