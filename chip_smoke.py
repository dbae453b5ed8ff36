#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (flexflow_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each raising on failure (the script then exits non-zero and
prints no result line):

1. device: the card's name and power limit (nvidia-smi), the time to
   build the CUDA kernels from ``flexflow_tpu_torch/ops/kernels/csrc``,
   and the built flash library's SASS (cuobjdump), which must hold
   tensor-core HMMA instructions in every instance of the forward, dQ
   and dK/dV tensor-core kernels (fp32, bf16, fp16) and HGMMA in every
   instance of their bf16 and fp16 wgmma bodies, and the CUDA-core dQ
   only for head dims above 128; and the paged library's, which must hold HMMA in
   every instance of the paged kernel's tensor-core body (3 cache forms
   x single-pass and split x 3 head-dim pads) and none in its CUDA-core
   body.
2. kernels: each paged attention kernel against its plain PyTorch
   version on the card, in each form (an fp32, a bf16 and an fp16 cache
   under fp32 queries: both sides widen K and V exactly and compute in
   fp32), atol 1e-4 + rtol 1e-4 (the kernel sums in another order), at
   the serving path's shapes (with the cluster size
   each launched), at a suffix prefill's windows (W = 16, 32, 33, 64,
   256, 512 and 1024 from positions 0 and 512, then padding queries;
   40- and 41-query verify windows over 4 slots; the split form at
   W = 64: from W = 9 at D <= 128 the tensor-core body) and at edge shapes, among them contexts that leave
   blocks of a cluster without a live position, split counts up to the
   table's width, windows of padding only and a 60000-column table
   through both kernels; the split-KV path must run as one device
   kernel; then the device time
   (CUDA events around a replayed CUDA graph of the calls) of the
   kernel, the plain version and one PyTorch library call over the same
   inputs (scaled_dot_product_attention on the gathered K/V, a yardstick
   the port never calls; for a 2-byte cache in that dtype with q cast to
   it, a lower-precision function timed for speed only), beside the
   card's bound (K and V at their element size) for the body the window
   runs: fp32 operations on the CUDA cores, or three TF32 products (two
   over a 2-byte cache) on the tensor cores; both are printed.
3. serving: a GPT-2-small-width decoder (12 x 768, 12 heads, vocab
   50257, 1024 positions, random weights from --seed, fp32) behind a
   4-slot engine and the continuous-batching scheduler (its default: the
   overlap pipeline on); 8 requests of
   16-700 prompt tokens and 32 new tokens each (6 greedy, 2 seeded
   temperature 0.8 / top-k 50), through an engine whose steps replay
   captured CUDA graphs (the default) and one built with
   eager_steps=True, in the order graph, eager, eager, graph, each
   engine warmed first with a prompt in every prefill bucket (so every
   graph is captured before the timed runs). The streams of both must be
   identical, the launch counters must show one paged kernel launch per
   layer per decode step, and one decode step's logits must agree with
   the plain attention path within 1e-3.
4. kv dtype: the serving cell over a bf16 KV cache of 257 blocks (half
   the fp32 cell's bytes), graph and eager engines from zeroed caches:
   identical streams, bit-identical caches and last logits, one bf16
   kernel launch per layer per decode step and no fp32 one; greedy
   streams equal to plain attention over the same cache dtype (tokens
   equal to the fp32 cache's run printed, not gated); a decode step's
   logits vs plain attention within 1e-3; a decode step's device time,
   fp32 and bf16 engines in turns; greedy and k = 4 speculative streams
   equal, with decode and verify logits vs plain; the long-context
   request (split-KV, S = 8); the host tier (three 512-token prefixes
   cycled twice through 80 blocks: swaps out and in, streams equal to the
   uncached engine's). Then fp16: 4 requests with speculation (decode
   and verify steps) and a long context, with the logits gates.
5. long context: the same model in a 1-slot engine with a ~900-token
   prompt, where the split-KV (flash-decoding) kernel is selected (one
   launch per layer per decode step, combined on-chip); graph and eager
   engines as in 3.
6. step graphs: prefill (four buckets), decode and verify steps replayed
   from their graphs against the same steps run eagerly, at GPT-2-small
   width: tokens, logits and the KV cache bit-identical, one capture per
   signature, num_layers paged launches counted per replay; and the
   device time of the threefry Gumbel draws a decode step ([4, V]) and a
   verify step (2 x [4, 5, V]) make.
7. speculation: 4 slots, k = 4, the n-gram drafter, 4 prompts of
   repeated segments, 48 new greedy tokens each: plain, then speculative
   through the graph engine and through the eager engine. The greedy
   streams must equal the plain ones, decode and verify logits must agree
   with the plain attention path within 1e-3, and the paged launches must
   be num_layers x (decode + verify steps). Reports the verify step ms,
   the acceptance rate and the tokens per verify step.
8. prefix cache: the same model behind 4 slots with the cross-request
   prefix cache on and off, on graph and on eager steps: 8 requests
   sharing a 512-token system prompt (suffixes of 20-480 tokens, and one
   exact repeat, whose boundary block is copied), and a 64-token shared
   prefix with a 700-token suffix (suffix bucket 1024), 32 new tokens
   each (6 greedy + 2 seeded among the 8). Streams must be identical
   on/off and graph/eager, the hit, reuse and copy counters > 0, each
   suffix prefill num_layers paged launches, one capture per suffix
   bucket. Reports TTFT p50 and the prefill step's time per request
   (CUDA events) on and off, and the suffix prefill's by suffix bucket. Then the host tier: three 512-token
   prefixes cycled twice through an 80-block cache, streams equal to the
   uncached engine's, swaps out and in > 0 (and the pinned
   host-to-device rate beside the swap model's).
   The earlier serving phases run with the cache off: they repeat their
   prompts across runs.
9. overlap + recovery: the 4-slot serving cell (the serving phase's
   request lengths and samplings) through the graph engine with the
   overlap pipeline on and off (on, off, off, on, after a warm-up):
   streams identical across the four runs and to the eager engine's
   sequential run, the pipeline engaged (dispatches > 0, drains by
   reason, no discards), one capture per signature, 12 paged launches per
   decode step, and a carried step's logits within 1e-3 of the plain
   attention path; tokens/s and TTFT p50 on and off; the steady stretch
   (4 slots x 128 steps, nothing non-steady; 32 steps on eager steps):
   ms per step, the stream's time per step (CUDA events around each
   launch), and the device's busy share: a decode step's device time
   (its graph replayed back to back right after the window) over the ms
   per step, with the SM clock and power read just after, on and off. Then recovery on the card: a
   decode-step crash and an async-readback error (each an engine reset
   and journal replay: ``donate`` is set on a CUDA engine) and a NaN on
   one slot (quarantine): surviving streams equal the fault-free ones,
   the expected resets, the cache tensors unmoved, nothing captured
   again.
10. constrained decoding: a 50257-entry token table (the port's default
   table, which stops at 1422 entries, then three-character fillers), a
   JSON-schema grammar ({"ok": boolean, "n": integer}) and a regex grammar
   ([a-z]{1,8}-[0-9]{2,4}) compiled against it (seconds printed); the
   serving cell's 8 request lengths as prefixes of one random sequence,
   4 constrained (2 greedy, 2 at temperature 0.8 / top-k 50) and 4
   unconstrained, 32 new tokens each, through the graph engine (overlap
   on, off, and again on), the eager engine, the graph engine with greedy
   n-gram speculation (k = 4) and a graph engine with the prefix cache on
   (the constrained admissions become masked suffix prefills). Every
   constrained text must parse as its grammar says, the streams must be
   identical across all runs (under speculation the greedy ones), each
   step num_layers paged launches, and no run may capture anything (each
   engine first served the same requests unconstrained). A masked decode
   step and a masked verify step (legal drafts) must agree with the plain
   attention path plus the same grammar rows within 1e-3. Then the decode
   step's ms with four unconstrained slots (overlap off and on) and with
   one constrained slot (an endless [a-z ]+ grammar), the mask bytes
   written per step, and a mask_advance error that must quarantine one
   constrained request while the rest equal the fault-free run.
11. anatomy: torch.profiler over a short 4-slot run — the device's busy
   share of the wall time and the device time by kernel; eight decode
   steps of four live slots under the profiler, replayed and eager
   (device and wall ms a step, device kernels a step, one paged kernel a
   layer); then, in the long-context engine, a second stream's replayed
   decode steps under the profiler (device ms and device kernels per
   step, one paged kernel per layer) and ten split-KV attention calls,
   whose device kernels must all be the paged kernel; then the prefix
   cell's W = 1024 suffix prefill (a 700-token suffix after a cached
   64-token prefix) through graph engines over fp32, bf16 and fp16
   caches, whose paged kernels must all be the tensor-core body of the
   cache's form, by name, with its device ms and launches by window. The
   profiler runs only after the timed phases: once started, it slows the
   host's later launches.
12. flash kernels: the flash-attention forward, dQ and dK/dV kernels,
   float32, bf16 and fp16 forms, against their plain PyTorch versions
   (fp32: atol 1e-4 + rtol 1e-4; bf16 and fp16: within one ulp of the
   type at the plain value plus 1e-3, the logsumexp at the fp32 gate) at
   the training path's shape (B=32, S=128, H=12, D=64) and at a causal
   S=512 shape and edge shapes (S=100 D=128, Sq=64 Sk=200, D=256, S=1,
   S=65 plain and causal, D=8, D=300 and D=512; bf16 at D=33, Sq != Sk,
   D=256 and D=512; fp16 at a sample of those), fp16 where its range
   matters (most of P below 2^-14, |dS| past 65504, dS of order 1e-6;
   gated at one ulp + 1e-3 of each output's largest |value|),
   and multihead attention's core with v's head dim other than q's (the
   kernels on zero-padded head dims, all forms, forward and gradients);
   then device times of kernel, plain version and the library yardstick
   (scaled_dot_product_attention forward, and its backward: its kernels'
   durations by torch.profiler) in the same dtype, beside the card's
   bound (fp32: fp32-accurate products on the tensor cores, and the same
   operations on the fp32 CUDA cores; bf16 and fp16: 2-byte tensors,
   the dense bf16 / fp16 rate).
13. training: BERT-Base width (12 layers, hidden 768, 12 heads, ff 3072,
   seq 128, batch 32, weights from --seed) through FFModel -> compile
   (SGD lr 0.01, MSE) -> fit, first in fp32, then bf16 (``bench.py``'s
   cell: bf16 parameters and activations), then fp16 (DataType.HALF: no
   master weights and no loss scaling, as in the JAX package): one step
   with the kernels and
   one with the plain attention from the same weights must agree (fp32:
   loss rtol 1e-5, parameters within 1e-3 of the step's largest update;
   bf16 and fp16: loss rtol 2^-8 and 2^-11, each parameter within 2 ulps
   of the type plus 1/8 of its tensor's update), and every parameter
   must keep its type; then warm-up and 10 timed steps on one random
   batch, where each flash launch counter of the cell's form must rise
   by 12 per step, all on the wgmma bodies for bf16 and fp16, and the
   other forms' stay 0, and the loss must fall; and a profiled pair of
   steps for the device's busy share and the device time by kernel group
   (the flash kernels, cuBLAS GEMMs, elementwise and other).

Prints a ``{"kernels": [...]}`` line, then, as its last line,
``{"ok": true, "device": {...}}``. Needs one CUDA device; exits non-zero
without one.
"""
from __future__ import annotations

import argparse
import contextlib
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
H100_BF16_FLOPS = 989e12  # dense bf16 (and fp16) on the tensor cores, H100 SXM data sheet
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
# bf16 or fp16 outputs of a kernel against its plain version: within one
# unit in the last place of the type at the plain value plus this (both
# sum in fp32, in other orders, and round once to the type)
HALF_ATOL = 1e-3
# the fp16 range cases (check_fp16_range): in place of HALF_ATOL, this
# share of the output's largest |plain value| (about one ulp there), since
# HALF_ATOL would pass outputs of order 1e-6 whatever they held
HALF_RANGE_SHARE = 1e-3
# the 2-byte types: (stored mantissa bits, exponent of the smallest normal)
HALF_BITS = {"bfloat16": (7, -126), "float16": (10, -14)}
# the bf16 and fp16 training steps, kernel vs plain attention: the loss
# within the type's unit roundoff (2^-8, 2^-11) relative; each parameter
# within 2 ulps of the type (the update is rounded once, and the two
# float32 results may straddle a rounding boundary) plus this share of the
# step's largest update (a gradient summed over 4096 rows of 2-byte values
# rounded in other places)
HALF_LOSS_RTOL = {"bfloat16": 2.0 ** -8, "float16": 2.0 ** -11}
HALF_PARAM_SHARE = 1 / 8


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


def half_ulp(x, dtype):
    """The spacing of ``dtype`` (bfloat16 or float16) values at |x|, no
    finer than at the type's smallest normal (fp16's subnormals are
    spaced 2^-24), as float32."""
    import torch

    bits, low = HALF_BITS[str(dtype)[6:]]
    return torch.exp2(torch.floor(torch.log2(x.float().abs().clamp_min(1e-30))).clamp_min(low)
                      - bits)


def check_half(name: str, got, want, atol: float = HALF_ATOL) -> float:
    """bf16 or fp16 ``got`` against the plain ``want`` of the same type:
    within one ulp of the type at the plain value plus ``atol``.
    Returns the max abs error."""
    import torch

    if (got.shape != want.shape or got.dtype != want.dtype
            or got.dtype not in (torch.bfloat16, torch.float16)):
        raise AssertionError(f"{name}: {got.dtype} {tuple(got.shape)} vs plain "
                             f"{want.dtype} {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite output")
    err = (got.float() - want.float()).abs()
    bad = err > half_ulp(want, got.dtype) + atol
    if bad.any():
        raise AssertionError(f"{name}: {int(bad.sum())} elements beyond 1 ulp + {atol:.3g}; "
                             f"max abs err {float(err.max()):.3e}")
    return float(err.max())


def range_atol(want) -> float:
    """check_half's ``atol`` for an fp16 range case: HALF_RANGE_SHARE of
    the largest |plain value|."""
    return HALF_RANGE_SHARE * float(want.float().abs().max())


# a flash kernel form's launch-count suffix by input dtype name
FLASH_FORMS = {"float32": "", "bfloat16": "_bf16", "float16": "_f16"}


def paged_inputs(gen, num_blocks, bs, heads, head_dim, tables_np, qpos_np, copies,
                 kv_dtype=None):
    """``copies`` distinct (q, k_cache, v_cache, block_tables, q_positions)
    sets on the card, sharing tables and positions; fp32 q, caches of
    ``kv_dtype`` (fp32 by default)."""
    import torch

    dev = torch.device("cuda")
    kv_dtype = kv_dtype or torch.float32
    b, w = qpos_np.shape
    tables = torch.from_numpy(tables_np).to(dev)
    qpos = torch.from_numpy(qpos_np).to(dev)
    sets = []
    for _ in range(copies):
        k = torch.randn((num_blocks, bs, heads, head_dim), generator=gen).to(dev, kv_dtype)
        v = torch.randn((num_blocks, bs, heads, head_dim), generator=gen).to(dev, kv_dtype)
        q = torch.randn((b, w, heads, head_dim), generator=gen).to(dev)
        sets.append((q, k, v, tables, qpos))
    return sets


def bound(qpos_np, max_blocks, bs, heads, head_dim, kv_bytes=4):
    """{body: (bound_ms, bound_by)} of one paged append attention call:
    bytes of q, the live K/V rows (each read once, ``kv_bytes`` an
    element), the tables, the positions and the output, over the card's
    memory rate; against the operations QK and PV need for these
    positions, in fp32 on the CUDA cores ("cuda_cores", the fp32 rate)
    or to fp32 accuracy on the tensor cores ("tensor_cores": three TF32
    products each over an fp32 cache, two over a 2-byte one, at the
    dense TF32 rate, as the kernel's tensor-core body takes them)."""
    import numpy as np

    b, w = qpos_np.shape
    live = np.minimum(qpos_np.max(axis=1) + 1, max_blocks * bs).clip(min=0)
    nbytes = (
        4 * 2 * b * w * heads * head_dim  # q in, output out
        + kv_bytes * 2 * int(live.sum()) * heads * head_dim  # K and V rows
        + 4 * (b * max_blocks + b * w)  # tables, positions
    )
    flops = 4 * int((qpos_np + 1).clip(min=0).sum()) * heads * head_dim
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    products = TF32_PRODUCTS if kv_bytes == 4 else TF32_PRODUCTS - 1
    out = {}
    for body, t_ops in (("cuda_cores", flops / H100_FP32_FLOPS * 1e3),
                        ("tensor_cores", products * flops / H100_TF32_FLOPS * 1e3)):
        out[body] = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return out


def sdpa_inputs(sets):
    """The library yardstick's inputs: K/V gathered contiguous per
    sequence, [B, H, S, D], in the cache's dtype, q cast to it (for a
    2-byte cache a lower-precision function: a speed yardstick only),
    and the same position mask [B, 1, W, S]."""
    import torch

    out = []
    for q, k, v, tables, qpos in sets:
        b, mb = tables.shape
        kk = k[tables.long()].reshape(b, mb * k.shape[1], *k.shape[2:]).transpose(1, 2)
        vv = v[tables.long()].reshape(b, mb * v.shape[1], *v.shape[2:]).transpose(1, 2)
        pos = torch.arange(kk.shape[2], device=q.device)
        mask = (pos[None, None, :] <= qpos[:, :, None])[:, None]
        out.append((q.to(k.dtype).transpose(1, 2).contiguous(), kk.contiguous(), vv.contiguous(),
                    mask))
    return out


def kv_forms():
    """(cache dtype, launch-count and row suffix) of each paged kernel form:
    fp32, bf16, fp16."""
    from flexflow_tpu_torch.ops.kernels import decode_attention as da

    return tuple((dtype, count) for dtype, (_, count) in da._FORMS.items())


def kernel_phase(seed: int):
    """Each kernel form (fp32, bf16 and fp16 caches) against its plain
    version, then times. Returns the per-kernel records, keyed by shape
    and form suffix (launches filled in by the serving phases)."""
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
    # suffix buckets (16, 32, 512) and windows past a query tile (33, 64,
    # 256, 1024), as a suffix prefill gives them: a causal run from
    # `start` (one sixth of the window left as padding), then padding
    # queries (-1)
    for w in (16, 32, 33, 64, 256, 512, 1024):
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
    for (kv_dtype, form), (case, (tables, qpos, s)) in itertools.product(kv_forms(),
                                                                         cases.items()):
        name = case + form
        sets = paged_inputs(gen, nb, bs, h, d, tables, qpos, copies, kv_dtype)
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
        # the body this window runs, and its bound; the other body's beside it
        body = da.kernel_body(qpos.shape[1], d)
        bounds = bound(qpos, mb, bs, h, d, kv_bytes=k.element_size())
        bound_ms, bound_by = bounds[body]
        # blocks per (head, sequence) of the split kernel, or of the
        # single-pass CUDA-core body (the tensor-core body sizes its own)
        ctas = (da.split_plan(s, mb)[0] if s > 1
                else da.kernel_cluster_size(mb, bs) if body == "cuda_cores" else None)
        rows[name] = {
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms, "body": body,
            "cuda_core_bound_ms": bounds["cuda_cores"][0],
            "tensor_core_bound_ms": bounds["tensor_cores"][0],
            "eager_ms": eager_ms, "plain_eager_ms": plain_eager_ms,
            "shape": {"B": int(qpos.shape[0]), "W": int(qpos.shape[1]), "H": h, "D": d,
                      "bs": bs, "MB": mb, "splits": s, "ctas_per_head": ctas,
                      "kv_dtype": str(kv_dtype).replace("torch.", ""),
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
    version, every case in the fp32, bf16 and fp16 forms (the wide table
    in fp32 and bf16); padding queries must give exact zeros."""
    import numpy as np
    import torch

    from flexflow_tpu_torch.ops.kernels import decode_attention as da

    rs = np.random.RandomState(seed + 7)
    gen = torch.Generator().manual_seed(seed + 7)

    def check(tag, tables, qpos, h, d, bs, s, forms=kv_forms()):
        for kv_dtype, form in forms:
            check_form(f"{tag}{form}", tables, qpos, h, d, bs, s, kv_dtype)

    def check_form(tag, tables, qpos, h, d, bs, s, kv_dtype):
        q, k, v, bt, qp = paged_inputs(gen, tables.shape[0] * tables.shape[1] + 1, bs, h, d,
                                       tables, qpos, 1, kv_dtype)[0]
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
        # head dims past 256 (the 512-wide instances): decode, verify
        # window, split, and a 32-query tile at D = 384
        (2, 1, 2, 512, 16, 20, 1),
        (2, 5, 2, 512, 16, 20, 1),
        (2, 5, 2, 512, 16, 20, 4),
        (2, 40, 2, 384, 8, 12, 1),
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
        check(f"wide table B=1 W=3 H=2 D=64 bs=1 MB={mb} S={s}", tables, qpos, 2, 64, 1, s,
              kv_forms()[:2])


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


def serve(engine, prompts, samplings, speculation=None, overlap=None):
    """Submit every prompt at once and step the scheduler (the overlap
    pipeline on unless ``overlap=False``) to the end. Returns (handles,
    wall seconds, per-request TTFT seconds, scheduler)."""
    import torch

    from flexflow_tpu_torch.generation.scheduler import ContinuousBatchingScheduler

    torch.cuda.synchronize()
    sched = ContinuousBatchingScheduler(engine, overlap=overlap)
    t0 = time.perf_counter()
    handles = [sched.submit(p, s, speculation=speculation) for p, s in zip(prompts, samplings)]
    ttft = [None] * len(handles)
    for _ in range(10_000):
        if all(h.done() for h in handles):
            break
        sched.step()  # tokens of this or the previous step come back to the host
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
    decode0 steps, dsec0 seconds). ``decode_call_ms`` is the engine's
    host time inside its decode calls per step (``step_seconds``): a whole
    step on the sequential loop, but only the dispatch and the wait at
    consume on the overlap pipeline, so it is not a step time there; the
    overlap phase's steady stretch gives the step time, on and off."""
    import numpy as np

    steps = engine.step_counts["decode"] - decode0
    tokens = sum(len(h.result(0)) for h in handles)
    return {"decode_steps": steps, "launches": launches, "wall_s": wall,
            "new_tokens": tokens, "tokens_per_s": tokens / wall,
            "ttft_p50_s": float(np.median(ttft)), "ttft_max_s": float(max(ttft)),
            "decode_call_ms": 1e3 * (engine.step_seconds["decode"] - dsec0) / max(steps, 1)}


def serving_phase(seed: int, params):
    """The 4-slot engine behind the scheduler: 8 mixed requests, through
    the graph engine and the eager engine in turns (graph, eager, eager,
    graph). Returns (engines, stats, (prompts, samplings, streams))."""
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
    return engines, stats, (prompts, samplings, streams)


def decode_window_profile(engine, seed: int, steps: int = 8) -> dict:
    """``steps`` decode steps of four live slots under torch.profiler:
    device and wall ms a step, the device's busy share of the wall,
    device kernels a step, and num_layers paged kernels a step. The steps
    run sequentially (``overlap=False``): with a replay queued behind a
    running one, the profiler now and then drops a run of kernel records
    (``flexflow_tpu_torch/tools/profile_loss_probe.py`` counts
    such windows, pipelined and sequential), and the kernel count per
    step below is exact."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from flexflow_tpu_torch.generation.engine import SamplingParams
    from flexflow_tpu_torch.generation.scheduler import ContinuousBatchingScheduler

    cfg = engine.cfg
    rs = np.random.RandomState(seed + 4)
    sched = ContinuousBatchingScheduler(engine, overlap=False)
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
    started, slows the host's later launches. The steps run sequentially,
    for the reason :func:`decode_window_profile` gives."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from flexflow_tpu_torch.generation.engine import SamplingParams
    from flexflow_tpu_torch.generation.scheduler import ContinuousBatchingScheduler
    from flexflow_tpu_torch.ops.kernels import decode_attention as da

    cfg = engine.cfg
    rs = np.random.RandomState(seed + 3)
    sched = ContinuousBatchingScheduler(engine, overlap=False)
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


def suffix_prefill_bodies(seed: int, params) -> dict:
    """The prefix cell's long suffix in each cache form: a 700-token
    suffix after a cached 64-token prefix (suffix bucket W = 1024) through
    a 4-slot graph engine over an fp32, a bf16 and an fp16 cache. The
    suffix prefill replayed from its graph runs under torch.profiler: its
    device kernels must include the paged kernel's tensor-core body of
    the cache's form (by name) and no CUDA-core paged kernel. Reports that
    step's device ms (CUDA events) and the form's launches by window over
    the run (the counts set to 0 just before it). Run after the timed
    phases: a profiler, once started, slows the host's later launches."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from flexflow_tpu_torch.core.types import DataType
    from flexflow_tpu_torch.generation.cache import CacheConfig
    from flexflow_tpu_torch.generation.engine import GenerationEngine, SamplingParams
    from flexflow_tpu_torch.ops.kernels import decode_attention as da

    cfg = gpt2_small()
    layers, v = cfg.num_layers, cfg.vocab_size
    rs = np.random.RandomState(seed + 13)
    system = rs.randint(0, v, 64).tolist()
    one = SamplingParams(max_new_tokens=1)
    out = {}
    for dtype, ctype, form in ((DataType.FLOAT, "float", ""),
                               (DataType.BFLOAT16, "__nv_bfloat16", "_bf16"),
                               (DataType.HALF, "__half", "_f16")):
        cc = CacheConfig(num_layers=layers, num_heads=cfg.num_heads,
                         head_dim=cfg.hidden_size // cfg.num_heads, num_blocks=257,
                         block_size=16, dtype=dtype)
        engine = GenerationEngine(params, cfg, cache_config=cc, max_batch_slots=4,
                                  prefix_cache=True)
        prefill_one, seen = engine.prefill_one, {}

        def profiled(prompt, *a, prefix_len=0, **kw):
            if prefix_len == 0 or "names" in seen:
                return prefill_one(prompt, *a, prefix_len=prefix_len, **kw)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                start.record()
                token = prefill_one(prompt, *a, prefix_len=prefix_len, **kw)
                end.record()
                torch.cuda.synchronize()
            seen["bucket"] = engine.bucket_for(len(prompt) - prefix_len)
            seen["ms"] = start.elapsed_time(end)
            seen["names"] = sorted({e.name for e in prof.events()
                                    if e.device_type == torch.autograd.DeviceType.CUDA
                                    and "paged_append" in e.name})
            return token

        prompts = [system + rs.randint(0, v, 700).tolist() for _ in range(3)]
        engine.generate(prompts[:1], one)  # registers the prefix's blocks
        engine.generate(prompts[1:2], one)  # the suffix prefill's capture
        engine.prefill_one = profiled
        da.reset_launch_counts()
        engine.generate(prompts[2:], one)  # its replay, profiled
        engine.prefill_one = prefill_one
        names = seen.get("names", [])
        tc = [n for n in names if f"paged_append_tc_kernel<{ctype}, false, 64>" in n]
        if seen.get("bucket") != 1024 or not tc or len(tc) != len(names):
            raise AssertionError(f"{ctype} cache: the W = 1024 suffix prefill (bucket "
                                 f"{seen.get('bucket')}) ran paged kernels {names}, expected "
                                 "the tensor-core body only")
        by_window = {k: n for k, n in da.LAUNCHES_BY_WINDOW.items() if n}
        if by_window != {f"paged_append{form} W>=9": layers}:
            raise AssertionError(f"{ctype} cache: launches by window {by_window}, expected "
                                 f"{layers} of the wide body")
        out[ctype] = {"bucket": seen["bucket"], "suffix_prefill_device_ms": seen["ms"],
                      "device_kernels": [n[:90] for n in names],
                      "launches_by_window": by_window, "launches": dict(da.LAUNCHES)}
        print(f"suffix prefill W=1024, {ctype} cache: " + json.dumps(out[ctype]))
        del engine
        torch.cuda.empty_cache()
    return out


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
        c = sched.spec_stats.counts()
        stats.update({
            "verify_steps": vsteps,
            "verify_step_ms": 1e3 * (engine.step_seconds["verify"] - vsec0) / max(vsteps, 1),
            "drafted": c["proposed"], "accepted": c["accepted"],
            "acceptance_rate": c["accepted"] / max(c["proposed"], 1),
            "tokens_per_verify_step": c["emitted"] / max(vsteps, 1),
            "tokens_per_slot_window": c["emitted"] / max(c["windows"], 1),
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
    paged launches it counted and (suffix bucket W, ms). Returns the
    record lists, which a caller empties between runs."""
    import torch

    from flexflow_tpu_torch.ops.kernels import decode_attention as da

    rec = {"prefill_ms": [], "suffix_launches": [], "suffix_ms": []}
    prefill_one = engine.prefill_one

    def timed(prompt, *a, prefix_len=0, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        launches = da.LAUNCHES["paged_append"]
        start.record()
        out = prefill_one(prompt, *a, prefix_len=prefix_len, **kw)
        end.record()
        end.synchronize()
        rec["prefill_ms"].append(start.elapsed_time(end))
        if prefix_len > 0:
            rec["suffix_launches"].append(da.LAUNCHES["paged_append"] - launches)
            rec["suffix_ms"].append((engine.bucket_for(len(prompt) - prefix_len),
                                     rec["prefill_ms"][-1]))
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
        stats["launches_by_window"] = {k: n for k, n in da.LAUNCHES_BY_WINDOW.items() if n}
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
            # device ms of a suffix prefill step, by its suffix bucket W
            "suffix_prefill_ms_by_bucket": {
                str(w): float(np.mean([ms for b, ms in rec["suffix_ms"] if b == w]))
                for w in sorted({b for b, _ in rec["suffix_ms"]})},
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


def check_pipelined_logits(engine, seed: int) -> float:
    """Drive a 4-slot scheduler with the overlap pipeline until a step is
    in flight whose tokens were carried on the device from its
    predecessor; once it completes, its logits (the graph's output, not
    yet overwritten) must agree with the plain attention path over the
    same inputs (the carried tokens as the host now knows them) within
    LOGITS_ATOL."""
    import numpy as np
    import torch

    from flexflow_tpu_torch.generation.decoder import decode_step
    from flexflow_tpu_torch.generation.engine import SamplingParams
    from flexflow_tpu_torch.generation.scheduler import ContinuousBatchingScheduler

    cfg = engine.cfg
    rs = np.random.RandomState(seed + 6)
    sched = ContinuousBatchingScheduler(engine)
    handles = [sched.submit(rs.randint(0, cfg.vocab_size, n).tolist(),
                            SamplingParams(max_new_tokens=12)) for n in (100, 37, 250, 16)]
    for _ in range(4):
        sched.step()
    f = sched._pipe
    if f is None or sched.pipe_dispatches < 2:
        raise AssertionError("overlap: no carried step in flight")
    torch.cuda.synchronize()
    got = f.handle.handle.extra  # this step's logits (+ its zero bias)
    tokens = np.zeros_like(f.positions)
    for s in f.states:
        tokens[s.slot] = s.req.generated[-1]  # the carried token, consumed since
    x = engine.decode_arrays(tokens, f.positions, f.tables, f.active)
    tok, pos, bt, ctx = (torch.from_numpy(x[k]).to(engine.device)
                         for k in ("tokens", "positions", "tables", "context_lens"))
    ck, cv = engine.cache.k.clone(), engine.cache.v.clone()
    want, _, _ = decode_step(engine.params, tok, pos, ck, cv, bt, ctx, backend="plain")
    del ck, cv
    act = torch.from_numpy(f.active).to(engine.device)
    got, want = got[act], want[act]
    if not torch.isfinite(got).all():
        raise AssertionError("overlap: pipelined logits not finite")
    err = float((got - want).abs().max())
    print(f"overlap: a carried decode step's logits vs plain attention: max abs err "
          f"{err:.3e} ({int(act.sum())} live slots)")
    if err > LOGITS_ATOL:
        raise AssertionError(f"overlap: pipelined logits differ by {err} > {LOGITS_ATOL}")
    while not all(h.done() for h in handles):
        sched.step()
    torch.cuda.empty_cache()
    return err


@contextlib.contextmanager
def plain_attention():
    """The decoder's paged attention through the plain PyTorch version (no
    kernel launch) while the block runs. For an eager engine only: a
    graph captured inside would hold the plain version's ops."""
    from flexflow_tpu_torch.generation import decoder

    saved = decoder.decode_attention_core, decoder.append_attention_core

    def plain(core):
        return lambda *a, **kw: core(*a, **{**kw, "backend": "plain"})

    decoder.decode_attention_core, decoder.append_attention_core = map(plain, saved)
    try:
        yield
    finally:
        decoder.decode_attention_core, decoder.append_attention_core = saved


def launched_only(expected: dict) -> dict:
    """The launch counts since the last reset: each form named in
    ``expected`` launched exactly that many times (at least once), every
    other form none."""
    from flexflow_tpu_torch.ops.kernels import decode_attention as da

    got = dict(da.LAUNCHES)
    want = {name: expected.get(name, 0) for name in got}
    if got != want or not all(expected.values()):
        raise AssertionError(f"launches {got}, expected {want}")
    return got


def kv_dtype_phase(seed: int, params, cell, fp32_engine) -> dict:
    """Serving from a 2-byte KV cache at GPT-2-small width: a bf16 cache of
    257 blocks of 16 (the serving cell's blocks, half its bytes) behind
    graph and eager 4-slot engines, then a shorter fp16 run. Returns the
    phase's numbers and the main-path launches of each 2-byte form."""
    import numpy as np
    import torch

    from flexflow_tpu_torch.core.types import DataType
    from flexflow_tpu_torch.generation.cache import CacheConfig
    from flexflow_tpu_torch.generation.engine import GenerationEngine, SamplingParams
    from flexflow_tpu_torch.generation.scheduler import ContinuousBatchingScheduler
    from flexflow_tpu_torch.generation.speculative import SpeculationConfig
    from flexflow_tpu_torch.ops.kernels import decode_attention as da

    cfg = gpt2_small()
    layers, v = cfg.num_layers, cfg.vocab_size
    prompts, samplings, fp32_streams = cell
    rs = np.random.RandomState(seed + 12)
    spec = SpeculationConfig(k=4)
    launches = {f"paged_append{split}{form}": 0
                for form in ("_bf16", "_f16") for split in ("", "_split")}

    def cache(dtype, num_blocks=257):
        return CacheConfig(num_layers=layers, num_heads=cfg.num_heads,
                           head_dim=cfg.hidden_size // cfg.num_heads,
                           num_blocks=num_blocks, block_size=16, dtype=dtype)

    def steps(engine, kinds=("decode",)):
        return sum(engine.step_counts[k] for k in kinds)

    def paged_calls(engine):
        """Decode and verify steps, and (a graph engine) the warm-up run
        before each capture of a step that launches the paged kernel:
        one launch a layer each."""
        captures = sum(n for k, n in engine.trace_counts.items()
                       if k in ("decode", "verify") or k.startswith("prefix_prefill"))
        return steps(engine, ("decode", "verify")) + (captures if engine.graphs else 0)

    by_window = {name: 0 for name in da.LAUNCHES_BY_WINDOW
                 if name.split(" ")[0] in launches}

    def main_path(run, expected):
        """``run()`` with the counts set to 0 just before and read just
        after: only ``expected(...)``'s forms launched."""
        da.reset_launch_counts()
        result = run()
        for name, n in launched_only(expected()).items():
            if name in launches:
                launches[name] += n
        for name in by_window:
            by_window[name] += da.LAUNCHES_BY_WINDOW[name]
        return result

    def seg_prompts(n):
        out = []
        for seg_len, reps in ((24, 4), (40, 3), (16, 6), (60, 2))[:n]:
            seg = rs.randint(0, v, seg_len).tolist()
            out.append(seg * reps + seg[:6])
        return out

    def speculate(engine, name, form, new_tokens):
        """Greedy, then k = 4 n-gram speculation over the same requests:
        equal streams, kernel launches per decode and verify step, and a
        live speculating batch's decode and verify logits vs plain
        attention."""
        sp_prompts = seg_prompts(4)
        greedy = [SamplingParams(max_new_tokens=new_tokens)] * len(sp_prompts)
        p0 = paged_calls(engine)
        handles = main_path(lambda: serve(engine, sp_prompts, greedy)[0],
                            lambda: {"paged_append" + form: layers * (paged_calls(engine) - p0)})
        plain = [h.result(0) for h in handles]
        p0, v0, vs0 = paged_calls(engine), steps(engine, ("verify",)), engine.step_seconds["verify"]
        handles = main_path(
            lambda: serve(engine, sp_prompts, greedy, speculation=spec)[0],
            lambda: {"paged_append" + form: layers * (paged_calls(engine) - p0)})
        vsteps = steps(engine, ("verify",)) - v0
        if [h.result(0) for h in handles] != plain or vsteps == 0:
            raise AssertionError(f"{name}: speculative greedy streams differ from plain ones "
                                 f"({vsteps} verify steps)")
        sched = ContinuousBatchingScheduler(engine)
        live = [sched.submit(p, SamplingParams(max_new_tokens=8), speculation=spec)
                for p in sp_prompts]
        sched.step()
        errs = {"decode": check_decode_logits(engine, sched, f"{name} speculation"),
                "verify": check_verify_logits(engine, sched)}
        while not all(h.done() for h in live):
            sched.step()
        return {"verify_steps": vsteps,
                "verify_step_ms": 1e3 * (engine.step_seconds["verify"] - vs0) / vsteps,
                "logits_max_abs_err": errs}

    def long_context(dtype, name, form, new_tokens):
        """One ~900-token stream in a 1-slot engine: the split-KV kernel of
        the cache's form, num_layers launches a decode step, and a decode
        step's logits vs plain attention."""
        cc = CacheConfig.for_slots(num_layers=layers, num_heads=cfg.num_heads,
                                   head_dim=cfg.hidden_size // cfg.num_heads,
                                   max_seq_len=cfg.seq_length, max_batch_slots=1,
                                   block_size=16, dtype=dtype)
        engine = GenerationEngine(params, cfg, cache_config=cc, max_batch_slots=1,
                                  prefix_cache=False)
        prompt = rs.randint(0, v, 900).tolist()
        p0 = paged_calls(engine)
        main_path(lambda: serve(engine, [prompt], [SamplingParams(max_new_tokens=new_tokens)]),
                  lambda: {"paged_append_split" + form: layers * (paged_calls(engine) - p0)})
        sched = ContinuousBatchingScheduler(engine)
        h = sched.submit(rs.randint(0, v, 880).tolist(), SamplingParams(max_new_tokens=4))
        sched.step()
        err = check_decode_logits(engine, sched, f"{name} long context")
        while not h.done():
            sched.step()
        return {"prompt_len": len(prompt), "logits_max_abs_err": err}

    out = {}
    # the bf16 cell: graph and eager engines, each from a zeroed cache
    engines = engine_pair(params, cache_config=cache(DataType.BFLOAT16), max_batch_slots=4,
                          max_spec_tokens=4)
    graph, eager = engines["graph"], engines["eager"]
    if (graph.cache.k.dtype != torch.bfloat16
            or 2 * graph.cache.k.nbytes != fp32_engine.cache.k.nbytes):
        raise AssertionError(f"bf16 cache {graph.cache.k.dtype}, {graph.cache.k.nbytes} bytes "
                             f"against the fp32 cell's {fp32_engine.cache.k.nbytes}")
    warm(graph, rs)
    warm(graph, rs, speculation=spec)
    runs, streams = {}, {}
    for name, engine in (("graph", graph), ("eager", eager)):
        engine.reset()
        d0, p0, dsec0 = steps(engine), paged_calls(engine), engine.step_seconds["decode"]
        handles, wall, ttft, _ = main_path(
            lambda: serve(engine, prompts, samplings),
            lambda: {"paged_append_bf16": layers * (paged_calls(engine) - p0)})
        runs[name] = run_stats(engine, handles, wall, ttft, d0, dsec0, dict(da.LAUNCHES))
        streams[name] = [h.result(0) for h in handles]
        print(f"kv dtype bf16 (4 slots, {name} steps): " + json.dumps(runs[name]))
    if streams["graph"] != streams["eager"]:
        raise AssertionError("bf16 cache: graph and eager streams differ")
    for t in ("k", "v"):  # past scratch block 0, where colliding padding writes land in any order
        if not torch.equal(getattr(graph.cache, t)[:, 1:], getattr(eager.cache, t)[:, 1:]):
            raise AssertionError(f"bf16 cache: graph replays and eager steps wrote different {t}")
    if not torch.equal(graph.last_logits, eager.last_logits):
        raise AssertionError("bf16 cache: the last step's logits differ, graph vs eager")
    # the same requests with plain attention over the same cache dtype
    eager.reset()
    with plain_attention():
        da.reset_launch_counts()
        handles = serve(eager, prompts, samplings)[0]
        if any(da.LAUNCHES.values()):
            raise AssertionError(f"plain attention launched kernels: {da.LAUNCHES}")
    plain = [h.result(0) for h in handles]
    greedy = [i for i, sp in enumerate(samplings) if sp.temperature <= 0]
    if [plain[i] for i in greedy] != [streams["graph"][i] for i in greedy]:
        raise AssertionError("bf16 cache: greedy streams differ from plain attention's")
    tokens = sum(len(s) for s in fp32_streams)
    out.update({
        "cache_bytes": 2 * graph.cache.k.nbytes,
        "fp32_cache_bytes": 2 * fp32_engine.cache.k.nbytes,
        "runs": runs,
        "tokens_equal_to_plain_attention": sum(
            a == b for x, y in zip(plain, streams["graph"]) for a, b in zip(x, y)),
        "tokens_equal_to_fp32_cache": sum(
            a == b for x, y in zip(fp32_streams, streams["graph"]) for a, b in zip(x, y)),
        "tokens": tokens,
    })
    sched = ContinuousBatchingScheduler(graph)
    extra = [sched.submit(rs.randint(0, v, n).tolist(), SamplingParams(max_new_tokens=4))
             for n in (100, 37, 250, 16)]
    sched.step()
    out["logits_max_abs_err"] = check_decode_logits(graph, sched, "kv dtype bf16")
    while not all(h.done() for h in extra):
        sched.step()
    # a 4-slot decode step's device time, its graph replayed back to back:
    # the fp32 cell's engine and the bf16 one in turns
    order = (("fp32", fp32_engine), ("bf16", graph), ("bf16", graph), ("fp32", fp32_engine))
    device_ms = {"fp32": [], "bf16": []}
    for label, engine in order:
        device_ms[label].append(decode_graph_device_ms(engine))
    out["decode_step_device_ms"] = device_ms
    out["speculation"] = speculate(graph, "kv dtype bf16", "_bf16", 24)
    out["long_context"] = long_context(DataType.BFLOAT16, "kv dtype bf16", "_bf16", 16)
    # the host tier over a bf16 cache: the prefix cell's three 512-token
    # prefixes cycled twice through 80 blocks, streams equal to the
    # uncached bf16 engine's
    small = GenerationEngine(params, cfg, cache_config=cache(DataType.BFLOAT16, 81),
                             max_batch_slots=4)
    prefixes = [rs.randint(0, v, 512).tolist() for _ in range(3)]
    tier_prompts = [p + rs.randint(0, v, 16).tolist() for _ in range(2) for p in prefixes]
    tier_sp = [SamplingParams(max_new_tokens=32), samplings[-1],
               SamplingParams(max_new_tokens=32)] * 2
    before = small.prefix_cache.snapshot()
    s0, g0 = paged_calls(small), paged_calls(graph)

    def tier():
        for prompt, sp in zip(tier_prompts, tier_sp):
            if small.generate([prompt], sp) != graph.generate([prompt], sp):
                raise AssertionError("bf16 host tier: a stream differs from the uncached engine's")

    hits = lambda: small.prefix_cache.snapshot()["hits"] - before["hits"]  # noqa: E731
    main_path(tier, lambda: {"paged_append_bf16": layers * (
        paged_calls(small) - s0 + paged_calls(graph) - g0 + hits())})
    snap = small.prefix_cache.snapshot()
    host = {k: snap[k] - before[k] for k in ("swaps_out_total", "swaps_in_total",
                                              "recompute_fallbacks", "hits")}
    if not (host["swaps_out_total"] > 0 and host["swaps_in_total"] > 0):
        raise AssertionError(f"bf16 host tier: no offload and swap-in: {host}")
    host["host_bytes_per_block"] = small.cache_config.bytes_per_block
    out["host_tier"] = host
    print("kv dtype bf16 host tier: " + json.dumps(host))
    del engines, graph, eager, small, sched
    torch.cuda.empty_cache()
    # fp16: a shorter run, decode and verify steps, and a long context
    half = GenerationEngine(params, cfg, cache_config=cache(DataType.HALF), max_batch_slots=4,
                            max_spec_tokens=4, prefix_cache=False)
    out["fp16"] = {"speculation": speculate(half, "kv dtype fp16", "_f16", 16),
                   "long_context": long_context(DataType.HALF, "kv dtype fp16", "_f16", 8)}
    del half
    torch.cuda.empty_cache()
    out["launches"] = launches
    out["launches_by_window"] = by_window
    print("kv dtype: " + json.dumps(out))
    return out


def card_clocks() -> str:
    """The card's SM clock and power draw now (nvidia-smi)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


class LaunchTimer:
    """CUDA events around every launch of an engine's decode step while
    it is entered: around each replay of the captured decode graph (graph
    steps) or each run of the decode body (eager steps). ``seconds()``
    sums the stream's time from each opening event to its closing one."""

    def __init__(self, engine):
        self.engine, self.marks = engine, []

    def _timed(self, fn):
        import torch

        def launch(*args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args)
            end.record()
            self.marks.append((start, end))
            return out
        return launch

    def __enter__(self):
        engine = self.engine
        if engine.graphs:
            self.step = engine._steps._steps[
                ("decode", (engine.max_batch_slots, engine.max_blocks_per_seq))]
            self.graph = self.step.graph
            timed = self._timed(self.graph.replay)
            self.step.graph = type("TimedGraph", (), {"replay": staticmethod(timed)})()
        else:
            engine._decode_body = self._timed(engine._decode_body)
        return self

    def __exit__(self, *exc):
        if self.engine.graphs:
            self.step.graph = self.graph
        else:
            del self.engine._decode_body  # back to the class's method
        return False

    def seconds(self) -> float:
        import torch

        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.marks) / 1e3


def steady_stretch(engine, prompts, overlap: bool, steps: int, device_of=None) -> dict:
    """Four slots decoding ``steps`` steps with nothing non-steady in
    between (admitted before, finishing after): host-clock ms per step,
    the engine's dispatch / execute / readback split of it
    (``phase_time_s["decode"]``), the stream's time per step (CUDA events around
    each launch, :class:`LaunchTimer`: from the stream reaching the step
    to its end, which is the step's device time when the step was queued
    behind its predecessor, and adds the launch's latency when the stream
    was idle), the card's SM clock and power just after the window, and
    the device's busy share: a decode step's device time (``device_of``
    (engine), or the engine's own graph replayed back to back right after
    the window, on the last step's inputs) over the ms per step."""
    import torch

    from flexflow_tpu_torch.generation.engine import SamplingParams
    from flexflow_tpu_torch.generation.scheduler import ContinuousBatchingScheduler

    sched = ContinuousBatchingScheduler(engine, overlap=overlap)
    handles = [sched.submit(p, SamplingParams(max_new_tokens=steps + 8)) for p in prompts]
    sched.step()  # the admissions and one sequential decode step
    sched.step()  # with overlap: the pipeline's first dispatch
    torch.cuda.synchronize()
    decode0, drains0 = engine.step_counts["decode"], dict(sched.pipe_drains)
    phases0 = dict(engine.phase_time_s["decode"])
    with LaunchTimer(engine) as timer:
        t0 = time.perf_counter()
        for _ in range(steps):
            sched.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device = timer.seconds()
    n = engine.step_counts["decode"] - decode0
    if n != steps or sched.pipe_drains != drains0 or len(sched._running) != len(prompts):
        raise AssertionError(f"steady stretch not steady: {n} steps, drains {sched.pipe_drains}")
    if len(timer.marks) != n:
        raise AssertionError(f"steady stretch: {len(timer.marks)} timed launches, {n} steps")
    # the window's steps were dispatched and consumed inside it, but for
    # the pipeline's in-flight step at each end: n steps' worth either way
    phases = {f"{k}_ms_per_step": 1e3 * (engine.phase_time_s["decode"][k] - phases0[k]) / n
              for k in phases0}
    clocks = card_clocks()
    # a replay on the last step's inputs recomputes its outputs bit for
    # bit, so the in-flight step's readback and token carry are unchanged
    device_ms = (device_of or decode_graph_device_ms)(engine)
    while not all(h.done() for h in handles):
        sched.step()
    ms = 1e3 * wall / n
    return {"steps": n, "ms_per_step": ms, **phases,
            "stream_ms_per_step": 1e3 * device / n,
            "device_ms_per_step": device_ms, "device_busy_share": device_ms / ms,
            "clocks_sm_power": clocks}


def decode_graph_device_ms(engine, reps: int = 20) -> float:
    """The device time of one 4-slot decode step: its captured graph
    replayed ``reps`` times back to back between CUDA events, on the last
    step's inputs (each replay rewrites the same K/V, in blocks no live
    request holds; the launch counters are not touched)."""
    import torch

    step = engine._steps._steps[("decode", (engine.max_batch_slots, engine.max_blocks_per_seq))]
    torch.cuda.synchronize()
    step.graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        step.graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def overlap_recovery(engine, prompts, samplings, streams) -> dict:
    """The overlap pipeline's failures on the card, each through a fresh
    scheduler over the cell's requests: a decode-step crash and an
    async-readback error (``donate`` is set on the card, so each resets
    the engine and replays the journal) and a NaN on one slot
    (quarantine). Surviving streams must equal the fault-free ones, the
    cache tensors must stay where the graphs hold them, and nothing may
    be captured again."""
    import numpy as np

    from flexflow_tpu_torch.generation.recovery import PoisonedRequestError
    from flexflow_tpu_torch.generation.scheduler import ContinuousBatchingScheduler
    from flexflow_tpu_torch.runtime import faults

    if not engine.donate:
        raise AssertionError("a CUDA engine must default to donate=True")
    cases = {
        "decode_step crash": (faults.FaultPlan(seed=0).on(
            faults.GENERATION_DECODE_STEP, mode="error",
            error=RuntimeError("injected device crash"), nth=(12,)), 1, 0),
        "async_readback error": (faults.FaultPlan(seed=0).on(
            faults.GENERATION_ASYNC_READBACK, mode="error",
            error=faults.FaultInjected("injected readback loss"), nth=(6,)), 1, 0),
        "NaN on slot 1": (faults.FaultPlan(seed=0).on(
            faults.GENERATION_DECODE_STEP, mode="nan", nth=(10,),
            select=lambda v: np.asarray([False, True, False, False])), 0, 1),
    }
    out = {}
    for name, (plan, want_resets, want_failed) in cases.items():
        ptrs = (engine.cache.k.data_ptr(), engine.cache.v.data_ptr())
        captures, resets0 = dict(engine.trace_counts), engine.resets
        sched = ContinuousBatchingScheduler(engine)
        with plan.active():
            handles = [sched.submit(p, s) for p, s in zip(prompts, samplings)]
            while not all(h.done() for h in handles):
                sched.step()
        failed, survivors = 0, []
        for h, ref in zip(handles, streams):
            try:
                got = h.result(0)
            except PoisonedRequestError:
                failed += 1
                continue
            survivors.append(got == ref)
        resets = engine.resets - resets0
        rec = {"fired": len(plan.events), "resets": resets,
               "failed": failed, "recovery": sched.recovery_stats.snapshot(),
               "pipe_discards": sched.pipe_discards, "pipe_drains": dict(sched.pipe_drains)}
        print(f"overlap recovery, {name}: " + json.dumps(rec))
        if rec["fired"] != 1 or resets != want_resets or failed != want_failed:
            raise AssertionError(f"{name}: {rec}, expected {want_resets} resets and "
                                 f"{want_failed} quarantined")
        if not all(survivors):
            raise AssertionError(f"{name}: a surviving stream differs from the fault-free run")
        if (engine.cache.k.data_ptr(), engine.cache.v.data_ptr()) != ptrs:
            raise AssertionError(f"{name}: the KV cache moved")
        if engine.trace_counts != captures:
            raise AssertionError(f"{name}: captured again: {engine.trace_counts} vs {captures}")
        out[name] = rec
    return out


def overlap_phase(seed: int, params) -> dict:
    """The overlap pipeline on the 4-slot serving cell (the serving
    phase's 8 request lengths and samplings), graph steps with the
    pipeline on and off in the order on, off, off, on after a warm-up:
    streams identical across all four runs and to the eager engine's
    sequential run, the pipeline engaged, one capture per signature, 12
    paged launches per decode step; a carried step's logits against the
    plain attention path; the steady stretch (4 slots x 128 steps, and
    32 on eager steps) on and off; then the recovery cases."""
    import numpy as np

    from flexflow_tpu_torch.generation.engine import SamplingParams
    from flexflow_tpu_torch.ops.kernels import decode_attention as da

    cfg = gpt2_small()
    engines = engine_pair(params, max_batch_slots=4, block_size=16)
    graph, eager = engines["graph"], engines["eager"]
    rs = np.random.RandomState(seed + 5)
    for engine in engines.values():
        warm(engine, rs)
    lens = [16, 700, 64, 300, 128, 512, 40, 220]
    prompts = [rs.randint(0, cfg.vocab_size, n).tolist() for n in lens]
    samplings = [SamplingParams(max_new_tokens=32)] * 6 + [
        SamplingParams(max_new_tokens=32, temperature=0.8, top_k=50, seed=1234),
        SamplingParams(max_new_tokens=32, temperature=0.8, top_k=50, seed=5678),
    ]
    handles, _, _, _ = serve(eager, prompts, samplings, overlap=False)
    streams = [h.result(0) for h in handles]
    runs = {"on": [], "off": []}
    launches = 0
    for mode in ("on", "off", "off", "on"):
        decode0, dsec0 = graph.step_counts["decode"], graph.step_seconds["decode"]
        da.reset_launch_counts()
        handles, wall, ttft, sched = serve(graph, prompts, samplings, overlap=mode == "on")
        stats = run_stats(graph, handles, wall, ttft, decode0, dsec0, dict(da.LAUNCHES))
        stats.update(pipe_dispatches=sched.pipe_dispatches, pipe_drains=dict(sched.pipe_drains),
                     pipe_discards=sched.pipe_discards)
        if [h.result(0) for h in handles] != streams:
            raise AssertionError(f"overlap {mode}: streams differ from the eager sequential run")
        steps = stats["decode_steps"]
        if stats["launches"]["paged_append"] != cfg.num_layers * steps:
            raise AssertionError(f"overlap {mode}: launches {stats['launches']} != "
                                 f"{cfg.num_layers} x {steps} decode steps")
        if mode == "on" and (sched.pipe_dispatches == 0 or sched.pipe_discards):
            raise AssertionError(f"overlap on: {stats}")
        launches += stats["launches"]["paged_append"]
        runs[mode].append(stats)
        print(f"overlap {mode} (4 slots, graph steps): " + json.dumps(stats))
    if graph.trace_counts.get("decode") != 1 or graph.recompiles():
        raise AssertionError(f"overlap: graph engine signatures {graph.trace_counts}")
    stats = {"runs": runs, "launches": {"paged_append": launches},
             "captures": dict(graph.trace_counts)}
    stats["logits_max_abs_err"] = check_pipelined_logits(graph, seed)
    four = [rs.randint(0, cfg.vocab_size, n).tolist() for n in (300, 64, 700, 128)]
    # an eager step runs the graph's kernels: its device time is the graph
    # engine's, replayed back to back just after the eager window
    for name, engine, steps, device_of in (
            ("graph", graph, 128, None),
            ("eager", eager, 32, lambda _engine: decode_graph_device_ms(graph))):
        for mode in ("on", "off", "off", "on"):
            r = steady_stretch(engine, four, mode == "on", steps, device_of)
            stats.setdefault(f"steady_{name}", {}).setdefault(mode, []).append(r)
            print(f"overlap steady stretch ({name} steps, overlap {mode}): " + json.dumps(r))
    stats["recovery"] = overlap_recovery(graph, prompts, samplings, streams)
    return stats


# a grammar per constrained request of the constrained phase: a JSON
# object and a regex (the first two formats), and one that never ends,
# for the timed stretch with a constrained slot
CONSTRAINED_SCHEMA = {"type": "object",
                      "properties": {"ok": {"type": "boolean"}, "n": {"type": "integer"}}}
CONSTRAINED_FORMATS = (
    {"type": "json_schema", "json_schema": CONSTRAINED_SCHEMA},
    {"type": "regex", "pattern": "[a-z]{1,8}-[0-9]{2,4}"},
    {"type": "regex", "pattern": "[a-z ]+"},
)


def serving_vocabulary(size: int) -> tuple:
    """A deterministic token table of exactly ``size`` entries: the port's
    default table (which stops at 1422 entries), then three-character
    fillers over its filler alphabet."""
    from flexflow_tpu_torch.generation.constrained import default_vocabulary

    toks = list(default_vocabulary(size))
    fill = ("".join(p) for p in itertools.product("0123456789abcdefghijklmnopqrstuvwxyz_",
                                                   repeat=3))
    toks.extend(itertools.islice(fill, size - len(toks)))
    if len(toks) != size:
        raise AssertionError(f"vocabulary of {len(toks)} entries, wanted {size}")
    return tuple(toks)


def check_grammar_text(vocab, tokens, spec) -> str:
    """The stream's text, which must be what its grammar allows."""
    from flexflow_tpu_torch.generation.constrained import (
        compile_regex,
        decode_text,
        grammar_alphabet,
        validate_json,
    )

    text = decode_text(vocab, tokens, None)
    if spec["type"] == "json_schema":
        errs = validate_json(text, spec["json_schema"])
        if errs:
            raise AssertionError(f"constrained: {text!r} fails its schema: {errs}")
    elif not compile_regex(spec["pattern"], grammar_alphabet(vocab)).matches(text):
        raise AssertionError(f"constrained: {text!r} does not match {spec['pattern']!r}")
    return text


def serve_grammars(engine, prompts, samplings, grammars, overlap=None, speculation=None):
    """Every request at once through a fresh scheduler (a grammar per
    request, None for an unconstrained one; ``speculation`` for the greedy
    requests), stepped to the end. Returns (handles, scheduler, wall s)."""
    import torch

    from flexflow_tpu_torch.generation.scheduler import ContinuousBatchingScheduler

    torch.cuda.synchronize()
    sched = ContinuousBatchingScheduler(engine, overlap=overlap)
    t0 = time.perf_counter()
    handles = [sched.submit(p, s, grammar=g,
                            speculation=speculation if s.temperature <= 0 else None)
               for p, s, g in zip(prompts, samplings, grammars)]
    for _ in range(10_000):
        if all(h.done() for h in handles):
            break
        sched.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not all(h.done() for h in handles):
        raise AssertionError("constrained: requests did not finish")
    return handles, sched, wall


def check_masked_logits(engine, grammars, rs) -> dict:
    """A live constrained batch (two constrained greedy slots with the
    n-gram drafter, two unconstrained): one masked decode step and one
    masked verify step (legal drafts walked along each grammar) run
    through the engine's graphs, whose logits must agree with the plain
    attention path's plus the same grammar rows within LOGITS_ATOL."""
    import numpy as np
    import torch

    from flexflow_tpu_torch.generation.decoder import decode_step, verify_step
    from flexflow_tpu_torch.generation.engine import SamplingParams
    from flexflow_tpu_torch.generation.scheduler import ContinuousBatchingScheduler
    from flexflow_tpu_torch.generation.speculative import SpeculationConfig

    cfg, dev = engine.cfg, engine.device
    b, w, v = engine.max_batch_slots, engine.spec_window, cfg.vocab_size
    sched = ContinuousBatchingScheduler(engine, overlap=False)
    spec = SpeculationConfig(k=w - 1)
    live = [sched.submit(rs.randint(0, v, n).tolist(), SamplingParams(max_new_tokens=24),
                         grammar=g, speculation=spec if g is not None else None)
            for n, g in zip((100, 37, 250, 16), (grammars[0], grammars[1], None, None))]
    sched.step()  # admissions + one masked verify (zero or more drafts)
    order = sorted(sched._running.values(), key=lambda s: s.slot)
    slots = sched._collect_slots(order)
    tokens, positions, tables, active = slots[:4]
    mask = sched._decode_mask(order)
    dense = np.zeros((b, v), np.float32)
    for i, row in mask.items():
        dense[i] = row
    engine.decode(*slots, mask=mask)
    got = engine.last_logits.clone()
    x = engine.decode_arrays(tokens, positions, tables, active)
    ck, cv = engine.cache.k.clone(), engine.cache.v.clone()
    want, _, _ = decode_step(engine.params, *(torch.from_numpy(x[k]).to(dev) for k in (
        "tokens", "positions")), ck, cv, torch.from_numpy(x["tables"]).to(dev),
        torch.from_numpy(x["context_lens"]).to(dev), backend="plain")
    del ck, cv
    act = torch.from_numpy(active).to(dev)
    want = want + torch.from_numpy(dense).to(dev)
    errs = {"decode": float((got[act] - want[act]).abs().max())}
    if not torch.isfinite(got[act]).all():
        raise AssertionError("constrained: masked decode logits not finite")
    # a masked verify step: each constrained slot drafts a legal walk
    sched._plan_speculation()
    sched._grow()
    order = sorted(sched._running.values(), key=lambda s: s.slot)
    last, start, tables, _, temps, top_ks, seeds, counts = sched._collect_slots(order)
    window = np.zeros((b, w), np.int32)
    window[:, 0] = last
    n_draft = np.full((b,), -1, np.int32)
    bs = engine.cache_config.block_size
    for state in order:
        room = min(w - 1, len(state.blocks) * bs - state.cached_len - 1)
        ms, draft = state.req.mask_state, []
        if ms is not None:
            st = ms.state
            while len(draft) < room and ms.dfa.allowed(st):
                tok = int(ms.dfa.allowed(st)[rs.randint(len(ms.dfa.allowed(st)))])
                draft.append(tok)
                st = ms.dfa.step(st, tok)
        window[state.slot, 1: 1 + len(draft)] = draft
        n_draft[state.slot] = len(draft)
    wmask = sched._verify_mask(order, window, n_draft)
    dense = np.zeros((b, w, v), np.float32)
    for (i, j), row in wmask.items():
        dense[i, j] = row
    engine.verify(window, start, n_draft, tables, temps, top_ks, seeds, counts, wmask)
    got = engine.last_logits.clone()
    offs = np.arange(w)[None, :]
    pos = np.where(offs <= n_draft[:, None], start[:, None] + offs, -1).astype(np.int32)
    ck, cv = engine.cache.k.clone(), engine.cache.v.clone()
    want, _, _ = verify_step(engine.params, torch.from_numpy(window).to(dev),
                             torch.from_numpy(pos).to(dev), ck, cv,
                             torch.from_numpy(tables).to(dev), backend="plain")
    del ck, cv
    valid = torch.from_numpy(pos >= 0).to(dev)
    want = want + torch.from_numpy(dense).to(dev)
    if not torch.isfinite(got[valid]).all():
        raise AssertionError("constrained: masked verify logits not finite")
    errs["verify"] = float((got[valid] - want[valid]).abs().max())
    errs["verify_drafts"] = n_draft.tolist()
    print("constrained: masked logits kernel vs plain attention: max abs err "
          + json.dumps(errs))
    if max(errs["decode"], errs["verify"]) > LOGITS_ATOL:
        raise AssertionError(f"constrained: masked logits differ: {errs}")
    for h in live:
        h.cancel()
    sched.step()
    torch.cuda.empty_cache()
    return errs


def constrained_stretch(engine, prompts, grammars, overlap: bool, steps: int) -> dict:
    """Four slots decoding ``steps`` greedy steps with nothing non-steady
    but the grammar (admitted before, finishing after): host-clock ms per
    step, the engine's dispatch / execute / readback split of it (the
    mask rows are written inside the dispatch), the grammar-mask bytes
    written per step and the steps that wrote any."""
    import torch

    from flexflow_tpu_torch.generation.engine import SamplingParams
    from flexflow_tpu_torch.generation.scheduler import ContinuousBatchingScheduler

    sched = ContinuousBatchingScheduler(engine, overlap=overlap)
    handles = [sched.submit(p, SamplingParams(max_new_tokens=steps + 8), grammar=g)
               for p, g in zip(prompts, grammars)]
    sched.step()
    sched.step()
    torch.cuda.synchronize()
    decode0, bytes0, masked0 = (engine.step_counts["decode"], engine.mask_bytes_staged,
                                engine.masked_step_count)
    phases0 = dict(engine.phase_time_s["decode"])
    t0 = time.perf_counter()
    for _ in range(steps):
        sched.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = engine.step_counts["decode"] - decode0
    if n != steps or len(sched._running) != len(prompts):
        raise AssertionError(f"constrained stretch not steady: {n} steps")
    out = {"steps": n, "ms_per_step": 1e3 * wall / n,
           **{f"{k}_ms_per_step": 1e3 * (engine.phase_time_s["decode"][k] - phases0[k]) / n
              for k in phases0},
           "mask_bytes_per_step": (engine.mask_bytes_staged - bytes0) / n,
           "masked_steps": engine.masked_step_count - masked0}
    while not all(h.done() for h in handles):
        sched.step()
    return out


def constrained_phase(seed: int, params) -> dict:
    """Constrained decoding at GPT-2-small width behind the 4-slot engine:
    a 50257-entry vocabulary, a JSON-schema and a regex grammar, and the
    serving cell's 8 request lengths (prompts that are prefixes of one
    another, so with the prefix cache on the constrained admissions are
    masked suffix prefills): 4 constrained (2 greedy, 2 at temperature
    0.8 / top-k 50) and 4 unconstrained greedy, 32 new tokens each.
    Every engine first serves the same requests unconstrained, which
    captures every signature the constrained runs use."""
    import numpy as np
    import torch

    from flexflow_tpu_torch.generation.constrained import GrammarCache
    from flexflow_tpu_torch.generation.engine import GenerationEngine, SamplingParams
    from flexflow_tpu_torch.generation.recovery import PoisonedRequestError
    from flexflow_tpu_torch.generation.speculative import SpeculationConfig
    from flexflow_tpu_torch.ops.kernels import decode_attention as da
    from flexflow_tpu_torch.runtime import faults
    from flexflow_tpu_torch.serving.stats import ConstrainedStats

    cfg = gpt2_small()
    vocab = serving_vocabulary(cfg.vocab_size)
    cstats = ConstrainedStats()
    cache = GrammarCache(vocab, stats=cstats)
    compile_s, grammars = [], []
    for spec in CONSTRAINED_FORMATS:
        t0 = time.perf_counter()
        grammars.append(cache.get(spec))
        compile_s.append(time.perf_counter() - t0)
    states = [g.char_dfa.n_states for g in grammars]
    print(f"constrained: grammars of {states} character states compiled in "
          + ", ".join(f"{s:.3f}" for s in compile_s) + " s; the start states allow "
          + ", ".join(str(len(g.allowed(g.start))) for g in grammars) + " tokens")
    engines = engine_pair(params, max_batch_slots=4, block_size=16, max_spec_tokens=4)
    engines["prefix"] = GenerationEngine(params, cfg, max_batch_slots=4, block_size=16,
                                         max_spec_tokens=4, prefix_cache=True)
    spec = SpeculationConfig(k=4)
    rs = np.random.RandomState(seed + 9)
    lens = [16, 700, 64, 300, 128, 512, 40, 220]
    base = rs.randint(0, cfg.vocab_size, max(lens)).tolist()
    prompts = [base[:n] for n in lens]
    samplings = [SamplingParams(max_new_tokens=32)] * 2 + [
        SamplingParams(max_new_tokens=32, temperature=0.8, top_k=50, seed=1234),
        SamplingParams(max_new_tokens=32, temperature=0.8, top_k=50, seed=5678),
    ] + [SamplingParams(max_new_tokens=32)] * 4
    formats = list(CONSTRAINED_FORMATS[:2]) * 2 + [None] * 4
    request_grammars = [None if f is None else grammars[CONSTRAINED_FORMATS.index(f)]
                        for f in formats]
    captures = {}
    for name, engine in engines.items():
        warm(engine, rs)
        warm(engine, rs, speculation=spec)
        if name == "prefix":
            clear_prefix_cache(engine)
        serve_grammars(engine, prompts, samplings, [None] * 8)
        serve_grammars(engine, prompts, samplings, [None] * 8, speculation=spec)
        captures[name] = dict(engine.trace_counts)
    runs, streams = {}, None
    for label, name, overlap, speculation in (
            ("graph, overlap on", "graph", True, None),
            ("eager, overlap off", "eager", False, None),
            ("graph, overlap off", "graph", False, None),
            ("graph, speculation k=4", "graph", True, spec),
            ("prefix on, graph", "prefix", True, None),
            ("graph, overlap on (again)", "graph", True, None)):
        engine = engines[name]
        if name == "prefix":
            clear_prefix_cache(engine)
        steps0 = dict(engine.step_counts)
        hits0 = engine.prefix_cache.hits
        vsec0 = engine.step_seconds["verify"]
        da.reset_launch_counts()
        handles, sched, wall = serve_grammars(engine, prompts, samplings, request_grammars,
                                              overlap=overlap, speculation=speculation)
        launches = dict(da.LAUNCHES)
        outs = [h.result(0) for h in handles]
        texts = [check_grammar_text(vocab, out, f) for out, f in zip(outs, formats)
                 if f is not None]
        decode = engine.step_counts["decode"] - steps0["decode"]
        verify = engine.step_counts["verify"] - steps0["verify"]
        suffix = engine.prefix_cache.hits - hits0
        want = cfg.num_layers * (decode + verify + suffix)
        if launches["paged_append"] != want or launches["paged_append_split"]:
            raise AssertionError(f"constrained {label}: launches {launches} != "
                                 f"{cfg.num_layers} x ({decode} decode + {verify} verify + "
                                 f"{suffix} suffix prefill steps)")
        greedy = [o for o, s in zip(outs, samplings) if s.temperature <= 0]
        if streams is None:
            streams = outs
        elif (greedy if speculation else outs) != (
                [o for o, s in zip(streams, samplings) if s.temperature <= 0]
                if speculation else streams):
            raise AssertionError(f"constrained {label}: streams differ from the first run's")
        if name == "prefix" and suffix == 0:
            raise AssertionError("constrained: the prefix cache served no suffix prefill")
        runs[label] = {"decode_steps": decode, "verify_steps": verify,
                       "suffix_prefills": suffix, "wall_s": wall, "launches": launches,
                       "verify_step_ms": 1e3 * (engine.step_seconds["verify"] - vsec0)
                       / max(verify, 1),
                       "masked_steps": sched.constrained_stats.masked_steps,
                       "pipe_dispatches": sched.pipe_dispatches}
        print(f"constrained ({label}): " + json.dumps(runs[label]) + " texts "
              + json.dumps(texts))
    for name, engine in engines.items():
        if engine.trace_counts != captures[name]:
            raise AssertionError(f"constrained traffic captured on {name}: "
                                 f"{engine.trace_counts} vs {captures[name]}")
    graph = engines["graph"]
    stats = {"compile_s": compile_s, "char_states": states, "runs": runs,
             "launches": {"paged_append": sum(r["launches"]["paged_append"]
                                              for r in runs.values())}}
    stats["logits_max_abs_err"] = check_masked_logits(graph, grammars, rs)
    # the timed stretch: 4 live slots, none / one constrained, sequential
    # and pipelined (a constrained slot always steps sequentially)
    four = [rs.randint(0, cfg.vocab_size, n).tolist() for n in (300, 64, 700, 128)]
    open_g = grammars[2]
    cases = {"unconstrained, overlap off": ([None] * 4, False),
             "one constrained slot": ([open_g, None, None, None], True),
             "unconstrained, overlap on": ([None] * 4, True)}
    stretch = {}
    for label in list(cases) + list(reversed(cases)):
        gs, overlap = cases[label]
        r = constrained_stretch(graph, four, gs, overlap, 64)
        stretch.setdefault(label, []).append(r)
        print(f"constrained stretch ({label}, graph steps): " + json.dumps(r))
    stats["stretch"] = stretch
    # a mask_advance error quarantines one constrained request
    plan = faults.FaultPlan(seed=0).on(faults.GENERATION_MASK_ADVANCE, mode="error",
                                       error=RuntimeError("injected advance fault"), nth=(5,))
    with plan.active():
        handles, sched, _ = serve_grammars(graph, prompts, samplings, request_grammars)
    failed, same = [], []
    for i, (h, ref) in enumerate(zip(handles, streams)):
        try:
            same.append(h.result(0) == ref)
        except PoisonedRequestError as e:
            failed.append((i, e.step, e.reason))
    if len(failed) != 1 or failed[0][1:] != ("mask", "mask_advance") or \
            formats[failed[0][0]] is None or not all(same) or len(plan.events) != 1:
        raise AssertionError(f"constrained: mask_advance fault gave {failed}, survivors {same}")
    stats["quarantine"] = {"failed": failed, "dead_end_failures":
                           sched.constrained_stats.dead_end_failures}
    print("constrained: a mask_advance error quarantined " + json.dumps(stats["quarantine"]))
    if graph.trace_counts != captures["graph"]:
        raise AssertionError(f"constrained: captured again: {graph.trace_counts}")
    for name, engine in engines.items():
        torch.cuda.synchronize()
        if any(m is not None and bool(m.any()) for m in (
                engine._mask1, engine._mask_dec, engine._mask_ver)):
            raise AssertionError(f"constrained: {name}'s grammar masks are not zero")
    stats["masked_steps"] = sum(r["masked_steps"] for r in runs.values())
    stats["mask_bytes_staged"] = {n: e.mask_bytes_staged for n, e in engines.items()}
    stats["engine_masked_steps"] = {n: e.masked_step_count for n, e in engines.items()}
    return stats


def http_generate(base: str, body: dict) -> dict:
    """One POST /v2/models/lm/generate on loopback: the tokens, and the
    client's time.monotonic() stamps (the scheduler's clock) of the
    request's start, its first SSE token event (None for JSON) and its
    end."""
    import urllib.request

    req = urllib.request.Request(base + "/v2/models/lm/generate",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.monotonic()
    first = None
    with urllib.request.urlopen(req, timeout=600) as r:
        if not body.get("stream"):
            tokens = json.loads(r.read())["tokens"]
        else:
            events = []
            for line in r:
                if line.startswith(b"data: "):
                    events.append(json.loads(line[len(b"data: "):]))
                    if first is None:
                        first = time.monotonic()
            if not events or not events[-1].get("done") or "tokens" not in events[-1]:
                raise AssertionError(f"server: SSE stream ended without its done event: "
                                     f"{events[-1:]}")
            tokens = events[-1]["tokens"]
            if [e["token"] for e in events[:-1]] != tokens:
                raise AssertionError("server: SSE token events differ from the done event")
    return {"tokens": tokens, "t0": t0, "first": first, "t1": time.monotonic(),
            "prompt_len": len(body["prompt"])}


def http_burst(base: str, bodies) -> dict:
    """Every request at once, one client thread each, then each request's
    time split against the scheduler's own trace of it (found by prompt
    length): before submit (the client's start to the scheduler's
    accept: connection and parse), the scheduler's TTFT, the first SSE
    event's delivery after the scheduler's first token, and the client's
    latency past the scheduler's accept-to-finish span."""
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    t0 = time.monotonic()
    with ThreadPoolExecutor(len(bodies)) as pool:
        results = list(pool.map(lambda b: http_generate(base, b), bodies))
    wall = time.monotonic() - t0
    with urllib.request.urlopen(base + f"/v2/debug/traces?n={len(bodies)}", timeout=60) as r:
        traces = {t["prompt_len"]: t for t in json.loads(r.read())["traces"]}
    sse = [g for g in results if g["first"] is not None]
    tokens = sum(len(g["tokens"]) for g in results)
    tr = [traces[g["prompt_len"]] for g in results]
    pre = [1e3 * (t["t_accept"] - g["t0"]) for g, t in zip(results, tr)]
    delivery = [1e3 * (g["first"] - traces[g["prompt_len"]]["t_accept"]
                       - traces[g["prompt_len"]]["ttft_s"]) for g in sse]
    outside = [(g["t1"] - g["t0"]) - t["total_s"] for g, t in zip(results, tr)]
    return {
        "results": results, "wall_s": wall, "tokens": tokens, "tokens_per_s": tokens / wall,
        "http_ttft_p50_s": float(np.median([g["first"] - g["t0"] for g in sse])),
        "trace_ttft_p50_s": float(np.median([traces[g["prompt_len"]]["ttft_s"] for g in sse])),
        "pre_submit_ms_p50": float(np.median(pre)), "pre_submit_ms_max": max(pre),
        "sse_delivery_ms_p50": float(np.median(delivery)), "sse_delivery_ms_max": max(delivery),
        # the client's latency past the scheduler's own span, per token:
        # the front end's host time (connection, parse, writes, reads)
        "front_end_ms_per_token": 1e3 * sum(outside) / tokens,
    }


def server_phase(seed: int, params) -> dict:
    """The serving front end at GPT-2-small width: the port's
    InferenceServer on 127.0.0.1 (port 0) with one GenerationModel over a
    4-slot graph engine (prefix cache on, the overlap pipeline on,
    ``vocabulary=`` the constrained phase's 50257-entry table). Client
    threads post, all at once, the serving cell's 8 requests (half SSE,
    half JSON) twice: cold (the process's first HTTP traffic) and warm;
    then a JSON-schema ``response_format`` request, a ``"speculation":
    {"k": 4}`` request and a best-effort one. Each HTTP stream must equal
    the same request submitted straight to a ContinuousBatchingScheduler
    over the same engine (run first, which also captures every signature
    the traffic needs); the HTTP traffic must capture nothing new and
    launch num_layers paged kernels per decode and verify step; /metrics
    must be a valid exposition whose token total is what the clients
    received."""
    import numpy as np
    import torch
    import urllib.request

    from flexflow_tpu_torch.generation.engine import GenerationEngine, SamplingParams
    from flexflow_tpu_torch.generation.scheduler import ContinuousBatchingScheduler
    from flexflow_tpu_torch.generation.speculative import SpeculationConfig
    from flexflow_tpu_torch.obs import validate_exposition
    from flexflow_tpu_torch.ops.kernels import decode_attention as da
    from flexflow_tpu_torch.serving import GenerationModel, InferenceServer

    cfg = gpt2_small()
    vocab = serving_vocabulary(cfg.vocab_size)
    engine = GenerationEngine(params, cfg, max_batch_slots=4, block_size=16, max_spec_tokens=4,
                              prefix_cache=True)
    model = GenerationModel(engine, name="lm", vocabulary=vocab)
    rs = np.random.RandomState(seed + 10)
    warm(engine, rs)
    lens = [16, 700, 64, 300, 128, 512, 40, 220]
    sampling = [dict(max_new_tokens=32)] * 6 + [
        dict(max_new_tokens=32, temperature=0.8, top_k=50, seed=1234),
        dict(max_new_tokens=32, temperature=0.8, top_k=50, seed=5678),
    ]
    cell = [dict(s, prompt=rs.randint(0, cfg.vocab_size, n).tolist(), stream=bool(i % 2))
            for i, (n, s) in enumerate(zip(lens, sampling))]
    schema = CONSTRAINED_FORMATS[0]
    extras = [
        dict(prompt=rs.randint(0, cfg.vocab_size, 48).tolist(), max_new_tokens=32,
             response_format=schema),
        dict(prompt=rs.randint(0, cfg.vocab_size, 96).tolist(), max_new_tokens=32,
             speculation={"k": 4}, stream=True),
        dict(prompt=rs.randint(0, cfg.vocab_size, 24).tolist(), max_new_tokens=32,
             priority="best_effort"),
    ]
    keys = ("max_new_tokens", "temperature", "top_k", "seed")

    def direct(bodies):
        """The requests straight to a scheduler over the same engine."""
        torch.cuda.synchronize()
        sched = ContinuousBatchingScheduler(engine)
        t0 = time.perf_counter()
        hs = [sched.submit(b["prompt"], SamplingParams(**{k: b[k] for k in keys if k in b}),
                           speculation=(SpeculationConfig(k=b["speculation"]["k"])
                                        if "speculation" in b else None),
                           priority=b.get("priority"),
                           grammar=(model.grammar_cache.get(b["response_format"])
                                    if "response_format" in b else None))
              for b in bodies]
        while not all(h.done() for h in hs):
            sched.step()
        return [h.result(0) for h in hs], time.perf_counter() - t0

    # the reference streams; this also captures the verify signature
    # and compiles the grammar before the HTTP traffic. Each run starts
    # from an empty prefix cache (the bursts repeat the cell's prompts)
    want_extras, _ = direct(extras)
    clear_prefix_cache(engine)
    want_cell, direct_wall = direct(cell)
    clear_prefix_cache(engine)
    captures = dict(engine.trace_counts)
    srv = InferenceServer(port=0)
    srv.register_generation(model)
    srv.start()
    try:
        base = f"http://127.0.0.1:{srv.port}"
        counts0 = dict(engine.step_counts)
        hits0 = engine.prefix_cache.hits
        da.reset_launch_counts()
        bursts = {"cold": http_burst(base, cell)}
        clear_prefix_cache(engine)  # the scheduler is idle: nothing runs
        cpu0 = time.process_time()
        bursts["warm"] = http_burst(base, cell)
        cpu_warm = time.process_time() - cpu0
        bursts["extras"] = http_burst(base, extras)
        launches = dict(da.LAUNCHES)
        steps = {k: engine.step_counts[k] - counts0[k] for k in counts0}
        suffix_prefills = engine.prefix_cache.hits - hits0
        with urllib.request.urlopen(base + "/metrics", timeout=60) as r:
            exposition = r.read().decode()
        with urllib.request.urlopen(base + "/v2/stats", timeout=60) as r:
            served = json.loads(r.read())["generation"]["lm"]
    finally:
        srv.stop()
    cell_streams = [[g["tokens"] for g in bursts[n]["results"]] for n in ("cold", "warm")]
    if any(got != want_cell for got in cell_streams):
        raise AssertionError("server: serving cell: HTTP streams differ from the scheduler's")
    if [g["tokens"] for g in bursts["extras"]["results"]] != want_extras:
        raise AssertionError("server: extras: HTTP streams differ from the scheduler's")
    text = check_grammar_text(vocab, bursts["extras"]["results"][0]["tokens"], schema)
    errors = validate_exposition(exposition)
    if errors:
        raise AssertionError(f"server: /metrics is not a valid exposition: {errors[:5]}")
    total = [ln for ln in exposition.splitlines()
             if ln.startswith('flexflow_serving_tokens_generated{model="lm"}')]
    received = sum(b["tokens"] for b in bursts.values())
    if len(total) != 1 or float(total[0].split()[-1]) != received:
        raise AssertionError(f"server: /metrics token total {total} != {received} received")
    if engine.trace_counts != captures or engine.recompiles():
        raise AssertionError(f"server: the HTTP traffic captured {engine.trace_counts} "
                             f"after {captures}")
    expect = cfg.num_layers * (steps["decode"] + steps["verify"] + suffix_prefills)
    if launches["paged_append"] != expect or launches["paged_append_split"]:
        raise AssertionError(f"server: launches {launches} != {cfg.num_layers} layers x "
                             f"({steps} steps, {suffix_prefills} suffix prefills)")
    stats = {
        "requests": 2 * len(cell) + len(extras), "launches": launches, "steps": steps,
        "suffix_prefills": suffix_prefills, "captures": captures,
        "direct_tokens_per_s": sum(len(t) for t in want_cell) / direct_wall,
        "warm_process_cpu_ms_per_token": 1e3 * cpu_warm / bursts["warm"]["tokens"],
        "constrained_text": text, "received_tokens": received,
        "spec_acceptance_rate": served["spec_acceptance_rate"], "rejected": served["rejected"],
        **{name: {k: v for k, v in b.items() if k != "results"} for name, b in bursts.items()},
    }
    print("server (HTTP, 4 slots, graph steps): " + json.dumps(stats))
    return stats


def flash_bound(kind: str, b: int, sq: int, sk: int, h: int, d: int, causal: bool,
                two_byte: bool = False):
    """(bound_ms, bound_by, fp32_cuda_core_ms) of one flash kernel call:
    each input read once and each output written once over the card's
    memory rate, against the multiply-adds the kernel does on the
    unmasked (query, key) pairs (2 flops each: QK and PV forward; QK,
    dO.V and dS.K for dQ; QK, dO.V, P^T dO and dS^T Q for dK/dV) taken
    to fp32 accuracy on the tensor cores, three TF32 products each at
    the dense TF32 rate (datasheet figures); for the bf16 and fp16 forms,
    2-byte q, k, v, o, dO and gradients (lse and delta stay 4) and the
    same operations at the dense bf16 / fp16 rate (the same 989 TFLOP/s).
    fp32_cuda_core_ms is the larger
    of the byte time and those operations at the fp32 CUDA-core rate."""
    pairs = b * h * (sq * (sq + 1) // 2 if causal else sq * sk)
    e = 2 if two_byte else 4  # bytes an element of q, k, v, o, dO, dq, dk, dv
    q_elems, kv_elems, rows = b * sq * h * d, b * sk * h * d, b * sq * h
    if kind == "fwd":
        flops = 2 * 2 * d * pairs
        nbytes = e * (2 * q_elems + 2 * kv_elems) + 4 * rows  # q, o; k, v; lse
    elif kind == "dq":
        flops = 3 * 2 * d * pairs
        nbytes = e * (3 * q_elems + 2 * kv_elems) + 8 * rows  # q, dO, dq; k, v; lse, delta
    else:
        flops = 4 * 2 * d * pairs
        nbytes = e * (2 * q_elems + 4 * kv_elems) + 8 * rows  # q, dO; k, v, dk, dv; lse, delta
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = (flops / H100_BF16_FLOPS if two_byte else TF32_PRODUCTS * flops / H100_TF32_FLOPS) * 1e3
    fp32_ms = max(t_bytes, flops / H100_FP32_FLOPS * 1e3)
    return (t_bytes, "bytes", fp32_ms) if t_bytes >= t_ops else (t_ops, "operations", fp32_ms)


def ptxas_report(log: str) -> list:
    """[(kernel instance, "N registers, spills")] from nvcc's ptxas -v log:
    each entry function by its mangled name past the source's namespace."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '_ZN\w*?_cu_[0-9a-f]+\d+(\w+)'", line)
        if m:
            name, spill = m.group(1).split("EEv")[0], ""  # up to the template arguments
        elif name and "spill stores" in line:
            spill = line.strip().split(",")[1].strip()
        elif name and "Used" in line and "registers" in line:
            out.append((name, line.split("Used", 1)[1].split(",")[0].strip() + ", " + spill))
            name = None
    return out


def library_sass(source: str) -> str:
    """cuobjdump -sass of the built library of ``csrc/<source>``."""
    from flexflow_tpu_torch.ops.kernels import _build

    src = next(p for p in _build.kernel_sources() if p.name == source)
    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    return subprocess.run([cuobjdump, "-sass", str(_build.library_path(src))],
                          capture_output=True, text=True, check=True, timeout=300).stdout


def tensor_core_check() -> dict:
    """The built flash library's SASS (cuobjdump -sass) must hold
    tensor-core HMMA instructions (mma.sync) in every instance of the
    forward, dQ and dK/dV mma.sync kernels, float32, bf16 and fp16 forms
    (the 2-byte forms are the body the wgmma bodies leave calls to), and
    warpgroup GMMA instructions (HGMMA, wgmma) in every instance of the
    bf16 and fp16 wgmma forward, dQ and dK/dV (head dims padded to 64 and
    128); the CUDA-core dQ must exist only for head dims above 128 (5..8,
    12 and 16 columns of 32) in all three forms; the paged library's, in every instance
    of the tensor-core body (fp32, bf16 and fp16 caches, single-pass and
    split, head dims padded to 32, 64 and 128). Raises otherwise. Returns
    ({kernel<head-dim pad,form>: HMMA count}, {wgmma kernel<pad,form>:
    HGMMA count})."""
    paged_tensor_core_check()
    sass = library_sass("flash_attention.cu")
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : .*?(flash_[a-z_]+_kernel)ILi(\d+)E(f|13__nv_bfloat16|6__half)E",
                      line)
        if m:
            form = {"f": ",f32", "13__nv_bfloat16": ",bf16", "6__half": ",f16"}[m.group(3)]
            name = f"{m.group(1)}<{m.group(2)}{form}>"
            counts[name] = {"HMMA": 0, "HGMMA": 0}
        elif "Function : " in line:
            name = None
        elif name is not None:
            for op in ("HMMA", "HGMMA"):
                if re.search(rf"\b{op}\b", line):
                    counts[name][op] += 1
    found = {}
    for kernel in ("flash_fwd_tc_kernel", "flash_bwd_dq_tc_kernel", "flash_bwd_dkv_tc_kernel"):
        inst = {n: c["HMMA"] for n, c in counts.items() if n.startswith(kernel + "<")}
        if len(inst) != 12 or not all(inst.values()):
            raise AssertionError(f"{kernel}: expected HMMA in 4 head dims x 3 forms, got "
                                 f"{inst or 'none in the built library'}")
        found.update(inst)
    wgmma = {}
    for kernel in ("flash_fwd_wg_kernel", "flash_bwd_dq_wg_kernel", "flash_bwd_dkv_wg_kernel"):
        inst = {n: c["HGMMA"] for n, c in counts.items() if n.startswith(kernel + "<")}
        want = sorted(f"{kernel}<{d},{f}>" for d in (64, 128) for f in ("bf16", "f16"))
        if sorted(inst) != want or not all(inst.values()):
            raise AssertionError(f"{kernel}: expected HGMMA in head dims 64 and 128, bf16 "
                                 f"and fp16, got "
                                 f"{inst or 'none in the built library'}")
        wgmma.update(inst)
    simt_dq = sorted(n[n.index("<") + 1:-1] for n in counts if n.startswith("flash_bwd_dq_kernel<"))
    want = sorted(f"{c},{f}" for c in (5, 6, 7, 8, 12, 16) for f in ("f32", "bf16", "f16"))
    if simt_dq != want:
        raise AssertionError(f"CUDA-core dQ instances {simt_dq}: expected only D > 128 ({want})")
    return found, wgmma


def paged_tensor_core_check() -> dict:
    """HMMA counts of the paged library's tensor-core body, by instance
    (cache form, single-pass or split, head-dim pad); raises unless all 18
    instances hold HMMA and the CUDA-core body holds none."""
    forms = {"f": "f32", "13__nv_bfloat16": "bf16", "6__half": "f16"}
    counts, name, simt_hmma = {}, None, 0
    for line in library_sass("paged_attention.cu").splitlines():
        m = re.search(r"Function : .*?paged_append_tc_kernelI(f|13__nv_bfloat16|6__half)Lb([01])"
                      r"ELi(\d+)E", line)
        if m:
            name = (f"paged_append_tc_kernel<{forms[m.group(1)]},"
                    f"{'split' if m.group(2) == '1' else 'single'},{m.group(3)}>")
            counts[name] = 0
        elif "Function : " in line:
            name = "simt" if "paged_append_kernel" in line else None
        elif name == "simt" and "HMMA" in line:
            simt_hmma += 1
        elif name is not None and "HMMA" in line:
            counts[name] += 1
    if len(counts) != 18 or not all(counts.values()) or simt_hmma:
        raise AssertionError("paged tensor-core body: expected HMMA in 3 forms x 2 kernels x 3 "
                             f"head dims and none in the CUDA-core body, got {counts or 'none'}, "
                             f"{simt_hmma} in the CUDA-core body")
    return counts


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


def flash_inputs(gen, b, sq, sk, h, d, causal, scale, copies=1, dtype=None):
    """``copies`` sets of (q, k, v, dO, lse, delta) on the card, q, k, v
    and dO in ``dtype`` (float32 by default); lse and delta come from the
    plain forward."""
    import torch

    from flexflow_tpu_torch.ops.kernels import flash_attention as fa

    dtype = dtype or torch.float32
    sets = []
    for _ in range(copies):
        q = torch.randn((b, sq, h, d), generator=gen).to("cuda", dtype)
        k = torch.randn((b, sk, h, d), generator=gen).to("cuda", dtype)
        v = torch.randn((b, sk, h, d), generator=gen).to("cuda", dtype)
        do = torch.randn((b, sq, h, d), generator=gen).to("cuda", dtype)
        o, lse = fa.reference_flash_forward(q, k, v, causal, scale)
        sets.append((q, k, v, do, lse, fa.flash_delta(do, o)))
    return sets


def check_flash(name, sets, causal, scale, body=None, range_case=False):
    """The three kernels against their plain versions on the first set,
    at the fp32 gate or, for bf16 and fp16 inputs, check_half's gate (the
    logsumexp, fp32 in every form, at the fp32 gate). ``body``: the body
    (``fa.BODIES``) the forward, dQ and dK/dV launches must have taken.
    ``range_case``: check_half's ``atol`` is range_atol of each output.
    Returns ({kernel: max abs err}, {kernel: body taken}), keyed as the
    launch counts are."""
    import torch

    from flexflow_tpu_torch.ops.kernels import flash_attention as fa

    q, k, v, do, lse, delta = sets[0]
    form = FLASH_FORMS[str(q.dtype)[6:]]
    if range_case:
        def close(what, got, want):
            return check_half(what, got, want, range_atol(want))
    else:
        close = check_half if form else check_close
    before = dict(fa.LAUNCHES_BY_BODY)
    o, klse = fa.flash_forward_kernel(q, k, v, causal, scale)
    po, plse = fa.reference_flash_forward(q, k, v, causal, scale)
    dq = fa.flash_backward_dq_kernel(q, k, v, do, lse, delta, causal, scale)
    dk, dv = fa.flash_backward_dkv_kernel(q, k, v, do, lse, delta, causal, scale)
    pdq, pdk, pdv = fa.reference_flash_backward(q, k, v, do, lse, delta, causal, scale)
    took = dict(key.split() for key, n in fa.LAUNCHES_BY_BODY.items() if n > before[key])
    for kernel in ("flash_fwd" + form, "flash_bwd_dq" + form, "flash_bwd_dkv" + form):
        if body is not None and took.get(kernel) != body:
            raise AssertionError(f"{name}: {kernel} took the {took.get(kernel)} body, not {body}")
    return {
        "flash_fwd" + form: max(close(f"{name} forward o", o, po),
                                check_close(f"{name} forward lse", klse, plse)),
        "flash_bwd_dq" + form: close(f"{name} dq", dq, pdq),
        "flash_bwd_dkv" + form: max(close(f"{name} dk", dk, pdk), close(f"{name} dv", dv, pdv)),
    }, took


def misaligned(t):
    """A contiguous copy of ``t`` whose data starts 2 bytes past a 16-byte
    boundary (a view into a larger buffer): no TMA copy takes it."""
    import torch

    buf = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
    return buf[1:1 + t.numel()].view(t.shape).copy_(t)


def check_value_head_dim(seed: int) -> None:
    """multihead attention's core with v's head dim other than q's and
    k's (kdim 8 / vdim 16, and 64 / 24), fp32, bf16 and fp16: the kernels
    run on zero-padded head dims (3 launches a forward and backward) and
    match the plain versions, output and gradients. In bf16 and fp16 the
    padded D = 16 keeps the mma.sync bodies and D = 64 takes the wgmma
    forward, dQ and dK/dV."""
    import torch

    from flexflow_tpu_torch.ops.kernels import flash_attention as fa

    gen = torch.Generator().manual_seed(seed + 23)
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        form = FLASH_FORMS[str(dtype)[6:]]
        for dk, dv in ((8, 16), (64, 24)):
            base = [torch.randn(2, 8, 2, d, generator=gen).to("cuda", dtype) for d in (dk, dk, dv)]
            dout = torch.randn(2, 8, 2, dv, generator=gen).to("cuda", dtype)
            outs = {}
            for backend in ("auto", "plain"):
                q, k, v = (t.clone().requires_grad_(True) for t in base)
                fa.reset_launch_counts()
                o = fa.flash_attention(q, k, v, backend=backend)
                o.backward(dout)
                torch.cuda.synchronize()
                if sum(fa.LAUNCHES.values()) != (3 if backend == "auto" else 0):
                    raise AssertionError(f"Dv != Dk, {backend}: launches {fa.LAUNCHES}")
                if backend == "auto" and form:
                    body = "wgmma" if max(dk, dv) > 32 else "mma_sync"
                    for kernel in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
                        if fa.LAUNCHES_BY_BODY[f"{kernel}{form} {body}"] != 1:
                            raise AssertionError(f"Dk={dk} Dv={dv} {form}: {kernel}{form} not on "
                                                 f"the {body} body ({fa.LAUNCHES_BY_BODY})")
                outs[backend] = (o.detach(), q.grad, k.grad, v.grad)
            close = check_half if form else check_close
            tag = f"flash Dk={dk} Dv={dv} {str(dtype)[6:]}"
            errs = [close(f"{tag} {n}", g, w)
                    for n, g, w in zip(("o", "dq", "dk", "dv"), outs["auto"], outs["plain"])]
            print(f"{tag}: output {tuple(outs['auto'][0].shape)}, max abs err "
                  f"{max(errs):.3e} (o, dq, dk, dv against the plain versions)")


def flash_phase(seed: int):
    """The flash kernels, float32, bf16 and fp16 forms, against their
    plain versions at the training shape and edge shapes (fp16 also where
    its range matters: most of P below 2^-14, dS past 65504, gradients of
    order 1e-6); device times at the training shape and the causal S=512
    shape. Returns per-kernel records (launches filled in by the training
    phase)."""
    import torch
    import torch.nn.functional as F

    from flexflow_tpu_torch.ops.kernels import flash_attention as fa

    gen = torch.Generator().manual_seed(seed + 11)
    rows = {}
    for (label, (b, s, h, d, causal, copies)), dtype in itertools.product({
        "train": (32, 128, 12, 64, False, 3),  # 3 x 50 MB of q/k/v/dO: past the L2
        "causal512": (4, 512, 12, 64, True, 3),
    }.items(), (torch.float32, torch.bfloat16, torch.float16)):
        scale = d ** -0.5
        form = FLASH_FORMS[str(dtype)[6:]]
        sets = flash_inputs(gen, b, s, s, h, d, causal, scale, copies, dtype)
        errs, bodies = check_flash(f"flash {label}{form}", sets, causal, scale,
                                   body="wgmma" if form else "mma_sync")
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
            "flash_fwd" + form: (
                lambda q, k, v, do, lse, de: fa.flash_forward_kernel(q, k, v, causal, scale),
                lambda q, k, v, do, lse, de: fa.reference_flash_forward(q, k, v, causal, scale),
                sdpa_fwd, "fwd"),
            "flash_bwd_dq" + form: (
                lambda *a: fa.flash_backward_dq_kernel(*a, causal, scale),
                lambda *a: fa.reference_flash_backward_dq(*a, causal, scale),
                sdpa_bwd_ms, "dq"),
            "flash_bwd_dkv" + form: (
                lambda *a: fa.flash_backward_dkv_kernel(*a, causal, scale),
                lambda *a: fa.reference_flash_backward_dkv(*a, causal, scale),
                sdpa_bwd_ms, "dkv"),
        }
        shape = {"B": b, "S": s, "H": h, "D": d, "causal": causal, "dtype": str(dtype)[6:]}
        for name, (kern, plain, lib_ms, kind) in timed.items():
            ms, eager_ms = time_ms(kern, sets)
            plain_ms, _ = time_ms(plain, sets)
            bound_ms, bound_by, fp32_bound_ms = flash_bound(kind, b, s, s, h, d, causal,
                                                            bool(form))
            row = {"max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
                   "fp32_cuda_core_bound_ms": fp32_bound_ms,
                   "eager_ms": eager_ms, "body": bodies[name], "shape": shape}
            print(f"flash {label} {name}: " + json.dumps(row))
            rows.setdefault(label, {})[name] = row
        print(f"flash {label}{form}: SDPA forward {sdpa_fwd:.4f} ms, backward (dq, dk, dv "
              f"together) {sdpa_bwd_ms:.4f} ms on the device ({sdpa_bwd_eager_ms:.4f} ms eager)")
        del sets, lib_sets, outs
    # edge shapes, correctness only: ragged S with D = 128, Sq != Sk, D = 256
    # (the CUDA-core forward and dK/dV), one query row, a ragged tile past
    # 64 rows, D = 8, head dims past 256 (the 16-row CUDA-core kernels);
    # then the bf16 forms: the kept mma.sync bodies at D % 8 != 0 (element
    # copies), D <= 32 and a misaligned view; the wgmma bodies at Sq != Sk,
    # a ragged S, D = 40 and 96 (padded to 64 and 128), D = 128 and one
    # query row; the CUDA cores at D = 256 and 512; the fp16 forms at a
    # sample of the same
    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
    mma, wg, simt = "mma_sync", "wgmma", "cuda_cores"
    for b, sq, sk, h, d, causal, dtype, body, offset in [
            (2, 100, 100, 3, 128, False, f32, mma, False),
            (2, 64, 200, 4, 64, False, f32, mma, False),
            (2, 128, 128, 2, 256, False, f32, simt, False), (2, 1, 1, 3, 64, False, f32, mma, False),
            (2, 65, 65, 3, 64, False, f32, mma, False), (2, 65, 65, 3, 64, True, f32, mma, False),
            (2, 128, 128, 2, 8, False, f32, mma, False),
            (2, 96, 96, 2, 512, False, f32, simt, False),
            (2, 65, 65, 2, 512, True, f32, simt, False),
            (2, 40, 40, 2, 300, False, f32, simt, False),
            (2, 70, 70, 3, 33, False, bf16, mma, False), (2, 40, 40, 2, 32, True, bf16, mma, False),
            (2, 96, 96, 2, 64, True, bf16, mma, True),
            (2, 64, 200, 4, 64, False, bf16, wg, False),
            (2, 100, 100, 3, 64, False, bf16, wg, False), (2, 65, 65, 2, 40, True, bf16, wg, False),
            (2, 129, 129, 2, 96, True, bf16, wg, False),
            (2, 200, 200, 2, 128, False, bf16, wg, False), (2, 1, 1, 3, 64, False, bf16, wg, False),
            (2, 65, 65, 3, 256, True, bf16, simt, False),
            (2, 64, 64, 2, 512, False, bf16, simt, False),
            (2, 70, 70, 3, 33, False, f16, mma, False), (2, 96, 96, 2, 64, True, f16, mma, True),
            (2, 64, 200, 4, 64, False, f16, wg, False), (2, 129, 129, 2, 96, True, f16, wg, False),
            (2, 1, 1, 3, 64, False, f16, wg, False), (2, 65, 65, 3, 256, True, f16, simt, False)]:
        sets = flash_inputs(gen, b, sq, sk, h, d, causal, d ** -0.5, dtype=dtype)
        if offset:
            sets = [tuple(misaligned(t) for t in st[:4]) + st[4:] for st in sets]
        tag = (f"Sq={sq} Sk={sk} D={d}" + (" causal" if causal else "") + f" {str(dtype)[6:]}"
               + (" misaligned" if offset else ""))
        errs, bodies = check_flash(f"flash edge {tag}", sets, causal, d ** -0.5, body=body)
        print(f"flash edge B={b} H={h} {tag}: max abs err "
              + json.dumps({k: f"{e:.3e}" for k, e in errs.items()}) + " bodies "
              + json.dumps(bodies))
    check_fp16_range(seed)
    check_value_head_dim(seed)
    torch.cuda.empty_cache()
    return rows


# the fp16 range cases: (name, q, k, v and dO multipliers of randn inputs)
FP16_RANGE_CASES = (("P below 2^-14", (6, 1, 1, 1)),
                    ("dS past 65504", (0.01, 0.01, 1000, 1000)),
                    ("gradients 1e-6", (1, 1, 1, 1e-6)))


def fp16_range_sets(seed: int):
    """Yields (case, (q, k, v, dO, lse, delta), P's share below 2^-14,
    largest |dS|) for each of FP16_RANGE_CASES at B=2 S=128 H=4 D=64 on
    the card, after checking that each case is the range end it names."""
    import torch

    from flexflow_tpu_torch.ops.kernels import flash_attention as fa

    gen = torch.Generator().manual_seed(seed + 29)
    b, s, h, d = 2, 128, 4, 64
    scale = d ** -0.5
    for case, mul in FP16_RANGE_CASES:
        q, k, v, do = (torch.randn((b, s, h, d), generator=gen).mul(m).to("cuda", torch.float16)
                       for m in mul)
        o, lse = fa.reference_flash_forward(q, k, v, False, scale)
        delta = fa.flash_delta(do, o)
        _, _, _, p, ds = fa._plain_probs(q, k, v, do, lse, delta, False, scale)
        low, ds_max = float((p < 2.0 ** -14).float().mean()), float(ds.abs().max())
        if ((case == "P below 2^-14" and low <= 0.5)
                or (case == "dS past 65504" and ds_max <= 65504)
                or (case == "gradients 1e-6" and ds_max >= 2.0 ** -14)):
            raise AssertionError(f"fp16 {case}: P below 2^-14 {low:.3f}, max |dS| {ds_max}")
        yield case, (q, k, v, do, lse, delta), low, ds_max


def check_fp16_range(seed: int) -> None:
    """The fp16 forms where fp16's range matters (the cases
    tests/test_torch_port_flash_split_numerics.py emulates): q times 6
    (most of P below 2^-14, so P's halves are subnormal), q and k times
    0.01 with v and dO times 1000 (|dS| past 65504: the wgmma bodies scale
    each row of dS by a power of two before its split), dO times 1e-6 (dS
    and the gradients subnormal in fp16, as training's are: each row of dS
    scaled up). Each on the wgmma bodies, within one fp16 ulp of the plain
    value (no finer than the subnormal spacing) + HALF_RANGE_SHARE of the
    output's largest |value|: a body without the scaling errs by 2
    subnormal ulps in dQ and dK at 1e-6 and is refused
    (``python3 -m flexflow_tpu_torch.tools.flash_probe range``)."""
    scale = 64 ** -0.5
    for case, st, low, ds_max in fp16_range_sets(seed):
        errs, _ = check_flash(f"flash fp16 {case}", [st], False, scale, body="wgmma",
                              range_case=True)
        print(f"flash fp16 {case} (B=2 S=128 H=4 D=64; P below 2^-14 {low:.3f}, max |dS| "
              f"{ds_max:.4g}): max abs err "
              + json.dumps({k_: f"{e:.3e}" for k_, e in errs.items()}))


def bert_base(dtype=None):
    from flexflow_tpu_torch.core.types import DataType
    from flexflow_tpu_torch.models import TransformerConfig

    return TransformerConfig(num_layers=12, hidden_size=768, num_heads=12, ff_size=3072,
                             seq_length=128, dtype=dtype or DataType.FLOAT)


def kernel_group(name: str) -> str:
    """A device kernel's group in a train step's time: the flash kernels,
    cuBLAS's GEMMs, or elementwise and everything else."""
    if "flash_" in name:
        return "flash kernels"
    if any(k in name for k in ("gemm", "cutlass", "nvjet", "xmma")):
        return "GEMMs (cuBLAS)"
    return "elementwise and other"


def training_phase(seed: int, dtype=None):
    """BERT-Base width through FFModel -> compile -> fit on the card, in
    ``dtype``: DataType.FLOAT (the default), BFLOAT16 (``bench.py``'s
    cell) or HALF."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from flexflow_tpu_torch.config import FFConfig
    from flexflow_tpu_torch.core.types import DataType, LossType, MetricsType
    from flexflow_tpu_torch.models import build_transformer
    from flexflow_tpu_torch.ops.kernels import flash_attention as fa
    from flexflow_tpu_torch.runtime import SGDOptimizer

    cfg = bert_base(dtype or DataType.FLOAT)
    batch, warm, steps = 32, 2, 10
    type_name = str(cfg.dtype.torch)[6:]
    form = FLASH_FORMS[type_name]
    tag = {"": "fp32", "_bf16": "bf16", "_f16": "fp16"}[form]
    # the step's flash launches: num_layers of each kernel of its form, none of the others
    per_step = {f"{kernel}{f}": (cfg.num_layers if f == form else 0)
                for kernel in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
                for f in FLASH_FORMS.values()}
    if set(per_step) != set(fa.LAUNCHES):
        raise AssertionError(f"flash launch counts {sorted(fa.LAUNCHES)}, expected "
                             f"{sorted(per_step)}")
    t0 = time.perf_counter()
    model = build_transformer(FFConfig(batch_size=batch, seed=seed, printing_interval=5), cfg)
    model.compile(optimizer=SGDOptimizer(lr=0.01), loss_type=LossType.MEAN_SQUARED_ERROR,
                  metrics=[MetricsType.MEAN_SQUARED_ERROR])
    ex = model.executor
    n_params = sum(p.numel() for g in ex.params.values() for p in g.values())
    gen = torch.Generator(device="cuda").manual_seed(seed)
    shape = (batch, cfg.seq_length, cfg.hidden_size)
    x = torch.randn(shape, generator=gen, device="cuda").to(cfg.dtype.torch)
    y = torch.randn(shape, generator=gen, device="cuda").to(cfg.dtype.torch)
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
        want = per_step if backend == "auto" else {name: 0 for name in per_step}
        if launches != want:
            raise AssertionError(f"{tag} {backend} step launched {launches}, expected {want}")
    ex.backend = "auto"
    restore()
    (lk, pk), (lp, pp) = after["auto"], after["plain"]
    leaves = [(k, n) for k in pk for n in pk[k]]
    if any(pk[k][n].dtype != cfg.dtype.torch for k, n in leaves):
        raise AssertionError(f"{tag}: a parameter left {cfg.dtype.torch} in the step")
    param_err = max(float((pk[k][n].float() - pp[k][n].float()).abs().max()) for k, n in leaves)
    moved = max(float((pk[k][n].float() - snap[k][n].float()).abs().max()) for k, n in leaves)
    print(f"training {tag}: one step, kernel vs plain attention: loss {lk:.7f} vs {lp:.7f}, "
          f"params max abs diff {param_err:.3e} (the step moved them by up to {moved:.3e})")
    loss_rtol = HALF_LOSS_RTOL[type_name] if form else LOSS_RTOL
    if not (np.isfinite(lk) and abs(lk - lp) <= loss_rtol * abs(lp)):
        raise AssertionError(f"{tag} train-step loss kernel {lk} vs plain {lp} beyond rtol "
                             f"{loss_rtol}")
    if not 0 < moved:
        raise AssertionError(f"{tag}: the step moved no parameter")
    if form:
        for k, n in leaves:
            a, b_ = pk[k][n].float(), pp[k][n].float()
            lim = 2 * half_ulp(torch.maximum(a.abs(), b_.abs()), cfg.dtype.torch) + (
                HALF_PARAM_SHARE * float((pp[k][n].float() - snap[k][n].float()).abs().max()))
            if ((a - b_).abs() > lim).any():
                raise AssertionError(f"{tag} params {k}.{n} after one step: kernel vs plain "
                                     f"beyond 2 ulps + {HALF_PARAM_SHARE} of the update")
    elif param_err > PARAM_STEP_RTOL * moved:
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
    by_body = {key: n for key, n in fa.LAUNCHES_BY_BODY.items() if n}
    losses = model.step_losses
    for name, n in launches.items():
        if n != per_step[name] * steps:
            raise AssertionError(f"{tag} {name}: {n} launches in {steps} steps, expected "
                                 f"{per_step[name]} per step ({launches})")
    # every 2-byte forward, dQ and dK/dV launch of the cell on the wgmma bodies
    for name in (f"{k}{form}" for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv") if form):
        if by_body.get(f"{name} wgmma", 0) != launches[name]:
            raise AssertionError(f"{tag}: {name} launches by body {by_body}, expected all "
                                 f"{launches[name]} on the wgmma body")
    if any(p.dtype != cfg.dtype.torch for g in ex.params.values() for p in g.values()):
        raise AssertionError(f"{tag}: a parameter left {cfg.dtype.torch} in training")
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
    # the elementwise group's largest kernels, device us a step, by name
    # (long enough to tell the dtype and the functor apart)
    elementwise = sorted(((name, us / 2) for name, us in by_name.items()
                          if kernel_group(name) == "elementwise and other"),
                         key=lambda kv: -kv[1])[:12]
    groups = {"flash kernels": 0.0, "GEMMs (cuBLAS)": 0.0, "elementwise and other": 0.0}
    for name, us in by_name.items():
        groups[kernel_group(name)] += us / 1e3 / 2
    step_device_ms = busy_us / 1e3 / 2
    stats = {
        "dtype": tag, "layers": cfg.num_layers, "hidden": cfg.hidden_size, "heads": cfg.num_heads,
        "ff": cfg.ff_size, "seq": cfg.seq_length, "batch": batch, "params": n_params,
        "setup_s": setup_s, "warmup_steps": warm, "timed_steps": steps, "elapsed_s": elapsed,
        "step_ms": 1e3 * elapsed / steps, "samples_per_s": steps * batch / elapsed,
        "tokens_per_s": steps * batch * cfg.seq_length / elapsed,
        "loss_first": losses[0], "loss_last": losses[-1], "launches": launches,
        "launches_by_body": by_body,
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
        "elementwise_step_us_by_kernel": {name[:200]: us for name, us in elementwise},
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    print(f"training (BERT-Base width, {tag}): " + json.dumps(stats))
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
    from flexflow_tpu_torch.core.types import DataType
    from flexflow_tpu_torch.generation.decoder import init_decoder_params, params_to
    from flexflow_tpu_torch.ops.kernels import _build

    # full fp32 everywhere: TF32 would move the logits past the checks
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # cuBLAS's 2-byte split-K reductions stay at PyTorch's default, as the
    # port runs them: the BERT-Base steps take no split-K GEMM, and turning
    # them off changes no bit of a step (tools/reduction_probe.py)

    card = card_line()
    print(card)
    t0 = time.perf_counter()
    _build.load_library()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.last_build_seconds:.2f} s)")
    for kernel, info in ptxas_report(_build.last_build_log):
        print(f"  ptxas: {kernel}: {info}")
    hmma, hgmma = tensor_core_check()
    print("tensor cores: HMMA instructions in the SASS of " + json.dumps(hmma))
    print("tensor cores: HGMMA (wgmma) instructions in the SASS of " + json.dumps(hgmma))
    lib = _build.load_library()
    print("bf16 wgmma bodies (the fp16 ones hold the same registers and shared memory), "
          "blocks an SM (occupancy calculator): " + json.dumps({
        f"{kernel}<{d}>": lib.ff_flash_wg_blocks_per_sm(kind, d)
        for kernel, kind in (("flash_fwd_wg_kernel", 0), ("flash_bwd_dq_wg_kernel", 1),
                             ("flash_bwd_dkv_wg_kernel", 2))
        for d in (64, 128)}))

    rows = kernel_phase(args.seed)
    params = init_decoder_params(torch.Generator().manual_seed(args.seed), gpt2_small())
    params = params_to(params, "cuda")  # one copy on the card, shared by every engine
    engines, serving, cell = serving_phase(args.seed, params)
    kv_dtype = kv_dtype_phase(args.seed, params, cell, engines["graph"])
    long_ctx, long_engine = long_context_phase(args.seed, params)
    graphs = step_graph_phase(engines, args.seed)
    speculation = speculation_phase(args.seed, params)
    prefix = prefix_phase(args.seed, params)
    overlap = overlap_phase(args.seed, params)
    constrained = constrained_phase(args.seed, params)
    server = server_phase(args.seed, params)
    anatomy = anatomy_phase(engines, args.seed)
    long_ctx["profiled"] = long_context_profile(long_engine, args.seed)
    suffix_bodies = suffix_prefill_bodies(args.seed, params)
    del engines, long_engine, params
    torch.cuda.empty_cache()
    flash = flash_phase(args.seed)
    training = training_phase(args.seed)
    training_bf16 = training_phase(args.seed, DataType.BFLOAT16)
    training_f16 = training_phase(args.seed, DataType.HALF)

    def record(name, replaces, row, launches, source=SOURCE):
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        }

    def single(form):  # the single-pass rows of a cache form
        return [r for name, r in rows.items()
                if r["shape"]["splits"] == 1 and name.endswith(form)
                and r["shape"]["kv_dtype"] == {"": "float32", "_bf16": "bfloat16",
                                               "_f16": "float16"}[form]]

    kernels = [
        record("paged_append", "flexflow_tpu/ops/kernels/decode_attention.py:368",
               dict(rows["decode"], max_abs_err=max(r["max_abs_err"] for r in single(""))),
               serving["launches"]["paged_append"] + speculation["launches"]["paged_append"]
               + prefix["launches"]["paged_append"] + overlap["launches"]["paged_append"]
               + constrained["launches"]["paged_append"] + server["launches"]["paged_append"]
               + suffix_bodies["float"]["launches"]["paged_append"]),
        record("paged_append_split", "flexflow_tpu/ops/kernels/decode_attention.py:338",
               rows["split"], long_ctx["launches"]["paged_append_split"]),
    ] + [
        record(name, f"flexflow_tpu/ops/kernels/flash_attention.py:{line}",
               dict(flash["train"][name], max_abs_err=max(
                   flash["train"][name]["max_abs_err"], flash["causal512"][name]["max_abs_err"])),
               training["launches"][name], FLASH_SOURCE)
        for name, line in (("flash_fwd", 158), ("flash_bwd_dq", 262), ("flash_bwd_dkv", 278))
    ] + [
        record(f"{name}{form}", f"flexflow_tpu/ops/kernels/flash_attention.py:{line}",
               dict(flash["train"][f"{name}{form}"], max_abs_err=max(
                   flash["train"][f"{name}{form}"]["max_abs_err"],
                   flash["causal512"][f"{name}{form}"]["max_abs_err"])),
               run["launches"][f"{name}{form}"], FLASH_SOURCE)
        for form, run in (("_bf16", training_bf16), ("_f16", training_f16))
        for name, line in (("flash_fwd", 158), ("flash_bwd_dq", 262), ("flash_bwd_dkv", 278))
    ] + [
        record(f"{kernel}{form}", f"flexflow_tpu/ops/kernels/decode_attention.py:{line}",
               dict(rows[case + form], max_abs_err=max(r["max_abs_err"] for r in (
                   single(form) if kernel == "paged_append" else [rows[case + form]]))),
               kv_dtype["launches"][kernel + form]
               + suffix_bodies[ctype]["launches"][kernel + form])
        for form, ctype in (("_bf16", "__nv_bfloat16"), ("_f16", "__half"))
        for kernel, case, line in (("paged_append", "decode", 368),
                                   ("paged_append_split", "split", 338))
    ]
    for t in (training, training_bf16, training_f16):
        print(f"{card}: BERT-Base training (12 x 768, seq 128, batch 32), {t['dtype']}: "
              f"{t['samples_per_s']:.2f} samples/s, step {t['step_ms']:.3f} ms, device ms a step "
              f"{t['step_device_ms']:.3f} (" + ", ".join(
                  f"{g} {ms:.3f}" for g, ms in t["step_device_ms_by_group"].items())
              + f"), busy share {t['device_busy_share_of_timed_step']:.3f}, loss "
              f"{t['loss_first']:.5f} -> {t['loss_last']:.5f}; flash launches by body "
              + json.dumps(t["launches_by_body"]))
    for label in ("train", "causal512"):
        for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            for form in ("", "_bf16", "_f16"):
                r = flash[label][name + form]
                print(f"{card}: flash {label} {name + form} ({r['body']} body): {r['ms']:.4f} ms "
                      f"(bound {r['bound_ms']:.4f} by {r['bound_by']}, plain {r['plain_ms']:.4f}, "
                      f"SDPA {r['library_ms']:.4f})")
    for label, run in (("graph", "graph"), ("eager", "eager")):
        print(f"{card}: 4-slot serving, {label} steps, overlap on: decode call ms "
              "(dispatch + consume wait, not a step time) "
              + ", ".join(f"{r['decode_call_ms']:.3f}" for r in serving[run])
              + "; TTFT p50 s " + ", ".join(f"{r['ttft_p50_s']:.4f}" for r in serving[run])
              + "; tokens/s " + ", ".join(f"{r['tokens_per_s']:.1f}" for r in serving[run]))
        print(f"{card}: 1-slot long context, {label} steps: decode call ms "
              + ", ".join(f"{r['decode_call_ms']:.3f}" for r in long_ctx[run]))
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
                  + "; tokens/s " + ", ".join(f"{r['tokens_per_s']:.1f}" for r in rs_)
                  + ("; suffix prefill ms by bucket " + "; ".join(
                      ", ".join(f"W={w} {ms:.3f}" for w, ms in r["suffix_prefill_ms_by_bucket"]
                                .items()) for r in rs_) if on == "on" else ""))
    for mode in ("on", "off"):
        rs_ = overlap["runs"][mode]
        print(f"{card}: 4-slot serving, graph steps, overlap {mode}: "
              "tokens/s " + ", ".join(f"{r['tokens_per_s']:.1f}" for r in rs_)
              + "; TTFT p50 s " + ", ".join(f"{r['ttft_p50_s']:.4f}" for r in rs_))
        for name in ("graph", "eager"):
            st = overlap[f"steady_{name}"][mode]
            print(f"{card}: steady 4-slot decode, {name} steps, overlap {mode}: ms per step "
                  + ", ".join(f"{r['ms_per_step']:.3f}" for r in st)
                  + "; dispatch / execute / readback ms per step " + ", ".join(
                      f"{r['dispatch_ms_per_step']:.3f} / {r['execute_ms_per_step']:.3f} / "
                      f"{r['readback_ms_per_step']:.3f}" for r in st)
                  + "; stream ms per step " + ", ".join(f"{r['stream_ms_per_step']:.3f}" for r in st)
                  + "; device ms per step " + ", ".join(f"{r['device_ms_per_step']:.3f}" for r in st)
                  + "; device busy share " + ", ".join(f"{r['device_busy_share']:.3f}" for r in st)
                  + "; SM clock, power " + ", ".join(r["clocks_sm_power"] for r in st))
    cruns = constrained["runs"]
    print(f"{card}: constrained decoding: grammar compile s "
          + ", ".join(f"{t:.3f}" for t in constrained["compile_s"])
          + f"; masked slot-steps {constrained['masked_steps']}; verify step ms (k=4, "
          f"constrained slots) {cruns['graph, speculation k=4']['verify_step_ms']:.3f}")
    for label, rs_ in constrained["stretch"].items():
        print(f"{card}: 4-slot decode, graph steps, {label}: ms per step "
              + ", ".join(f"{r['ms_per_step']:.3f}" for r in rs_)
              + "; dispatch / execute / readback ms per step " + ", ".join(
                  f"{r['dispatch_ms_per_step']:.3f} / {r['execute_ms_per_step']:.3f} / "
                  f"{r['readback_ms_per_step']:.3f}" for r in rs_) + "; mask bytes per step "
              + ", ".join(f"{r['mask_bytes_per_step']:.0f}" for r in rs_))
    for name in ("cold", "warm"):
        b = server[name]
        print(f"{card}: HTTP front end, 4-slot serving cell (4 SSE + 4 JSON), {name}: TTFT p50 s "
              f"{b['http_ttft_p50_s']:.4f} (client clock, SSE) vs {b['trace_ttft_p50_s']:.4f} "
              f"(scheduler trace); tokens/s {b['tokens_per_s']:.1f} (HTTP) vs "
              f"{server['direct_tokens_per_s']:.1f} (scheduler direct); before submit ms p50 "
              f"{b['pre_submit_ms_p50']:.2f}, max {b['pre_submit_ms_max']:.2f}; SSE delivery ms "
              f"p50 {b['sse_delivery_ms_p50']:.3f}; front end ms per token "
              f"{b['front_end_ms_per_token']:.4f}")
    kv = kv_dtype
    print(f"{card}: kv cache bf16 ({kv['cache_bytes']} bytes against fp32's "
          f"{kv['fp32_cache_bytes']}), 4-slot serving cell: tokens/s "
          + ", ".join(f"{kv['runs'][m]['tokens_per_s']:.1f} ({m})" for m in ("graph", "eager"))
          + f"; decode step device ms fp32 {kv['decode_step_device_ms']['fp32']} bf16 "
          f"{kv['decode_step_device_ms']['bf16']}; tokens equal to the fp32 cache's "
          f"{kv['tokens_equal_to_fp32_cache']} of {kv['tokens']}; host tier {kv['host_tier']}")
    for name, r in rows.items():
        if name in {f"{case}{form}" for case in ("decode", "append_w5", "split")
                    for form in ("_bf16", "_f16")}:
            print(f"{card}: paged kernel {name} ms {r['ms']:.5f} (bound {r['bound_ms']:.5f} "
                  f"by {r['bound_by']}, plain {r['plain_ms']:.4f}, SDPA {r['library_ms']:.4f})")
    for name, r in rows.items():
        if name.startswith(("wide", "verify_w4", "split_w64")):
            print(f"{card}: paged kernel {name} ({r['body']}) ms {r['ms']:.4f} (bound "
                  f"{r['bound_ms']:.5f} by {r['bound_by']}; CUDA-core bound "
                  f"{r['cuda_core_bound_ms']:.5f}, tensor-core bound "
                  f"{r['tensor_core_bound_ms']:.5f}; plain {r['plain_ms']:.4f}, SDPA "
                  f"{r['library_ms']:.4f})")
    # the paged forms' launches by window in the runs that count them: the
    # prefix phase (fp32), the kv-dtype phase (2-byte forms) and the
    # profiled suffix prefills (every form)
    by_window = {}
    for counts in ([r["launches_by_window"] for rs_ in prefix["runs"].values() for r in rs_]
                   + [kv_dtype["launches_by_window"]]
                   + [s["launches_by_window"] for s in suffix_bodies.values()]):
        for k, n in counts.items():
            by_window[k] = by_window.get(k, 0) + n
    print(f"{card}: paged launches by window (prefix, kv-dtype and suffix-body runs): "
          + json.dumps({k: n for k, n in by_window.items() if n}))
    for ctype, s in suffix_bodies.items():
        print(f"{card}: W=1024 suffix prefill over a {ctype} cache: device ms "
              f"{s['suffix_prefill_device_ms']:.3f}, paged kernels {s['device_kernels']}")
    print(json.dumps({"card": card, "serving": serving, "kv_dtype": kv_dtype,
                      "long_context": long_ctx,
                      "step_graphs": graphs, "speculation": speculation, "prefix": prefix,
                      "overlap": overlap, "constrained": constrained, "server": server,
                      "anatomy": anatomy, "kernel_shapes": rows, "flash_shapes": flash,
                      "training": training, "training_bf16": training_bf16,
                      "training_f16": training_f16,
                      "suffix_prefill_bodies": suffix_bodies}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
