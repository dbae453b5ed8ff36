"""Paged decode/append attention: a window of query tokens per sequence
attending over a block-structured KV cache (port of
``flexflow_tpu/ops/kernels/decode_attention.py``).

The generation engine's decode step calls this once per layer with a
one-token window (``q`` [B, H, D]); the verification step calls the
chunked-append form with a W-token window (``q`` [B, W, H, D]). Each
window query has its own cache position; masking keeps only cache
positions ``<= q_position`` in its softmax (causal within the window,
full history before it). ``q_position < 0`` marks a padding query: it
attends to nothing and emits zeros.

Two lowerings, chosen by where the tensors lie:

* the plain PyTorch versions — :func:`reference_paged_append_attention`
  (gather the table'd blocks, masked softmax), its W = 1 form
  :func:`reference_paged_attention`, and the split-KV partials
  :func:`reference_paged_append_partials` that :func:`_combine_splits`
  finishes. They run for CPU tensors and are the parity oracle the CUDA
  kernels are held against on the card.
* the CUDA kernels of ``csrc/paged_attention.cu`` — thread blocks that
  each stage one range of a sequence's table columns through shared
  memory, one thread-block cluster per (head, sequence), whose blocks
  combine their softmax states through distributed shared memory in the
  same launch. The single-pass kernel shares the live positions among
  :func:`kernel_cluster_size` blocks; the split-KV kernel gives each
  block a run of whole splits (:func:`split_plan`) and writes the
  combined output, so ``kv_splits > 1`` is one launch too. For a CUDA
  tensor :func:`paged_append_attention` launches the kernel or raises; it
  never falls back to the plain version.

Each kernel launch adds one to its count in :data:`LAUNCHES`, so a run
can show that its main path went through the kernels. The count is kept
on the Python side, where the wrapper launches: a CUDA graph that
captured the launches replays them without the wrapper, so the graph's
owner counts them per replay (:func:`captured_launches`,
:func:`count_replay`).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

NEG_INF = -1e30
MAX_WINDOW = 32
MAX_HEAD_DIM = 256
MAX_CLUSTER = 8  # the portable thread-block cluster size the kernels launch

# launches of each CUDA kernel in this process (plain integers; a caller
# resets them with reset_launch_counts() before the run it measures)
LAUNCHES: Dict[str, int] = {"paged_append": 0, "paged_append_split": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def captured_launches(before: Dict[str, int]) -> Dict[str, int]:
    """The launches recorded since ``before`` (a copy of :data:`LAUNCHES`
    taken just before a CUDA graph capture), which are the capture's: a
    capture records its launches and runs none, so the counts go back to
    ``before`` and each replay adds these with :func:`count_replay`."""
    captured = {name: LAUNCHES[name] - before[name] for name in LAUNCHES}
    LAUNCHES.update(before)
    return captured


def count_replay(captured: Dict[str, int]) -> None:
    """Count one replay of a graph whose capture recorded ``captured``."""
    for name, n in captured.items():
        LAUNCHES[name] += n


def _gather(cache: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """[num_blocks, bs, H, D] indexed by [B, MB] -> [B, MB * bs, H, D]."""
    b, mb = block_tables.shape
    return cache[block_tables.long()].reshape(b, mb * cache.shape[1], *cache.shape[2:])


def reference_paged_append_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    block_tables: torch.Tensor,
    q_positions: torch.Tensor,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Masked window attention over gathered cache blocks, in plain
    PyTorch.

    q: [B, W, H, D] (K/V already written into the cache);
    k_cache/v_cache: [num_blocks, block_size, H, D]; block_tables:
    [B, max_blocks] int32; q_positions: [B, W] int32. Query (b, w)
    attends to cache positions ``<= q_positions[b, w]``; a negative
    position marks a padding query, which produces zeros, not NaN.
    Returns [B, W, H, D] in q's dtype.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    k = _gather(k_cache, block_tables).float()
    v = _gather(v_cache, block_tables).float()
    s = torch.einsum("bwhd,bkhd->bhwk", q.float(), k) * scale
    pos = torch.arange(k.shape[1], device=q.device)[None, None, None, :]
    valid = pos <= q_positions[:, None, :, None]  # [B, 1, W, S_max]
    s = torch.where(valid, s, NEG_INF)
    # max over an all-masked row is NEG_INF; subtracting keeps exp at 1
    # on masked lanes, so zero the probabilities explicitly
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhwk,bkhd->bwhd", p / l, v)
    return out.to(q.dtype)


def reference_paged_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    block_tables: torch.Tensor,
    context_lens: torch.Tensor,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """One-token (decode) form: q [B, H, D], context_lens [B] int32 (the
    number of valid cache positions INCLUDING the current token's
    already-written K/V; 0 marks an inactive slot)."""
    out = reference_paged_append_attention(
        q[:, None], k_cache, v_cache, block_tables, context_lens[:, None] - 1, scale
    )
    return out[:, 0]


def _clamp_splits(kv_splits: int, max_blocks: int) -> Tuple[int, int]:
    """(splits, table columns per split), clamped like the JAX wrapper."""
    splits = max(1, min(int(kv_splits), max_blocks))
    return splits, -(-max_blocks // splits)


def split_plan(kv_splits: int, max_blocks: int, max_ctas: int = MAX_CLUSTER) -> Tuple[int, int]:
    """(blocks, table columns per block) of the split-KV CUDA kernel's
    cluster for ``kv_splits`` over ``max_blocks`` columns. The JAX
    kernel's splits (:func:`_clamp_splits`) that hold a table column are
    grouped into at most ``max_ctas`` runs of consecutive whole splits,
    one block each, so every block has columns and the blocks' ranges
    are unions of the JAX splits: combining them is the same exact
    rescaled sum as :func:`_combine_splits`, for any split count."""
    _, bps = _clamp_splits(kv_splits, max_blocks)
    live = -(-max_blocks // bps)  # splits that hold a column
    per = -(-live // max_ctas)  # whole splits a block takes
    return -(-live // per), per * bps


def reference_paged_append_partials(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    block_tables: torch.Tensor,
    q_positions: torch.Tensor,
    kv_splits: int,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the split-KV kernel: each of S splits covers a
    contiguous range of ``ceil(max_blocks / S)`` table columns and yields
    its UNNORMALISED softmax partials — acc [B, S, W, H, D], m and l
    [B, S, H, W], all fp32. An empty split (or a query that sees none of
    its positions) carries (acc=0, m=NEG_INF, l=0)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    b, w, h, d = q.shape
    bs = k_cache.shape[1]
    splits, bps = _clamp_splits(kv_splits, block_tables.shape[1])
    pad = splits * bps - block_tables.shape[1]
    # padding columns point at scratch block 0 and are masked below
    tables = torch.nn.functional.pad(block_tables, (0, pad))
    k = _gather(k_cache, tables).float()
    v = _gather(v_cache, tables).float()
    chunk = bps * bs
    s = torch.einsum("bwhd,bkhd->bhwk", q.float(), k) * scale  # [B, H, W, S*chunk]
    pos = torch.arange(splits * chunk, device=q.device)
    valid = (pos[None, None, :] <= q_positions[:, :, None]) & (
        pos < block_tables.shape[1] * bs
    )[None, None, :]  # [B, W, S*chunk]
    valid = valid[:, None].expand_as(s)
    s = torch.where(valid, s, NEG_INF).reshape(b, h, w, splits, chunk)
    valid = valid.reshape(b, h, w, splits, chunk)
    m = s.amax(dim=-1)  # [B, H, W, S]
    p = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    acc = torch.einsum("bhwsc,bschd->bswhd", p, v.reshape(b, splits, chunk, h, d))
    return acc, m.permute(0, 3, 1, 2).contiguous(), l.permute(0, 3, 1, 2).contiguous()


def _combine_splits(acc, m, l, q_positions, out_dtype):
    """Exact partial-softmax recombination across the KV-split axis.

    acc: [B, S, W, H, D] unnormalised numerators; m/l: [B, S, H, W]
    per-split running max / denominator. An empty split carries
    (m=NEG_INF, l=0, acc=0) and contributes nothing; a padding query
    (q_position < 0) has EVERY split empty and emits zeros, matching the
    single-pass kernel."""
    m = m.transpose(2, 3)  # [B, S, W, H]
    l = l.transpose(2, 3)
    m_max = m.amax(dim=1, keepdim=True)  # [B, 1, W, H]
    # all-empty guard: exp(NEG_INF - NEG_INF) is 1, not 0; rescale
    # against 0 instead (every alpha then underflows to exp(NEG_INF) = 0)
    safe_max = torch.where(m_max > NEG_INF / 2, m_max, 0.0)
    alpha = torch.exp(m - safe_max)  # [B, S, W, H]
    denom = (l * alpha).sum(dim=1)  # [B, W, H]
    numer = (acc * alpha[..., None]).sum(dim=1)  # [B, W, H, D]
    out = numer / denom.clamp_min(1e-30)[..., None]
    out = torch.where(q_positions[:, :, None, None] >= 0, out, 0.0)
    return out.to(out_dtype)


def default_kv_splits(batch: int, max_blocks: int) -> int:
    """Flash-decoding split heuristic: split the KV axis only for a small
    batch over a long table, capped so each split still covers >= 4
    blocks. Reads the engine's STATIC slot count and table width, not
    live occupancy, exactly as the JAX heuristic does."""
    if batch > 2 or max_blocks < 16:
        return 1
    return max(1, min(8, max_blocks // 4))


def _check_kernel_inputs(q, k_cache, v_cache, block_tables, q_positions) -> None:
    """Everything the CUDA kernel assumes, checked before a pointer is
    passed: one device, fp32 data, int32 indices, the JAX layouts,
    contiguity, W <= 32 and head_dim <= 256."""
    dev = q.device
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache),
                    ("block_tables", block_tables), ("q_positions", q_positions)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.dtype != torch.float32:
            raise TypeError(f"paged attention kernel takes float32 {name}, got {t.dtype}")
    for name, t in (("block_tables", block_tables), ("q_positions", q_positions)):
        if t.dtype != torch.int32:
            raise TypeError(f"paged attention kernel takes int32 {name}, got {t.dtype}")
    if q.dim() != 4 or k_cache.dim() != 4 or block_tables.dim() != 2 or q_positions.dim() != 2:
        raise ValueError(
            "expected q [B,W,H,D], caches [NB,bs,H,D], block_tables [B,MB], "
            f"q_positions [B,W]; got {tuple(q.shape)}, {tuple(k_cache.shape)}, "
            f"{tuple(block_tables.shape)}, {tuple(q_positions.shape)}"
        )
    b, w, h, d = q.shape
    if k_cache.shape != v_cache.shape or tuple(k_cache.shape[2:]) != (h, d):
        raise ValueError(
            f"cache shapes {tuple(k_cache.shape)}/{tuple(v_cache.shape)} do not "
            f"match q heads/head_dim ({h}, {d})"
        )
    if block_tables.shape[0] != b or tuple(q_positions.shape) != (b, w):
        raise ValueError(
            f"block_tables {tuple(block_tables.shape)} / q_positions "
            f"{tuple(q_positions.shape)} do not match batch {b}, window {w}"
        )
    if not 1 <= w <= MAX_WINDOW:
        raise ValueError(f"window {w} outside the kernel's 1..{MAX_WINDOW}")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d} outside the kernel's 1..{MAX_HEAD_DIM}")
    if block_tables.shape[1] < 1 or k_cache.shape[1] < 1:
        raise ValueError("empty block table or zero block size")
    # the kernel indexes cache rows and key positions with 32-bit ints
    if max(k_cache.shape[0], block_tables.shape[1]) * k_cache.shape[1] >= 2**31:
        raise ValueError("cache rows or table positions exceed the kernel's 32-bit indexing")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("block_tables", block_tables), ("q_positions", q_positions)):
        if not t.is_contiguous():
            raise ValueError(f"paged attention kernel needs a contiguous {name}")


def _raise_on_error(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {rc}")


def kernel_cluster_size(max_blocks: int, block_size: int) -> int:
    """The thread blocks (one cluster) the single-pass CUDA kernel splits
    each (head, sequence) over for a table of ``max_blocks`` columns of
    ``block_size`` positions, as its launcher derives it. Builds the
    kernels on first use, like a launch."""
    from ._build import load_library

    return int(load_library().ff_paged_append_cluster_size(max_blocks, block_size))


def paged_append_attention_kernel(
    q, k_cache, v_cache, block_tables, q_positions, scale: float
) -> torch.Tensor:
    """Launch the single-pass CUDA kernel (no split): returns the
    normalised [B, W, H, D] output."""
    from ._build import load_library

    _check_kernel_inputs(q, k_cache, v_cache, block_tables, q_positions)
    lib = load_library()
    b, w, h, d = q.shape
    out = torch.empty_like(q)
    rc = lib.ff_paged_append_f32(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        block_tables.data_ptr(), q_positions.data_ptr(), out.data_ptr(),
        b, w, h, d, k_cache.shape[1], block_tables.shape[1], float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on_error(rc, "ff_paged_append_f32")
    LAUNCHES["paged_append"] += 1
    return out


def paged_append_split_kernel(
    q, k_cache, v_cache, block_tables, q_positions, kv_splits: int, scale: float
) -> torch.Tensor:
    """Launch the split-KV CUDA kernel: one cluster of
    ``split_plan(kv_splits, MB)[0]`` blocks per (head, sequence), combined
    on-chip; returns the normalised [B, W, H, D] output of
    ``_combine_splits(reference_paged_append_partials(...))``."""
    from ._build import load_library

    _check_kernel_inputs(q, k_cache, v_cache, block_tables, q_positions)
    lib = load_library()
    b, w, h, d = q.shape
    ctas, cols = split_plan(kv_splits, block_tables.shape[1])
    out = torch.empty_like(q)
    rc = lib.ff_paged_append_split_f32(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        block_tables.data_ptr(), q_positions.data_ptr(), out.data_ptr(),
        b, w, h, d, k_cache.shape[1], block_tables.shape[1], ctas, cols,
        float(scale), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on_error(rc, "ff_paged_append_split_f32")
    LAUNCHES["paged_append_split"] += 1
    return out


def paged_append_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    block_tables: torch.Tensor,
    q_positions: torch.Tensor,
    scale: Optional[float] = None,
    kv_splits: int = 1,
) -> torch.Tensor:
    """Paged chunked-append attention (shapes as in
    :func:`reference_paged_append_attention`). ``kv_splits > 1`` selects
    the flash-decoding split-KV form: the table's columns split into
    ``kv_splits`` independent ranges whose partial softmaxes recombine
    exactly.

    CUDA tensors launch the CUDA kernel, one launch either way (and raise
    on shapes or types it does not take); CPU tensors take the plain
    PyTorch version of the same computation (for ``kv_splits > 1``, the
    partials and :func:`_combine_splits`)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    splits, _ = _clamp_splits(kv_splits, block_tables.shape[1])
    args = (q, k_cache, v_cache, block_tables, q_positions)
    if q.device.type == "cuda":
        if splits == 1:
            return paged_append_attention_kernel(*args, scale)
        return paged_append_split_kernel(*args, splits, scale)
    if q.device.type == "cpu":
        if splits == 1:
            return reference_paged_append_attention(*args, scale)
        partials = reference_paged_append_partials(*args, splits, scale)
        return _combine_splits(*partials, q_positions, q.dtype)
    raise ValueError(f"paged attention runs on cuda or cpu, not {q.device}")


def paged_decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    block_tables: torch.Tensor,
    context_lens: torch.Tensor,
    scale: Optional[float] = None,
    kv_splits: Optional[int] = None,
) -> torch.Tensor:
    """One-token (decode) form of :func:`paged_append_attention` (shapes
    as in :func:`reference_paged_attention`). ``kv_splits`` None
    auto-selects via :func:`default_kv_splits`."""
    if kv_splits is None:
        kv_splits = default_kv_splits(q.shape[0], block_tables.shape[1])
    out = paged_append_attention(
        q[:, None], k_cache, v_cache, block_tables,
        (context_lens[:, None] - 1).to(torch.int32),
        scale=scale, kv_splits=kv_splits,
    )
    return out[:, 0]
