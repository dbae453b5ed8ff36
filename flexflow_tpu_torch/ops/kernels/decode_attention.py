"""Paged decode/append attention: a window of query tokens per sequence
attending over a block-structured KV cache (port of
``flexflow_tpu/ops/kernels/decode_attention.py``).

The generation engine's decode step calls this once per layer with a
one-token window (``q`` [B, H, D]); the verification step and the
suffix prefill of a cached prefix call the chunked-append form with a
W-token window (``q`` [B, W, H, D]; W up to the largest prompt bucket). Each
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
* the CUDA kernels of ``csrc/paged_attention.cu``, one form per cache
  dtype (float32, bfloat16, float16: K and V widen exactly to float32;
  q, the arithmetic and the output stay float32) — thread blocks that
  each stage one range of a sequence's table columns through shared
  memory, one thread-block cluster per (head, sequence), whose blocks
  combine their softmax states through distributed shared memory in the
  same launch. Each form has two bodies (:func:`kernel_body`): a window
  of :data:`TC_MIN_WINDOW` queries or more at a head dim up to
  :data:`TC_MAX_HEAD_DIM` (a suffix prefill's, a wide verify window's)
  takes tiles of 64 queries on the tensor cores (3xTF32 ``mma.sync``
  over an fp32 cache, two TF32 products over a 2-byte one: fp32
  accuracy); decode and verify windows up to 8 queries, and wider heads,
  take the CUDA-core body, whose windows past :data:`WINDOW_TILE`
  queries are cut into tiles of that many, each its own cluster of the
  same launch. The single-pass kernel shares the live positions among
  its cluster's blocks (:func:`kernel_cluster_size` for the CUDA-core
  body); the split-KV kernel gives each block a run of whole splits
  (:func:`split_plan`) and writes the combined output, so
  ``kv_splits > 1`` is one launch too. For a CUDA tensor
  :func:`paged_append_attention` launches the kernel or raises; it never
  falls back to the plain version.

Each kernel launch runs on the device of its tensors (whatever the
current device is) and adds one to its form's count in :data:`LAUNCHES`
(``paged_append`` and ``paged_append_split`` for a float32 cache, with
``_bf16`` or ``_f16`` for a 2-byte one), and to the same form's count of
its window's class in :data:`LAUNCHES_BY_WINDOW`, so a run
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
WINDOW_TILE = 32  # queries a CUDA-core block takes; a wider window launches tiles of them
# the tensor-core body's windows and head dims (kTcMinWindow, kTcMaxHeadDim
# in csrc/paged_attention.cu)
TC_MIN_WINDOW = 9
TC_MAX_HEAD_DIM = 128
MAX_GRID_Z = 65535  # (sequence, query tile) pairs a launch can hold
MAX_HEAD_DIM = 512  # the kernel's widest instance (kMaxD in csrc/paged_attention.cu)
MAX_CLUSTER = 8  # the portable thread-block cluster size the kernels launch

# the kernels' form per cache dtype: (symbol suffix, launch-count suffix)
_FORMS = {torch.float32: ("f32", ""), torch.bfloat16: ("bf16", "_bf16"),
          torch.float16: ("f16", "_f16")}
# launches of each CUDA kernel in this process (plain integers; a caller
# resets them with reset_launch_counts() before the run it measures)
LAUNCHES: Dict[str, int] = {
    f"{kernel}{count}": 0
    for _, count in _FORMS.values() for kernel in ("paged_append", "paged_append_split")
}


# the same launches by query window: "<LAUNCHES key> W=1" (decode),
# "... W=2-8" (verify windows, on the CUDA-core body) and "... W>=9"
# (suffix prefills and wide verify windows, the tensor-core body at D <= 128)
WINDOW_CLASSES = ("W=1", "W=2-8", "W>=9")
LAUNCHES_BY_WINDOW: Dict[str, int] = {
    f"{name} {cls}": 0 for name in LAUNCHES for cls in WINDOW_CLASSES
}


def _count_launch(name: str, window: int) -> None:
    LAUNCHES[name] += 1
    cls = WINDOW_CLASSES[0 if window == 1 else 1 if window < TC_MIN_WINDOW else 2]
    LAUNCHES_BY_WINDOW[f"{name} {cls}"] += 1


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, LAUNCHES_BY_WINDOW):
        for name in counts:
            counts[name] = 0


def launch_counts() -> Dict[str, int]:
    """A copy of :data:`LAUNCHES` and :data:`LAUNCHES_BY_WINDOW` together."""
    return {**LAUNCHES, **LAUNCHES_BY_WINDOW}


def captured_launches(before: Dict[str, int]) -> Dict[str, int]:
    """The launches recorded since ``before`` (:func:`launch_counts` taken
    just before a CUDA graph capture), which are the capture's: a capture
    records its launches and runs none, so the counts go back to
    ``before`` and each replay adds these with :func:`count_replay`."""
    captured = {}
    for counts in (LAUNCHES, LAUNCHES_BY_WINDOW):
        captured.update({name: counts[name] - before[name] for name in counts})
        counts.update({name: before[name] for name in counts})
    return captured


def count_replay(captured: Dict[str, int]) -> None:
    """Count one replay of a graph whose capture recorded ``captured``."""
    for name, n in captured.items():
        (LAUNCHES if name in LAUNCHES else LAUNCHES_BY_WINDOW)[name] += n


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
    passed: one device, float32 q, caches of one dtype the kernels have
    a form for (float32, bfloat16, float16), int32 indices, the JAX
    layouts, contiguity, head_dim <= 512, and at most 65535 (sequence,
    query tile) pairs: any window W >= 1 is taken, in tiles of
    :data:`WINDOW_TILE` queries."""
    dev = q.device
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache),
                    ("block_tables", block_tables), ("q_positions", q_positions)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    if q.dtype != torch.float32:
        raise TypeError(f"paged attention kernel takes float32 q, got {q.dtype}")
    if k_cache.dtype not in _FORMS or v_cache.dtype != k_cache.dtype:
        raise TypeError(
            "paged attention kernel takes k_cache and v_cache of one dtype among "
            f"{sorted(str(d) for d in _FORMS)}, got {k_cache.dtype} and {v_cache.dtype}"
        )
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
    if w < 1:
        raise ValueError(f"empty query window {w}")
    if b * -(-w // WINDOW_TILE) > MAX_GRID_Z:
        raise ValueError(
            f"{b} sequences x {-(-w // WINDOW_TILE)} query tiles exceed the kernel's "
            f"{MAX_GRID_Z} (sequence, tile) pairs"
        )
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


def kernel_body(window: int, head_dim: int) -> str:
    """Which body of the CUDA kernels a launch of this query window and
    head dim runs: ``"tensor_cores"`` or ``"cuda_cores"``."""
    if window >= TC_MIN_WINDOW and head_dim <= TC_MAX_HEAD_DIM:
        return "tensor_cores"
    return "cuda_cores"


def kernel_cluster_size(max_blocks: int, block_size: int) -> int:
    """The thread blocks (one cluster) the single-pass CUDA kernel's
    CUDA-core body splits each (head, sequence) over for a table of
    ``max_blocks`` columns of ``block_size`` positions, as its launcher
    derives it (the tensor-core body sizes its cluster from the launch's
    query tiles as well). Builds the kernels on first use, like a
    launch."""
    from ._build import load_library

    return int(load_library().ff_paged_append_cluster_size(max_blocks, block_size))


def paged_append_attention_kernel(
    q, k_cache, v_cache, block_tables, q_positions, scale: float
) -> torch.Tensor:
    """Launch the single-pass CUDA kernel (no split) of the caches'
    dtype: returns the normalised float32 [B, W, H, D] output."""
    from ._build import load_library

    _check_kernel_inputs(q, k_cache, v_cache, block_tables, q_positions)
    form, count = _FORMS[k_cache.dtype]
    symbol = f"ff_paged_append_{form}"
    b, w, h, d = q.shape
    out = torch.empty_like(q)
    lib = load_library()
    with torch.cuda.device(q.device):
        rc = getattr(lib, symbol)(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            block_tables.data_ptr(), q_positions.data_ptr(), out.data_ptr(),
            b, w, h, d, k_cache.shape[1], block_tables.shape[1], float(scale),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _raise_on_error(rc, symbol)
    _count_launch("paged_append" + count, w)
    return out


def paged_append_split_kernel(
    q, k_cache, v_cache, block_tables, q_positions, kv_splits: int, scale: float
) -> torch.Tensor:
    """Launch the split-KV CUDA kernel of the caches' dtype: one cluster
    of ``split_plan(kv_splits, MB)[0]`` blocks per (head, sequence),
    combined on-chip; returns the normalised float32 [B, W, H, D] output
    of ``_combine_splits(reference_paged_append_partials(...))``."""
    from ._build import load_library

    _check_kernel_inputs(q, k_cache, v_cache, block_tables, q_positions)
    form, count = _FORMS[k_cache.dtype]
    symbol = f"ff_paged_append_split_{form}"
    b, w, h, d = q.shape
    ctas, cols = split_plan(kv_splits, block_tables.shape[1])
    out = torch.empty_like(q)
    lib = load_library()
    with torch.cuda.device(q.device):
        rc = getattr(lib, symbol)(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            block_tables.data_ptr(), q_positions.data_ptr(), out.data_ptr(),
            b, w, h, d, k_cache.shape[1], block_tables.shape[1], ctas, cols,
            float(scale), torch.cuda.current_stream(q.device).cuda_stream,
        )
    _raise_on_error(rc, symbol)
    _count_launch("paged_append_split" + count, w)
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

    CUDA tensors launch the CUDA kernel of the caches' dtype, one launch
    either way (and raise on shapes or types it does not take: q must be
    float32, the caches float32, bfloat16 or float16); CPU tensors take the plain
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
