"""Attention for the generation path (port of the generation-side
functions of ``flexflow_tpu/ops/attention.py``; ``MultiHeadAttentionOp``
and the flash-attention dispatch belong to the training slice).

Tensors are [B, S, H, D], as in the JAX package.
"""
from __future__ import annotations

from typing import Optional

import torch

from .kernels.decode_attention import (
    paged_append_attention,
    paged_decode_attention,
    reference_paged_append_attention,
    reference_paged_attention,
)

_BACKENDS = ("auto", "plain")


def _check_backend(backend: str) -> None:
    if backend not in _BACKENDS:
        raise ValueError(f"backend must be one of {_BACKENDS}, got {backend!r}")


def decode_attention_core(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    block_tables: torch.Tensor,
    context_lens: torch.Tensor,
    scale: Optional[float] = None,
    backend: str = "auto",
) -> torch.Tensor:
    """Decode-mode attention: one query token per sequence ([B, H, D])
    over the block-structured KV cache with position masking, so
    incremental decode reproduces full-context causal logits.

    ``backend="auto"`` dispatches on the tensors' device: CUDA tensors
    launch the paged CUDA kernel (kernels/decode_attention.py, split-KV
    auto-selected), CPU tensors take the plain PyTorch version.
    ``backend="plain"`` asks for the plain version on any device — the
    check a caller runs to hold the kernel path against it."""
    _check_backend(backend)
    if backend == "plain":
        return reference_paged_attention(
            q, k_cache, v_cache, block_tables, context_lens, scale=scale
        )
    return paged_decode_attention(
        q, k_cache, v_cache, block_tables, context_lens, scale=scale
    )


def append_attention_core(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    block_tables: torch.Tensor,
    q_positions: torch.Tensor,
    scale: Optional[float] = None,
    backend: str = "auto",
) -> torch.Tensor:
    """Chunked-append attention: a W-token window per sequence
    ([B, W, H, D], K/V already written) over the block-structured KV
    cache. Query (b, w) attends cache positions ``<= q_positions[b, w]``;
    ``q_positions < 0`` marks padding queries (they emit zeros). Dispatch
    as in :func:`decode_attention_core`."""
    _check_backend(backend)
    if backend == "plain":
        return reference_paged_append_attention(
            q, k_cache, v_cache, block_tables, q_positions, scale=scale
        )
    return paged_append_attention(
        q, k_cache, v_cache, block_tables, q_positions, scale=scale
    )


def masked_attention(q, k, v, lengths, causal=True, scale=None):
    """Causal attention over [B, S, H, D] with a per-sequence valid
    length: key positions >= lengths[b] are masked. The prefill side of
    the decode split — bucketed (padded) prompts attend only over their
    real tokens, so prefill logits match the unpadded forward."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    sq, sk = logits.shape[-2], logits.shape[-1]
    mask = torch.arange(sk, device=q.device)[None, :] < lengths[:, None]  # [B, Sk]
    mask = mask[:, None, None, :]
    if causal:
        tri = torch.ones((sq, sk), dtype=torch.bool, device=q.device).tril(diagonal=sk - sq)
        mask = mask & tri[None, None]
    logits = torch.where(mask, logits, -torch.inf)
    m = logits.amax(dim=-1, keepdim=True)
    # fully-masked rows (padding queries) get uniform-zero probs, not NaN
    p = torch.where(mask, torch.exp(logits - m.clamp_min(-1e30)), 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return torch.einsum("bhqk,bkhd->bqhd", (p / l).to(v.dtype), v)


def reference_attention(q, k, v, causal=False, scale=None):
    """Plain scaled dot-product attention over [B, S, H, D]."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        sq, sk = logits.shape[-2], logits.shape[-1]
        mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device).tril(diagonal=sk - sq)
        logits = torch.where(mask, logits, -torch.inf)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
