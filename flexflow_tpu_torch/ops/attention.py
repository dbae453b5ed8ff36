"""MultiHeadAttention and the attention cores (port of
``flexflow_tpu/ops/attention.py``).

Tensors are [B, S, H, D], as in the JAX package. The training path's
``MultiHeadAttentionOp`` projects with einsums and runs its core through
:func:`attention_core` (the flash kernels on a GPU); the generation path
uses the paged decode/append cores and the masked prefill attention.
Ring/Ulysses context parallelism, the mesh branches and attention
dropout wait for the multi-GPU slices.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from ..core.tensor import TensorSpec
from ..core.types import DataType, OpType
from .base import LowerCtx, OpDef, WeightSpec, register_op
from .kernels.flash_attention import flash_attention
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


@dataclasses.dataclass(frozen=True)
class MultiHeadAttentionParams:
    embed_dim: int
    num_heads: int
    kdim: int = 0  # 0 -> embed_dim // num_heads
    vdim: int = 0
    dropout: float = 0.0
    use_bias: bool = False
    causal: bool = False
    dtype: DataType = DataType.FLOAT

    @property
    def head_dim(self) -> int:
        return self.kdim or self.embed_dim // self.num_heads

    @property
    def v_head_dim(self) -> int:
        return self.vdim or self.embed_dim // self.num_heads


@register_op
class MultiHeadAttentionOp(OpDef):
    op_type = OpType.MULTIHEAD_ATTENTION

    @staticmethod
    def infer_output_specs(params: MultiHeadAttentionParams, input_specs: List[TensorSpec]):
        q = input_specs[0]
        return [TensorSpec(q.shape[:-1] + (params.embed_dim,), params.dtype)]

    @staticmethod
    def weight_specs(params: MultiHeadAttentionParams, input_specs: List[TensorSpec]) -> List[WeightSpec]:
        q, k, v = input_specs
        h, dk, dv, e = params.num_heads, params.head_dim, params.v_head_dim, params.embed_dim
        dt = params.dtype
        ws = [
            WeightSpec("wq", TensorSpec((q.shape[-1], h, dk), dt), "glorot_uniform"),
            WeightSpec("wk", TensorSpec((k.shape[-1], h, dk), dt), "glorot_uniform"),
            WeightSpec("wv", TensorSpec((v.shape[-1], h, dv), dt), "glorot_uniform"),
            WeightSpec("wo", TensorSpec((h, dv, e), dt), "glorot_uniform"),
        ]
        if params.use_bias:
            ws += [
                WeightSpec("bq", TensorSpec((h, dk), dt), "zeros"),
                WeightSpec("bk", TensorSpec((h, dk), dt), "zeros"),
                WeightSpec("bv", TensorSpec((h, dv), dt), "zeros"),
                WeightSpec("bo", TensorSpec((e,), dt), "zeros"),
            ]
        return ws

    @staticmethod
    def lower(params: MultiHeadAttentionParams, inputs, weights, ctx: LowerCtx):
        q, k, v = inputs
        # projections: [B, S, E] x [E, H, D] -> [B, S, H, D]
        qh = torch.einsum("bse,ehd->bshd", q, weights["wq"])
        kh = torch.einsum("bse,ehd->bshd", k, weights["wk"])
        vh = torch.einsum("bse,ehd->bshd", v, weights["wv"])
        if params.use_bias:
            qh = qh + weights["bq"]
            kh = kh + weights["bk"]
            vh = vh + weights["bv"]
        ctx_out = attention_core(qh, kh, vh, causal=params.causal, backend=ctx.backend)
        out = torch.einsum("bshd,hde->bse", ctx_out, weights["wo"])
        if params.use_bias:
            out = out + weights["bo"]
        return [out.to(params.dtype.torch)]


def attention_core(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    backend: str = "auto",
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Scaled dot-product attention over [B, S, H, D] tensors, with the
    flash backward under autograd.

    ``backend="auto"`` dispatches on the tensors' device: CUDA tensors
    launch the flash CUDA kernels (kernels/flash_attention.py) and raise
    on shapes they do not take, CPU tensors take the plain PyTorch
    versions. ``backend="plain"`` asks for the plain versions on any
    device. Causal attention needs Sq == Sk (the kernels' top-left
    mask)."""
    return flash_attention(q, k, v, causal=causal, scale=scale, backend=backend)


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
