"""MultiHeadAttention and the attention cores (port of
``flexflow_tpu/ops/attention.py``).

Tensors are [B, S, H, D], as in the JAX package. The training path's
``MultiHeadAttentionOp`` projects with einsums and runs its core through
:func:`attention_core` (the flash kernels on a GPU); the generation path
uses the paged decode/append cores and the masked prefill attention.
Dropout after the output projection and its bias draws JAX's mask
(``softmax.dropout``). Head parallel (``runtime/tensor_parallel.py``):
with ``wq/wk/wv`` sharded on H and ``wo`` on its first dim, a rank's
q, k and v hold its H/tp heads, the flash kernels run on those at the
whole head dim's scale, and the output projection's partial sums meet
(an all-reduce over the model axis) before ``bo`` and the dropout, which
then draws the same rows of JAX's mask on every model rank. Ring/Ulysses
context parallelism waits for ROADMAP queue 1 item 5b.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from ..core.tensor import TensorSpec
from ..core.types import DataType, OpType
from .base import LowerCtx, OpCost, OpDef, WeightSpec, io_cost, register_op
from .linear import promoted
from .softmax import dropout
from .kernels.flash_attention import flash_attention
from .kernels.decode_attention import (
    paged_append_attention,
    paged_decode_attention,
    reference_paged_append_attention,
    reference_paged_attention,
    sharded_paged_append_attention,
    sharded_paged_decode_attention,
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
    params_cls = MultiHeadAttentionParams

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
        # projections: [B, S, E] x [E, H, D] -> [B, S, H, D], in the
        # operands' common type, as JAX's einsums promote (a bfloat16
        # layer computes them in bfloat16 with float32 accumulation and
        # hands bfloat16 q, k and v to the flash kernels)
        qh = torch.einsum("bse,ehd->bshd", *promoted(q, weights["wq"]))
        kh = torch.einsum("bse,ehd->bshd", *promoted(k, weights["wk"]))
        vh = torch.einsum("bse,ehd->bshd", *promoted(v, weights["wv"]))
        if params.use_bias:
            qh = qh + weights["bq"]
            kh = kh + weights["bk"]
            vh = vh + weights["bv"]
        ctx_out = attention_core(qh, kh, vh, causal=params.causal, backend=ctx.backend)
        out = torch.einsum("bshd,hde->bse", *promoted(ctx_out, weights["wo"]))
        if ctx.sharded.get("wo") == 0:
            # head parallel: this rank's heads give a partial sum of the
            # projection, summed over the model axis before bo and dropout
            out = ctx.reduce_partial(out)
        if params.use_bias:
            out = out + weights["bo"]
        out = dropout(out, params.dropout, ctx)
        return [out.to(params.dtype.torch)]

    @staticmethod
    def cost(params: MultiHeadAttentionParams, input_specs, output_specs) -> OpCost:
        q, k, v = input_specs
        b, sq = q.shape[0], q.shape[1]
        sk = k.shape[1]
        h, dk, dv, e = params.num_heads, params.head_dim, params.v_head_dim, params.embed_dim
        proj = 2.0 * b * (sq * q.shape[-1] * h * dk + sk * k.shape[-1] * h * dk
                          + sk * v.shape[-1] * h * dv + sq * h * dv * e)
        core = 2.0 * b * h * sq * sk * (dk + dv)
        w_elems = q.shape[-1] * h * dk + k.shape[-1] * h * dk + v.shape[-1] * h * dv + h * dv * e
        w_bytes = w_elems * params.dtype.size_bytes
        c = io_cost(input_specs, output_specs, flops=proj + core, extra_mem=w_bytes)
        c.bytes_accessed += w_bytes
        return c


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
    shard=None,
) -> torch.Tensor:
    """Decode-mode attention: one query token per sequence ([B, H, D])
    over the block-structured KV cache with position masking, so
    incremental decode reproduces full-context causal logits.

    ``backend="auto"`` dispatches on the tensors' device: CUDA tensors
    launch the paged CUDA kernel (kernels/decode_attention.py, split-KV
    auto-selected), CPU tensors take the plain PyTorch version.
    ``backend="plain"`` asks for the plain version on any device — the
    check a caller runs to hold the kernel path against it. ``shard`` (a
    tensor-parallel rank's :class:`~..generation.sharding.RankContext`,
    degree > 1) routes through the head-sharded form: q and the caches
    are the rank's own heads."""
    _check_backend(backend)
    if backend == "plain":
        return reference_paged_attention(
            q, k_cache, v_cache, block_tables, context_lens, scale=scale
        )
    if shard is not None and shard.tp_degree > 1:
        return sharded_paged_decode_attention(
            q, k_cache, v_cache, block_tables, context_lens, shard.tp_degree,
            rank=shard.rank, scale=scale,
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
    shard=None,
) -> torch.Tensor:
    """Chunked-append attention: a W-token window per sequence
    ([B, W, H, D], K/V already written) over the block-structured KV
    cache. Query (b, w) attends cache positions ``<= q_positions[b, w]``;
    ``q_positions < 0`` marks padding queries (they emit zeros). Dispatch
    (and ``shard``) as in :func:`decode_attention_core`."""
    _check_backend(backend)
    if backend == "plain":
        return reference_paged_append_attention(
            q, k_cache, v_cache, block_tables, q_positions, scale=scale
        )
    if shard is not None and shard.tp_degree > 1:
        return sharded_paged_append_attention(
            q, k_cache, v_cache, block_tables, q_positions, shard.tp_degree,
            rank=shard.rank, scale=scale,
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
