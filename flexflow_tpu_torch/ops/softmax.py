"""Softmax and Dropout (port of ``flexflow_tpu/ops/softmax.py``).

Softmax is ``jax.nn.softmax``'s arithmetic with its rounding points: the
max, ``exp(x - max)`` rounded to x's dtype, the sum accumulated in
float32 and rounded (``jnp.sum`` upcasts a 2-byte input), the quotient
rounded; and its gradient is the transpose of JAX's linearization of
those ops (``jax.nn.softmax`` differentiates its primal ops by default):
``(g / s - sum(g * s^-2 * u)) * u`` with ``u = exp(x - max)`` and
``s = sum(u)``, rounded at the same ops. In float32 every
rounding is the identity; in bf16 and fp16 the ops round where JAX's
eager ops round (only the float32 sums run in another order).

Dropout draws JAX's mask: ``bernoulli(fold_in(step key, node guid), keep,
shape)`` on threefry2x32 bits (``generation/prng.py``), bit for bit, and
returns ``where(mask, x / keep, 0)`` in x's dtype, with ``keep`` rounded to
x's dtype first (a Python float against a 2-byte array is weakly typed
in JAX). Outside training it is the identity. A data-parallel rank
draws its rows of JAX's global mask, and only those: the threefry
counters start at the rank's element offset (``LowerCtx.row_offset``),
so its mask is rows ``r`` of the mask GSPMD draws at the global shape,
bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import List

import torch

from ..core.tensor import TensorSpec
from ..core.types import OpType
from .base import LowerCtx, OpCost, OpDef, io_cost, register_op


def _sum_f32(x: torch.Tensor, axis: int) -> torch.Tensor:
    """``jnp.sum(x, axis, keepdims=True)``: float32 accumulation, rounded
    to x's dtype."""
    return x.float().sum(dim=axis, keepdim=True).to(x.dtype)


class _Softmax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, axis: int):
        m = x.amax(dim=axis, keepdim=True)
        u = torch.exp(x - m)
        s = _sum_f32(u, axis)
        ctx.save_for_backward(u, s)
        ctx.axis = axis
        return u / s

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        # the transpose of JAX's linearization of u / sum(u), u = exp(x -
        # stop_gradient(max)), op by op: the quotient's two cotangents
        # (g / s, and -sum(g * s^-2 * u) through the float32 sum), then
        # exp's (times u)
        u, s = ctx.saved_tensors
        inv_s2 = torch.reciprocal(s * s)  # JAX's integer_pow(s, -2), rounded twice
        back = _sum_f32(g * inv_s2 * u, ctx.axis)
        return (g / s - back) * u, None


def softmax(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """``jax.nn.softmax(x, axis)`` in x's dtype, with its gradient."""
    return _Softmax.apply(x, axis)


def dropout(x: torch.Tensor, rate: float, ctx: LowerCtx) -> torch.Tensor:
    """JAX's dropout tail: the node's mask drawn on x's device in one
    call, ``where(mask, x / keep, 0)`` in x's dtype; the identity when
    not training or at rate 0."""
    if not ctx.training or rate <= 0.0:
        return x
    keep = 1.0 - rate
    from ..generation import prng  # the generation package imports the ops

    mask = prng.bernoulli(ctx.node_rng(), keep, tuple(x.shape), offset=ctx.row_offset(x))
    if ctx.masks is not None:
        ctx.masks.append(mask)
    # a 0-d tensor on x's device, in x's dtype: a true division, as JAX
    # divides (CUDA multiplies by the reciprocal of a host scalar)
    k = torch.full((), keep, dtype=x.dtype, device=x.device)
    return torch.where(mask, x / k, 0.0)


@dataclasses.dataclass(frozen=True)
class SoftmaxParams:
    axis: int = -1


@register_op
class SoftmaxOp(OpDef):
    op_type = OpType.SOFTMAX
    params_cls = SoftmaxParams

    @staticmethod
    def infer_output_specs(params, input_specs: List[TensorSpec]):
        return [input_specs[0]]

    @staticmethod
    def lower(params: SoftmaxParams, inputs, weights, ctx):
        return [softmax(inputs[0], params.axis)]

    @staticmethod
    def cost(params, input_specs, output_specs) -> OpCost:
        return io_cost(input_specs, output_specs, flops=5.0 * output_specs[0].num_elements)


@dataclasses.dataclass(frozen=True)
class DropoutParams:
    rate: float
    seed: int = 0


@register_op
class DropoutOp(OpDef):
    op_type = OpType.DROPOUT
    params_cls = DropoutParams

    @staticmethod
    def infer_output_specs(params, input_specs: List[TensorSpec]):
        return [input_specs[0]]

    @staticmethod
    def lower(params: DropoutParams, inputs, weights, ctx: LowerCtx):
        return [dropout(inputs[0], params.rate, ctx)]

    @staticmethod
    def cost(params, input_specs, output_specs) -> OpCost:
        return io_cost(input_specs, output_specs, flops=2.0 * output_specs[0].num_elements)
