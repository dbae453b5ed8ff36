"""Reduction-style operators: Gather, ReduceSum, Mean (port of
``flexflow_tpu/ops/reduction_ops.py``).

Gather has ``jnp.take_along_axis`` semantics (the index has the data's
rank and the output its shape): a negative index counts from the end of
the axis, and an index outside it gives NaN (JAX's "fill" mode) for a
floating-point input, with no host sync. ReduceSum and Mean reduce
over ``axes`` with ``keepdims``; a 2-byte input accumulates in float32
and rounds once to its type, as ``jnp.sum`` and ``jnp.mean`` do.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch

from ..core.tensor import TensorSpec
from ..core.types import OpType
from .base import OpCost, OpDef, io_cost, register_op


@dataclasses.dataclass(frozen=True)
class GatherParams:
    axis: int


@register_op
class GatherOp(OpDef):
    """torch.gather semantics: index tensor same rank as input
    (reference: gather.cc — index/input shapes match except on `axis`)."""

    op_type = OpType.GATHER
    params_cls = GatherParams

    @staticmethod
    def infer_output_specs(params: GatherParams, input_specs: List[TensorSpec]):
        data, index = input_specs
        return [TensorSpec(index.shape, data.dtype)]

    @staticmethod
    def lower(params: GatherParams, inputs, weights, ctx):
        data, index = inputs
        axis = params.axis % data.dim()
        n = data.shape[axis]
        i = index.long()
        i = torch.where(i < 0, i + n, i)
        inside = (i >= 0) & (i < n)
        out = torch.gather(data, axis, i.clamp(0, n - 1))
        if out.is_floating_point():
            out = torch.where(inside, out, float("nan"))
        return [out]


@dataclasses.dataclass(frozen=True)
class ReduceSumParams:
    axes: Tuple[int, ...]
    keepdims: bool = False


def _reduced_shape(shape, axes, keepdims: bool) -> Tuple[int, ...]:
    axes = {a % len(shape) for a in axes}
    if keepdims:
        return tuple(1 if i in axes else s for i, s in enumerate(shape))
    return tuple(s for i, s in enumerate(shape) if i not in axes)


def _reduce(fn, x: torch.Tensor, axes, keepdims: bool) -> torch.Tensor:
    dims = tuple(sorted({a % x.dim() for a in axes}))
    if x.dtype in (torch.bfloat16, torch.float16):
        return fn(x.float(), dim=dims, keepdim=keepdims).to(x.dtype)
    return fn(x, dim=dims, keepdim=keepdims)


@register_op
class ReduceSumOp(OpDef):
    op_type = OpType.REDUCE_SUM
    params_cls = ReduceSumParams

    @staticmethod
    def infer_output_specs(params: ReduceSumParams, input_specs: List[TensorSpec]):
        (x,) = input_specs
        return [TensorSpec(_reduced_shape(x.shape, params.axes, params.keepdims), x.dtype)]

    @staticmethod
    def lower(params: ReduceSumParams, inputs, weights, ctx):
        return [_reduce(torch.sum, inputs[0], params.axes, params.keepdims)]

    @staticmethod
    def cost(params, input_specs, output_specs) -> OpCost:
        return io_cost(input_specs, output_specs, flops=float(input_specs[0].num_elements))


@dataclasses.dataclass(frozen=True)
class MeanParams:
    axes: Tuple[int, ...]
    keepdims: bool = False


@register_op
class MeanOp(OpDef):
    op_type = OpType.MEAN
    params_cls = MeanParams

    @staticmethod
    def infer_output_specs(params: MeanParams, input_specs: List[TensorSpec]):
        (x,) = input_specs
        return [TensorSpec(_reduced_shape(x.shape, params.axes, params.keepdims), x.dtype)]

    @staticmethod
    def lower(params: MeanParams, inputs, weights, ctx):
        return [_reduce(torch.mean, inputs[0], params.axes, params.keepdims)]

    @staticmethod
    def cost(params, input_specs, output_specs) -> OpCost:
        return io_cost(input_specs, output_specs, flops=float(input_specs[0].num_elements))
