"""LayerNorm and BatchNorm (port of ``flexflow_tpu/ops/norm.py``).

Statistics in fp32, eps 1e-5, ``(x - mean) * rsqrt(var + eps)`` then the
affine scale and bias, as the JAX lowering computes them.

BatchNorm normalises over (N, H, W) with the biased variance (JAX's
``jnp.var``) while training and keeps its running statistics as
non-trainable state: ``running = 0.9 * running + 0.1 * batch`` (JAX's
``momentum`` 0.9, PyTorch's 0.1), written functionally into
``LowerCtx.state_updates`` and applied by the executor once a step, so
a block recomputed under rematerialization does not apply them twice.
``F.batch_norm`` is not used: its momentum is the other way round and
its running variance unbiased. Evaluation reads the running statistics.
On a data-parallel rank holding its rows of the batch the training
statistics are the global batch's, as GSPMD computes ``jnp.mean`` and
``jnp.var`` over the sharded batch (:func:`_global_moments`), so the
running statistics agree on every rank and with one device's. Under
``megatron_strategy(sp=True)`` LayerNorm runs on a rank's block of the
sequence (it normalizes the last dim only); the tensor-parallel executor
sums its whole ``scale`` and ``bias`` gradients over the model axis
(``runtime/tensor_parallel.py``).
"""
from __future__ import annotations

import dataclasses
from typing import List

import torch

from ..core.tensor import TensorSpec
from ..core.types import DataType, OpType
from .base import LowerCtx, OpCost, OpDef, WeightSpec, io_cost, register_op
from .elementwise import _weak


@dataclasses.dataclass(frozen=True)
class LayerNormParams:
    axes: tuple  # normalized axes (NumPy order)
    elementwise_affine: bool = True
    eps: float = 1e-5
    dtype: DataType = DataType.FLOAT


@register_op
class LayerNormOp(OpDef):
    op_type = OpType.LAYERNORM
    params_cls = LayerNormParams

    @staticmethod
    def infer_output_specs(params, input_specs: List[TensorSpec]):
        return [input_specs[0]]

    @staticmethod
    def weight_specs(params: LayerNormParams, input_specs: List[TensorSpec]) -> List[WeightSpec]:
        if not params.elementwise_affine:
            return []
        (x,) = input_specs
        shape = tuple(x.shape[a] for a in params.axes)
        return [
            WeightSpec("scale", TensorSpec(shape, params.dtype), "ones"),
            WeightSpec("bias", TensorSpec(shape, params.dtype), "zeros"),
        ]

    @staticmethod
    def lower(params: LayerNormParams, inputs, weights, ctx):
        (x,) = inputs
        axes = tuple(a % x.dim() for a in params.axes)
        xf = x.float()
        mean = xf.mean(dim=axes, keepdim=True)
        var = (xf - mean).square().mean(dim=axes, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + params.eps)
        if params.elementwise_affine:
            bshape = [x.shape[a] if a in axes else 1 for a in range(x.dim())]
            y = y * weights["scale"].reshape(bshape) + weights["bias"].reshape(bshape)
        return [y.to(x.dtype)]

    @staticmethod
    def cost(params, input_specs, output_specs) -> OpCost:
        return io_cost(input_specs, output_specs, flops=8.0 * output_specs[0].num_elements)


def _global_moments(xf: torch.Tensor, dims, shape, group):
    """The batch's mean and variance over every data-parallel rank's rows,
    in two passes as ``jnp.mean`` and ``jnp.var`` over the global batch:
    the mean from the summed sums, then the mean of the squares centred
    on it (never E[x^2] - E[x]^2). The sums reduce through an all-reduce
    with a backward, so the gradient sees the global statistics too."""
    from ..parallel.distributed import all_reduce_sum

    count = (xf.numel() // xf.shape[1]) * group.size
    mean = all_reduce_sum(xf.sum(dim=dims), group) / count
    var = all_reduce_sum((xf - mean.reshape(shape)).square().sum(dim=dims), group) / count
    return mean, var


@dataclasses.dataclass(frozen=True)
class BatchNormParams:
    relu: bool = True  # the reference's fused ReLU option
    eps: float = 1e-5
    momentum: float = 0.9
    dtype: DataType = DataType.FLOAT


@register_op
class BatchNormOp(OpDef):
    """BatchNorm over NCHW input, stats over (N, H, W) per channel."""

    op_type = OpType.BATCHNORM
    params_cls = BatchNormParams

    @staticmethod
    def infer_output_specs(params, input_specs: List[TensorSpec]):
        return [input_specs[0]]

    @staticmethod
    def weight_specs(params: BatchNormParams, input_specs: List[TensorSpec]) -> List[WeightSpec]:
        (x,) = input_specs
        c = (x.shape[1],)
        return [
            WeightSpec("scale", TensorSpec(c, params.dtype), "ones"),
            WeightSpec("bias", TensorSpec(c, params.dtype), "zeros"),
            WeightSpec("running_mean", TensorSpec(c, params.dtype), "zeros", trainable=False),
            WeightSpec("running_var", TensorSpec(c, params.dtype), "ones", trainable=False),
        ]

    @staticmethod
    def lower(params: BatchNormParams, inputs, weights, ctx: LowerCtx):
        (x,) = inputs
        dims = (0, 2, 3) if x.dim() == 4 else (0,)
        shape = [1, x.shape[1]] + [1] * (x.dim() - 2)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))  # float64 stays float64
        if ctx.training:
            if ctx.group is not None and ctx.split:
                mean, var = _global_moments(xf, dims, shape, ctx.group)
            else:
                mean = xf.mean(dim=dims)
                var = (xf - mean.reshape(shape)).square().mean(dim=dims)
            with torch.no_grad():
                rm, rv = weights["running_mean"], weights["running_var"]
                m, dt = params.momentum, params.dtype.torch
                ctx.state_updates[(ctx.node_guid, "running_mean")] = (
                    _weak(m, rm) * rm + _weak(1 - m, rm) * mean.to(dt))
                ctx.state_updates[(ctx.node_guid, "running_var")] = (
                    _weak(m, rv) * rv + _weak(1 - m, rv) * var.to(dt))
        else:
            mean = weights["running_mean"].to(xf.dtype)
            var = weights["running_var"].to(xf.dtype)
        y = (xf - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape) + params.eps)
        y = y * weights["scale"].reshape(shape) + weights["bias"].reshape(shape)
        y = y.to(x.dtype)
        if params.relu:
            y = torch.relu(y)
        return [y]

    @staticmethod
    def cost(params, input_specs, output_specs) -> OpCost:
        return io_cost(input_specs, output_specs, flops=10.0 * output_specs[0].num_elements)
