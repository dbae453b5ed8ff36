"""LayerNorm (port of ``LayerNormOp`` in ``flexflow_tpu/ops/norm.py``;
BatchNorm waits for the convolution slice).

Statistics in fp32, eps 1e-5, ``(x - mean) * rsqrt(var + eps)`` then the
affine scale and bias, as the JAX lowering computes them.
"""
from __future__ import annotations

import dataclasses
from typing import List

import torch

from ..core.tensor import TensorSpec
from ..core.types import DataType, OpType
from .base import OpDef, WeightSpec, register_op


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
