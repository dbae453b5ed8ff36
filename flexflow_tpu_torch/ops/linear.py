"""Dense (Linear) operator (port of ``flexflow_tpu/ops/linear.py``).

``y = x @ W + b`` with x[..., in_dim] and W[in_dim, out_dim]. The matrix
product is a plain ``torch.matmul`` (cuBLAS on the card), as the JAX
package leaves it to XLA: no hand-written GEMM.
"""
from __future__ import annotations

import dataclasses
from typing import List

import torch

from ..core.tensor import TensorSpec
from ..core.types import ActiMode, DataType, OpType
from .base import OpDef, WeightSpec, register_op
from .elementwise import apply_activation


@dataclasses.dataclass(frozen=True)
class LinearParams:
    out_dim: int
    use_bias: bool = True
    activation: ActiMode = ActiMode.NONE
    dtype: DataType = DataType.FLOAT
    kernel_initializer: str = "glorot_uniform"
    bias_initializer: str = "zeros"


@register_op
class LinearOp(OpDef):
    op_type = OpType.LINEAR

    @staticmethod
    def infer_output_specs(params: LinearParams, input_specs: List[TensorSpec]) -> List[TensorSpec]:
        (x,) = input_specs
        return [TensorSpec(x.shape[:-1] + (params.out_dim,), params.dtype)]

    @staticmethod
    def weight_specs(params: LinearParams, input_specs: List[TensorSpec]) -> List[WeightSpec]:
        (x,) = input_specs
        ws = [WeightSpec("kernel", TensorSpec((x.shape[-1], params.out_dim), params.dtype),
                         params.kernel_initializer)]
        if params.use_bias:
            ws.append(WeightSpec("bias", TensorSpec((params.out_dim,), params.dtype),
                                 params.bias_initializer))
        return ws

    @staticmethod
    def lower(params: LinearParams, inputs, weights, ctx):
        (x,) = inputs
        y = torch.matmul(x, weights["kernel"]).to(params.dtype.torch)
        if params.use_bias:
            y = y + weights["bias"]
        return [apply_activation(params.activation, y)]
