"""Dense (Linear) operator (port of ``flexflow_tpu/ops/linear.py``).

``y = x @ W + b`` with x[..., in_dim] and W[in_dim, out_dim]. The matrix
product is a plain ``torch.matmul`` (cuBLAS on the card), as the JAX
package leaves it to XLA: no hand-written GEMM.

Types as the JAX lowering's ``jnp.dot(x, W, preferred_element_type=
float32).astype(dtype)``: x and W are promoted to their common type (a
bfloat16 layer fed float32 activations multiplies in float32), the
product accumulates in float32 (cuBLAS's bfloat16 GEMMs and the CPU's
accumulate in float32) and is rounded once to the layer's dtype; the
bias and the activation then run in that dtype.

Tensor parallel (``runtime/tensor_parallel.py``): a column-parallel
linear (kernel dim 1 and bias sharded on the ``model`` axis) is the same
product on the rank's columns; a row-parallel one (kernel dim 0) takes
the rank's block of the input's last dim and sums the partial products
over the model axis before its bias and activation.
"""
from __future__ import annotations

import dataclasses
from typing import List

import torch

from ..core.tensor import TensorSpec
from ..core.types import ActiMode, DataType, OpType
from .base import OpCost, OpDef, WeightSpec, io_cost, register_op
from .elementwise import apply_activation


def promoted(*tensors: torch.Tensor):
    """The tensors in their common type, as JAX promotes the operands of
    a dot or an einsum (PyTorch's matmul refuses mixed dtypes)."""
    dt = tensors[0].dtype
    for t in tensors[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return [t.to(dt) for t in tensors]


@dataclasses.dataclass(frozen=True)
class LinearParams:
    out_dim: int
    use_bias: bool = True
    activation: ActiMode = ActiMode.NONE
    dtype: DataType = DataType.FLOAT
    kernel_initializer: str = "glorot_uniform"
    bias_initializer: str = "zeros"


def row_parallel_reduces(params: LinearParams) -> bool:
    """Whether a row-parallel linear (its kernel's rows sharded on the
    ``model`` axis) sums its partials itself: when a bias or an activation
    follows the product. Else its output stays a partial sum for the
    consumer's reduction (``runtime/tensor_parallel.py``)."""
    return params.use_bias or params.activation != ActiMode.NONE


@register_op
class LinearOp(OpDef):
    op_type = OpType.LINEAR
    params_cls = LinearParams

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
        y = torch.matmul(*promoted(x, weights["kernel"])).to(params.dtype.torch)
        if ctx.sharded.get("kernel") == 0 and row_parallel_reduces(params):
            # row parallel: x is this rank's block of the input's last dim,
            # y its partial sum; the sum comes before the bias (added once)
            # and the activation (not linear)
            y = ctx.reduce_partial(y)
        if params.use_bias:
            y = y + weights["bias"]
        return [apply_activation(params.activation, y)]

    @staticmethod
    def cost(params: LinearParams, input_specs, output_specs) -> OpCost:
        (x,) = input_specs
        in_dim = x.shape[-1]
        batch = x.num_elements // in_dim
        flops = 2.0 * batch * in_dim * params.out_dim
        w_bytes = in_dim * params.out_dim * params.dtype.size_bytes
        c = io_cost(input_specs, output_specs, flops=flops, extra_mem=w_bytes)
        c.bytes_accessed += w_bytes
        return c
