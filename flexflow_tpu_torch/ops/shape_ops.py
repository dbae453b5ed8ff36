"""Shape operators: Reshape, Transpose, Reverse, Flat, Concat, Split
(several outputs) and Cast (port of ``flexflow_tpu/ops/shape_ops.py``).

Each is the PyTorch view or copy of its ``jnp`` counterpart; autograd
records the gradient (a Cast's gradient is cast back to the input's
dtype, as JAX's transpose of ``convert_element_type``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import torch

from ..core.tensor import TensorSpec
from ..core.types import DataType, OpType
from .base import OpDef, register_op


def _elements(spec: TensorSpec) -> int:
    return math.prod(spec.shape)


@dataclasses.dataclass(frozen=True)
class ReshapeParams:
    shape: Tuple[int, ...]


@register_op
class ReshapeOp(OpDef):
    op_type = OpType.RESHAPE
    params_cls = ReshapeParams

    @staticmethod
    def infer_output_specs(params: ReshapeParams, input_specs: List[TensorSpec]):
        (x,) = input_specs
        shape = list(params.shape)
        if -1 in shape:
            i = shape.index(-1)
            rest = math.prod(s for s in shape if s != -1)
            shape[i] = _elements(x) // rest
        if math.prod(shape) != _elements(x):
            raise ValueError(f"cannot reshape {x.shape} to {params.shape}")
        return [TensorSpec(tuple(shape), x.dtype)]

    @staticmethod
    def lower(params, inputs, weights, ctx):
        x = inputs[0]
        spec = TensorSpec(tuple(x.shape), DataType.from_torch(x.dtype))
        return [x.reshape(ReshapeOp.infer_output_specs(params, [spec])[0].shape)]


@dataclasses.dataclass(frozen=True)
class TransposeParams:
    perm: Tuple[int, ...]


@register_op
class TransposeOp(OpDef):
    op_type = OpType.TRANSPOSE
    params_cls = TransposeParams

    @staticmethod
    def infer_output_specs(params: TransposeParams, input_specs: List[TensorSpec]):
        (x,) = input_specs
        return [TensorSpec(tuple(x.shape[p] for p in params.perm), x.dtype)]

    @staticmethod
    def lower(params, inputs, weights, ctx):
        return [inputs[0].permute(params.perm)]


@dataclasses.dataclass(frozen=True)
class ReverseParams:
    axis: int


@register_op
class ReverseOp(OpDef):
    op_type = OpType.REVERSE
    params_cls = ReverseParams

    @staticmethod
    def infer_output_specs(params, input_specs: List[TensorSpec]):
        return [input_specs[0]]

    @staticmethod
    def lower(params, inputs, weights, ctx):
        return [torch.flip(inputs[0], (params.axis,))]


@dataclasses.dataclass(frozen=True)
class FlatParams:
    pass


@register_op
class FlatOp(OpDef):
    """Flatten all non-batch dims (reference: src/ops/flat.cc)."""

    op_type = OpType.FLAT
    params_cls = FlatParams

    @staticmethod
    def infer_output_specs(params, input_specs: List[TensorSpec]):
        (x,) = input_specs
        return [TensorSpec((x.shape[0], math.prod(x.shape[1:])), x.dtype)]

    @staticmethod
    def lower(params, inputs, weights, ctx):
        x = inputs[0]
        return [x.reshape(x.shape[0], -1)]


@dataclasses.dataclass(frozen=True)
class ConcatParams:
    axis: int
    n_inputs: int


@register_op
class ConcatOp(OpDef):
    op_type = OpType.CONCAT
    params_cls = ConcatParams

    @staticmethod
    def infer_output_specs(params: ConcatParams, input_specs: List[TensorSpec]):
        ax = params.axis
        base = list(input_specs[0].shape)
        base[ax] = sum(s.shape[ax] for s in input_specs)
        return [TensorSpec(tuple(base), input_specs[0].dtype)]

    @staticmethod
    def lower(params, inputs, weights, ctx):
        return [torch.cat(list(inputs), dim=params.axis)]


@dataclasses.dataclass(frozen=True)
class SplitParams:
    sizes: Tuple[int, ...]
    axis: int


@register_op
class SplitOp(OpDef):
    op_type = OpType.SPLIT
    params_cls = SplitParams

    @staticmethod
    def infer_output_specs(params: SplitParams, input_specs: List[TensorSpec]):
        (x,) = input_specs
        out = []
        for sz in params.sizes:
            shape = list(x.shape)
            shape[params.axis] = sz
            out.append(TensorSpec(tuple(shape), x.dtype))
        return out

    @staticmethod
    def lower(params, inputs, weights, ctx):
        return list(torch.split(inputs[0], list(params.sizes), dim=params.axis))


@dataclasses.dataclass(frozen=True)
class CastParams:
    dtype: DataType


@register_op
class CastOp(OpDef):
    op_type = OpType.CAST
    params_cls = CastParams

    @staticmethod
    def infer_output_specs(params: CastParams, input_specs: List[TensorSpec]):
        (x,) = input_specs
        return [TensorSpec(x.shape, params.dtype)]

    @staticmethod
    def lower(params, inputs, weights, ctx):
        return [inputs[0].to(params.dtype.torch)]
