"""Graph source and pass-through ops: Input, Weight, NoOp (port of
``flexflow_tpu/ops/io_ops.py``).

A Weight node roots a learnable tensor in the graph (``create_weight``):
its one output is its ``"weight"`` parameter. A NoOp passes its inputs
through (reference: noop.cc)."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch

from ..core.tensor import TensorSpec
from ..core.types import DataType, OpType
from .base import LowerCtx, OpCost, OpDef, WeightSpec, register_op


@dataclasses.dataclass(frozen=True)
class InputParams:
    shape: Tuple[int, ...]
    dtype: DataType = DataType.FLOAT
    input_index: int = 0  # position in the user's batch tuple


@register_op
class InputOp(OpDef):
    op_type = OpType.INPUT
    params_cls = InputParams

    @staticmethod
    def infer_output_specs(params: InputParams, input_specs: List[TensorSpec]) -> List[TensorSpec]:
        return [TensorSpec(params.shape, params.dtype)]

    @staticmethod
    def lower(params, inputs, weights, ctx):
        raise RuntimeError("Input nodes are bound by the executor, not lowered")

    @staticmethod
    def cost(params, input_specs, output_specs) -> OpCost:
        return OpCost()


@dataclasses.dataclass(frozen=True)
class WeightParams:
    shape: Tuple[int, ...]
    dtype: DataType = DataType.FLOAT
    initializer: str = "glorot_uniform"


@register_op
class WeightOp(OpDef):
    op_type = OpType.WEIGHT
    params_cls = WeightParams

    @staticmethod
    def infer_output_specs(params: WeightParams, input_specs: List[TensorSpec]) -> List[TensorSpec]:
        return [TensorSpec(params.shape, params.dtype)]

    @staticmethod
    def weight_specs(params: WeightParams, input_specs: List[TensorSpec]) -> List[WeightSpec]:
        return [WeightSpec("weight", TensorSpec(params.shape, params.dtype), params.initializer)]

    @staticmethod
    def lower(params, inputs, weights: Dict[str, torch.Tensor], ctx: LowerCtx):
        return [weights["weight"]]

    @staticmethod
    def cost(params, input_specs, output_specs) -> OpCost:
        return OpCost()


@dataclasses.dataclass(frozen=True)
class NoOpParams:
    pass


@register_op
class NoOp(OpDef):
    op_type = OpType.NOOP
    params_cls = NoOpParams

    @staticmethod
    def infer_output_specs(params, input_specs: List[TensorSpec]) -> List[TensorSpec]:
        return list(input_specs)

    @staticmethod
    def lower(params, inputs, weights, ctx):
        return list(inputs)

    @staticmethod
    def cost(params, input_specs, output_specs) -> OpCost:
        return OpCost()
