"""Graph source op: Input (port of ``InputOp`` in
``flexflow_tpu/ops/io_ops.py``)."""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

from ..core.tensor import TensorSpec
from ..core.types import DataType, OpType
from .base import OpDef, register_op


@dataclasses.dataclass(frozen=True)
class InputParams:
    shape: Tuple[int, ...]
    dtype: DataType = DataType.FLOAT
    input_index: int = 0  # position in the user's batch tuple


@register_op
class InputOp(OpDef):
    op_type = OpType.INPUT

    @staticmethod
    def infer_output_specs(params: InputParams, input_specs: List[TensorSpec]) -> List[TensorSpec]:
        return [TensorSpec(params.shape, params.dtype)]

    @staticmethod
    def lower(params, inputs, weights, ctx):
        raise RuntimeError("Input nodes are bound by the executor, not lowered")
