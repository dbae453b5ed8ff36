"""Operator definition registry (port of ``flexflow_tpu/ops/base.py``).

Each op provides a frozen params record, shape inference
(``infer_output_specs``), weight specs with their initializers, and a
PyTorch lowering (``lower``) that the executor calls eagerly; autograd
records the backward. The analytic cost model waits for the search
slice.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from ..core.tensor import TensorSpec
from ..core.types import OpType


@dataclasses.dataclass(frozen=True)
class WeightSpec:
    """A learnable parameter of an op + its initializer."""

    name: str
    spec: TensorSpec
    initializer: str = "glorot_uniform"  # name into runtime/initializers.py
    trainable: bool = True


@dataclasses.dataclass
class LowerCtx:
    """Context threaded through op lowering."""

    training: bool = True
    # randomness for stochastic ops (none on the ported path yet)
    generator: Optional[torch.Generator] = None
    # "auto": kernels on CUDA tensors, plain versions on CPU tensors;
    # "plain": plain versions everywhere (to hold the kernels against)
    backend: str = "auto"


class OpDef:
    """Base operator definition; subclasses register per OpType."""

    op_type: OpType = None  # type: ignore

    @staticmethod
    def infer_output_specs(params, input_specs: List[TensorSpec]) -> List[TensorSpec]:
        raise NotImplementedError

    @staticmethod
    def weight_specs(params, input_specs: List[TensorSpec]) -> List[WeightSpec]:
        return []

    @staticmethod
    def lower(
        params, inputs: List[torch.Tensor], weights: Dict[str, torch.Tensor], ctx: LowerCtx
    ) -> List[torch.Tensor]:
        raise NotImplementedError


_REGISTRY: Dict[OpType, type] = {}


def register_op(cls: type) -> type:
    if cls.op_type is None:
        raise ValueError(f"{cls} missing op_type")
    _REGISTRY[cls.op_type] = cls
    return cls


def get_op_def(op_type: OpType) -> type:
    if op_type not in _REGISTRY:
        raise KeyError(f"no OpDef registered for {op_type}")
    return _REGISTRY[op_type]
