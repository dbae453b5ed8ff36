"""Logical tensor specifications (port of ``TensorSpec`` in
``flexflow_tpu/core/tensor.py``; the parallel-tensor half waits for the
multi-GPU slices)."""
from __future__ import annotations

import dataclasses
from typing import Tuple

from .types import DataType

MAX_TENSOR_DIM = 6  # parity with reference MAX_TENSOR_DIM


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """Logical (unsharded) tensor: shape + dtype (reference: tensor.h TensorBase)."""

    shape: Tuple[int, ...]
    dtype: DataType = DataType.FLOAT

    def __post_init__(self):
        object.__setattr__(self, "shape", tuple(int(s) for s in self.shape))
        if len(self.shape) > MAX_TENSOR_DIM:
            raise ValueError(f"too many dims: {self.shape}")

    @property
    def ndim(self) -> int:
        return len(self.shape)

