"""Tensor element types (port of ``flexflow_tpu/core/types.py``).

Only the members the generation slice uses: float32 parameters and KV
cache (the JAX default), int32 tokens, positions and block tables.
"""
from __future__ import annotations

import enum

import torch


class DataType(enum.Enum):
    """Tensor element types (reference: ffconst.h DataType)."""

    INT32 = "int32"
    FLOAT = "float32"

    @property
    def torch(self) -> torch.dtype:
        return getattr(torch, self.value)

    @property
    def size_bytes(self) -> int:
        return torch.empty((), dtype=self.torch).element_size()
