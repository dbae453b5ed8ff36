"""Weight initializers (port of ``flexflow_tpu/runtime/initializers.py``).

Each draws from an explicit ``torch.Generator``. The values are not the
JAX package's (``jax.random`` and ``torch.Generator`` give different
numbers from one seed): tests that compare the two packages carry the
weights across instead (``runtime/convert.py``).
"""
from __future__ import annotations

import math
from typing import Callable, Dict

import torch

from ..core.tensor import TensorSpec


def glorot_uniform(gen: torch.Generator, spec: TensorSpec) -> torch.Tensor:
    shape = spec.shape
    if len(shape) >= 2:
        fan_in = math.prod(shape[:-1])
        fan_out = shape[-1]
    else:
        fan_in = fan_out = max(1, shape[0] if shape else 1)
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    out = torch.empty(shape, dtype=spec.dtype.torch)
    return out.uniform_(-limit, limit, generator=gen)


def zeros(gen: torch.Generator, spec: TensorSpec) -> torch.Tensor:
    return torch.zeros(spec.shape, dtype=spec.dtype.torch)


def ones(gen: torch.Generator, spec: TensorSpec) -> torch.Tensor:
    return torch.ones(spec.shape, dtype=spec.dtype.torch)


_REGISTRY: Dict[str, Callable[[torch.Generator, TensorSpec], torch.Tensor]] = {
    "glorot_uniform": glorot_uniform,
    "zeros": zeros,
    "ones": ones,
}


def get_initializer(name: str) -> Callable[[torch.Generator, TensorSpec], torch.Tensor]:
    if name not in _REGISTRY:
        raise KeyError(f"unknown initializer {name!r}")
    return _REGISTRY[name]
