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


def make_uniform(minv: float, maxv: float):
    def init(gen: torch.Generator, spec: TensorSpec) -> torch.Tensor:
        return torch.empty(spec.shape, dtype=spec.dtype.torch).uniform_(minv, maxv, generator=gen)

    return init


def make_normal(mean: float = 0.0, stddev: float = 1.0):
    def init(gen: torch.Generator, spec: TensorSpec) -> torch.Tensor:
        return torch.empty(spec.shape, dtype=spec.dtype.torch).normal_(mean, stddev,
                                                                        generator=gen)

    return init


def orthogonal(gen: torch.Generator, spec: TensorSpec) -> torch.Tensor:
    """Orthogonal init (recurrent kernels; gain 1.0): the Q of a float32
    Gaussian's QR, its columns' signs fixed by R's diagonal, cut to the
    spec's shape. Not 2-D: Glorot uniform, as the JAX package."""
    shape = spec.shape
    if len(shape) != 2:
        return glorot_uniform(gen, spec)
    rows, cols = shape
    n = max(rows, cols)
    a = torch.empty((n, n), dtype=torch.float32).normal_(generator=gen)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    return q[:rows, :cols].to(spec.dtype.torch).contiguous()


_REGISTRY: Dict[str, Callable[[torch.Generator, TensorSpec], torch.Tensor]] = {
    "glorot_uniform": glorot_uniform,
    "zeros": zeros,
    "ones": ones,
    "normal": make_normal(),
    "uniform": make_uniform(-0.05, 0.05),
    "orthogonal": orthogonal,
}


def get_initializer(name: str) -> Callable[[torch.Generator, TensorSpec], torch.Tensor]:
    if name not in _REGISTRY:
        raise KeyError(f"unknown initializer {name!r}")
    return _REGISTRY[name]

