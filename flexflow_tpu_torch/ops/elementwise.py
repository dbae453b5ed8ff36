"""Activations and the elementwise families (port of
``flexflow_tpu/ops/elementwise.py``).

The binary family (add, subtract, multiply, divide, max, min) broadcasts
as ``jnp``'s does. The unary family (relu, sigmoid, tanh, elu, gelu,
identity, exp, sin, cos, rsqrt, pow and the scalar ops) takes JAX's
rounding for 2-byte inputs: a Python scalar meets a bfloat16 or float16
tensor as a weak-typed JAX scalar does, rounded to the tensor's type
first, and the 2-byte GELU, sigmoid and rsqrt run the ops XLA runs for
them, each rounded to the type (bit for bit with JAX's forward on the
CPU, except float16 ELU).

ELU stays exact in every type: ``torch.nn.functional.elu`` is correctly
rounded, which is what the JAX package means by ``alpha * expm1(x)``.
XLA's CPU backend computes the float16 ``expm1`` less exactly (up to
1.91 ulps from float64 over [-12, 12], where the port is within half an
ulp), so 1923 of the 17445 fp16 values there differ from JAX's by up to
2 ulps. That rounding is an artefact of one backend, not the function:
the port does not reproduce it (``tests/test_torch_port_vision.py``
holds fp16 ELU within 2 ulps of JAX's and half an ulp of float64's).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List

import torch

from ..core.tensor import TensorSpec
from ..core.types import ActiMode, OpType
from .base import OpDef, io_cost, register_op


_SQRT_HALF_F16 = float(torch.tensor(0.5 ** 0.5, dtype=torch.float16))
_TWO_BYTE = (torch.bfloat16, torch.float16)


def apply_activation(mode: ActiMode, x: torch.Tensor) -> torch.Tensor:
    if mode == ActiMode.NONE:
        return x
    if mode == ActiMode.RELU:
        return torch.relu(x)
    if mode == ActiMode.SIGMOID:
        return torch.sigmoid(x)
    if mode == ActiMode.TANH:
        return torch.tanh(x)
    if mode == ActiMode.GELU:
        # exact erf form, as the JAX package (approximate=False)
        if x.dtype == torch.float16:
            # jax.nn.gelu's own ops, each rounded to fp16 as JAX rounds
            # them (0.5 x erfc(-x sqrt(1/2)), sqrt(1/2) an fp16 constant):
            # one fused fp32 GELU rounded once differs from it by up to
            # several fp16 ulps on a third of its outputs
            return 0.5 * x * torch.special.erfc(-x * _SQRT_HALF_F16)
        return torch.nn.functional.gelu(x, approximate="none")
    raise ValueError(f"unknown activation {mode}")


@functools.lru_cache(maxsize=None)
def _rounded(x: float, dtype: torch.dtype) -> float:
    return float(torch.tensor(x, dtype=dtype))


def _weak(s: float, x: torch.Tensor) -> float:
    """``s`` as a weak-typed JAX scalar meeting ``x``: rounded to a
    2-byte type (float32 rounds a Python scalar alike)."""
    return _rounded(float(s), x.dtype) if x.dtype in _TWO_BYTE else float(s)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x, approximate=False)``: its ops, each rounded to a
    2-byte type as JAX rounds them."""
    if x.dtype in _TWO_BYTE:
        return 0.5 * x * torch.special.erfc(-x * _rounded(0.5 ** 0.5, x.dtype))
    return torch.nn.functional.gelu(x, approximate="none")


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid``: a 2-byte input takes ``1 / (1 + exp(-x))`` with
    each op rounded to the type, as XLA computes it."""
    if x.dtype in _TWO_BYTE:
        return 1 / (1 + torch.exp(-x))
    return torch.sigmoid(x)


def _rsqrt(x: torch.Tensor) -> torch.Tensor:
    """``lax.rsqrt``: correctly rounded for bfloat16 (one float32
    ``1 / sqrt`` rounded once), ``1 / sqrt(x)`` in the type for float16,
    as XLA computes them."""
    if x.dtype == torch.bfloat16:
        return (1 / torch.sqrt(x.float())).to(x.dtype)
    if x.dtype == torch.float16:
        return 1 / torch.sqrt(x)
    return torch.rsqrt(x)


def _divide_by_scalar(x: torch.Tensor, s: float) -> torch.Tensor:
    """``x / s`` as a true division (PyTorch turns a division by a host
    scalar into a product with its reciprocal, which rounds otherwise)."""
    return x / torch.full((), _weak(s, x), dtype=x.dtype, device=x.device)


_BINARY_FNS = {
    OpType.EW_ADD: torch.add,
    OpType.EW_SUB: torch.sub,
    OpType.EW_MUL: torch.mul,
    OpType.EW_DIV: torch.div,
    OpType.EW_MAX: torch.maximum,
    OpType.EW_MIN: torch.minimum,
}

_UNARY_FNS = {
    OpType.RELU: torch.relu,
    OpType.SIGMOID: _sigmoid,
    OpType.TANH: torch.tanh,
    OpType.ELU: torch.nn.functional.elu,
    OpType.GELU: _gelu,
    OpType.IDENTITY: lambda x: x,
    OpType.EXP: torch.exp,
    OpType.SIN: torch.sin,
    OpType.COS: torch.cos,
    OpType.RSQRT: _rsqrt,
}

_SCALAR_FNS = {
    OpType.POW: lambda x, s: torch.pow(x, _weak(s, x)),
    OpType.SCALAR_ADD: lambda x, s: x + _weak(s, x),
    OpType.SCALAR_SUB: lambda x, s: x - _weak(s, x),
    OpType.SCALAR_MUL: lambda x, s: x * _weak(s, x),
    OpType.SCALAR_TRUE_DIV: _divide_by_scalar,
}


@dataclasses.dataclass(frozen=True)
class ElementBinaryParams:
    op: OpType  # one of _BINARY_FNS
    inplace_a: bool = False  # API parity; the result is a new tensor


@dataclasses.dataclass(frozen=True)
class ElementUnaryParams:
    op: OpType
    scalar: float = 0.0  # used by scalar_* and pow
    inplace: bool = False  # API parity; the result is a new tensor


def _register(op_type: OpType, params_cls, infer, fn) -> type:
    cls = type(f"Element_{op_type.value}", (OpDef,), {
        "op_type": op_type,
        "params_cls": params_cls,
        "infer_output_specs": staticmethod(infer),
        "lower": staticmethod(lambda params, inputs, weights, ctx: [fn(params, *inputs)]),
        # one operation an output element, as the JAX package counts
        "cost": staticmethod(lambda params, input_specs, output_specs: io_cost(
            input_specs, output_specs, flops=output_specs[0].num_elements)),
    })
    return register_op(cls)


def _binary_spec(params, input_specs: List[TensorSpec]):
    a, b = input_specs
    return [TensorSpec(torch.broadcast_shapes(a.shape, b.shape), a.dtype)]


def _unary_spec(params, input_specs: List[TensorSpec]):
    return [input_specs[0]]


for _t, _f in _BINARY_FNS.items():
    _register(_t, ElementBinaryParams, _binary_spec, lambda p, a, b, _f=_f: _f(a, b))
for _t, _f in _UNARY_FNS.items():
    _register(_t, ElementUnaryParams, _unary_spec, lambda p, x, _f=_f: _f(x))
for _t, _f in _SCALAR_FNS.items():
    _register(_t, ElementUnaryParams, _unary_spec, lambda p, x, _f=_f: _f(x, p.scalar))
