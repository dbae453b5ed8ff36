"""Activations and the elementwise add (port of the members of
``flexflow_tpu/ops/elementwise.py`` the training path uses)."""
from __future__ import annotations

import dataclasses
from typing import List

import torch

from ..core.tensor import TensorSpec
from ..core.types import ActiMode, OpType
from .base import OpDef, register_op


_SQRT_HALF_F16 = float(torch.tensor(0.5 ** 0.5, dtype=torch.float16))


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


@dataclasses.dataclass(frozen=True)
class ElementBinaryParams:
    op: OpType  # EW_ADD
    inplace_a: bool = False  # API parity; the sum is a new tensor


@register_op
class AddOp(OpDef):
    op_type = OpType.EW_ADD
    params_cls = ElementBinaryParams

    @staticmethod
    def infer_output_specs(params, input_specs: List[TensorSpec]):
        a, b = input_specs
        return [TensorSpec(torch.broadcast_shapes(a.shape, b.shape), a.dtype)]

    @staticmethod
    def lower(params, inputs, weights, ctx):
        a, b = inputs
        return [a + b]
