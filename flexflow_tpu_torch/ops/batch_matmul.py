"""BatchMatmul operator (port of ``flexflow_tpu/ops/batch_matmul.py``).

C[b] = A[b] @ B[b] over the leading batch dims. The JAX lowering is
plain XLA, ``jnp.matmul(a, b, preferred_element_type=float32)`` cast to
A's dtype, so a plain ``torch.matmul`` is a faithful port: the operands
are promoted to their common type, the product accumulates in float32
(cuBLAS's and the CPU's 2-byte GEMMs do) and is rounded once to A's
dtype.

The reference's per-input sequence truncation (model.h:483-487) is kept:
with ``LowerCtx.seq_length`` set (the executor's ``seq_length``), a
non-negative ``a_seq_length_dim`` / ``b_seq_length_dim`` keeps the first
``seq_length`` entries of that dim of A / B.
"""
from __future__ import annotations

import dataclasses
from typing import List

import torch

from ..core.tensor import TensorSpec
from ..core.types import OpType
from .base import LowerCtx, OpCost, OpDef, io_cost, register_op
from .linear import promoted


@dataclasses.dataclass(frozen=True)
class BatchMatmulParams:
    a_seq_length_dim: int = -1
    b_seq_length_dim: int = -1


@register_op
class BatchMatmulOp(OpDef):
    op_type = OpType.BATCH_MATMUL
    params_cls = BatchMatmulParams

    @staticmethod
    def infer_output_specs(params, input_specs: List[TensorSpec]):
        a, b = input_specs
        if a.shape[:-2] != b.shape[:-2]:
            raise ValueError(f"batch dims mismatch: {a.shape} vs {b.shape}")
        if a.shape[-1] != b.shape[-2]:
            raise ValueError(f"contraction mismatch: {a.shape} @ {b.shape}")
        return [TensorSpec(a.shape[:-1] + (b.shape[-1],), a.dtype)]

    @staticmethod
    def lower(params: BatchMatmulParams, inputs, weights, ctx: LowerCtx):
        a, b = inputs
        seq = ctx.seq_length
        if seq is not None:
            if params.a_seq_length_dim >= 0:
                a = a.narrow(params.a_seq_length_dim, 0, seq)
            if params.b_seq_length_dim >= 0:
                b = b.narrow(params.b_seq_length_dim, 0, seq)
        return [torch.matmul(*promoted(a, b)).to(a.dtype)]

    @staticmethod
    def cost(params, input_specs, output_specs) -> OpCost:
        a, b = input_specs
        k = a.shape[-1]
        flops = 2.0 * output_specs[0].num_elements * k
        return io_cost(input_specs, output_specs, flops=flops)
