"""Parallel operators: sharding transitions in the graph (port of
``flexflow_tpu/ops/parallel_ops.py``).

Reference: src/parallel_ops/{partition,combine,replicate,reduction,
fused_parallel_op}.cc, which copy and reduce data between differently
partitioned regions:
  Repartition -> scatter of a dim          (partition.cc)
  Combine     -> all-gather                (combine.cc:74)
  Replicate   -> broadcast                 (replicate.cc)
  Reduction   -> reduce-scatter / sum      (reduction.cc)
  AllReduce   -> allreduce
  FusedParallelOp -> one combined reshard  (fused_parallel_op.cc)
Logical shapes are unchanged. Each op's params, output specs and (zero)
cost are the JAX package's, so the strategy search writes the same
graphs in both packages. Each lowers as the identity on values (the JAX
package's ``_constrain`` without a mesh), so a searched graph runs on
one device. On a ``"model"`` axis of N > 1 ranks each moves the data
its params name, as GSPMD does under the JAX package's sharding
constraint: the tensor-parallel executor moves its input to the layout
the op names (``runtime/tensor_parallel.py``: ``Repartition`` the
rank's block, ``Combine`` an all-gather, ``Replicate`` the whole,
``Reduction`` and ``AllReduce`` the sum of a partial, ``FusedParallelOp``
its ``out_spec``), through the one move function every node's layouts
go through.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from ..core.tensor import TensorSpec
from ..core.types import OpType
from .base import LowerCtx, OpCost, OpDef, register_op


class _ParallelOpBase(OpDef):
    @staticmethod
    def infer_output_specs(params, input_specs: List[TensorSpec]):
        return [input_specs[0]]

    @staticmethod
    def lower(params, inputs, weights, ctx: LowerCtx):
        return [inputs[0]]  # the JAX package's lowering without a mesh

    @staticmethod
    def cost(params, input_specs, output_specs) -> OpCost:
        # communication cost is modeled by the simulator per machine view,
        # not per-op flops (reference: estimate_xfer_cost simulator.cc:671)
        return OpCost()


@dataclasses.dataclass(frozen=True)
class RepartitionParams:
    dim: int  # tensor dim to shard
    degree: int
    mesh_axis: Optional[str] = None
    # full output partition spec (per logical dim, tuple of axis names or None)
    out_spec: Optional[Tuple] = None


@register_op
class RepartitionOp(_ParallelOpBase):
    op_type = OpType.REPARTITION
    params_cls = RepartitionParams


@dataclasses.dataclass(frozen=True)
class CombineParams:
    dim: int  # dim being un-sharded (all-gathered)
    degree: int
    out_spec: Optional[Tuple] = None


@register_op
class CombineOp(_ParallelOpBase):
    op_type = OpType.COMBINE
    params_cls = CombineParams


@dataclasses.dataclass(frozen=True)
class ReplicateParams:
    degree: int
    out_spec: Optional[Tuple] = None


@register_op
class ReplicateOp(_ParallelOpBase):
    op_type = OpType.REPLICATE
    params_cls = ReplicateParams


@dataclasses.dataclass(frozen=True)
class ReductionParams:
    degree: int  # replica-dim partial results being summed
    out_spec: Optional[Tuple] = None


@register_op
class ReductionOp(_ParallelOpBase):
    op_type = OpType.REDUCTION
    params_cls = ReductionParams


@dataclasses.dataclass(frozen=True)
class AllReduceParams:
    degree: int
    out_spec: Optional[Tuple] = None


@register_op
class AllReduceOp(_ParallelOpBase):
    op_type = OpType.ALLREDUCE
    params_cls = AllReduceParams


@dataclasses.dataclass(frozen=True)
class FusedParallelParams:
    # sequence of (kind, dim, degree) transitions fused into one reshard
    transitions: Tuple = ()
    out_spec: Optional[Tuple] = None


@register_op
class FusedParallelOp(_ParallelOpBase):
    op_type = OpType.FUSED_PARALLEL
    params_cls = FusedParallelParams
