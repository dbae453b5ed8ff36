"""Operator definition registry (port of ``flexflow_tpu/ops/base.py``).

Each op provides a frozen params record, shape inference
(``infer_output_specs``), weight specs with their initializers, a
PyTorch lowering (``lower``) that the executor calls eagerly (autograd
records the backward), and an analytic cost (``cost``: flops, bytes
moved and resident bytes, the JAX package's numbers for the same specs),
which the per-op profile (``runtime/profiling.py``) reports beside each
op's measured time.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

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
class OpCost:
    """Analytic per-op cost (reference: CostMetrics simulator.h:54-88)."""

    flops: float = 0.0
    bytes_accessed: float = 0.0  # memory traffic: inputs + outputs + weights
    memory_bytes: float = 0.0  # resident memory: weights + activations

    def __add__(self, other: "OpCost") -> "OpCost":
        return OpCost(
            self.flops + other.flops,
            self.bytes_accessed + other.bytes_accessed,
            self.memory_bytes + other.memory_bytes,
        )


@dataclasses.dataclass
class LowerCtx:
    """Context threaded through op lowering."""

    training: bool = True
    # the step's base threefry key (``generation/prng.py``: a pair of
    # int64 tensors holding uint32 words); a stochastic op folds in its
    # node's guid, as the JAX package does
    rng: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    node_guid: int = 0
    # "auto": kernels on CUDA tensors, plain versions on CPU tensors;
    # "plain": plain versions everywhere (to hold the kernels against)
    backend: str = "auto"
    # functional state written by ops (BatchNorm's running statistics),
    # keyed (node guid, weight name); the executor applies it once,
    # after the step
    state_updates: Dict = dataclasses.field(default_factory=dict)
    # auxiliary losses appended by ops, summed into the step's loss
    aux_losses: List = dataclasses.field(default_factory=list)
    # iteration-level sequence truncation (FFIterationConfig.seq_length):
    # batch_matmul keeps the first seq_length entries of its marked dims
    seq_length: Optional[int] = None
    # data parallelism (runtime/data_parallel.py): the rank's group
    # (parallel/distributed.py::RankGroup; None on one device), and
    # whether the current node's tensors hold this rank's rows, a leading
    # block of the global tensor (False: the whole tensor, on every rank)
    group: Optional[object] = None
    split: bool = False
    # a probe's list: every dropout mask drawn is appended to it (None: off)
    masks: Optional[List] = None
    # tensor parallelism (runtime/tensor_parallel.py): this rank's
    # coordinate on the "model" axis and its model sub-group (None: no
    # model axis), and the current node's weights sharded on that axis
    # (weight name -> the dim its shard cuts; empty: every weight whole).
    # ``group``, ``split`` and ``row_offset`` keep to the "data" axis.
    model_rank: int = 0
    model_group: Optional[object] = None
    sharded: Dict[str, int] = dataclasses.field(default_factory=dict)

    def reduce_partial(self, x: torch.Tensor) -> torch.Tensor:
        """A partial sum over the model axis made whole (an all-reduce over
        the model sub-group; backward, the identity)."""
        from ..parallel.distributed import reduce_partial

        return reduce_partial(x, self.model_group)

    def row_offset(self, x: torch.Tensor) -> int:
        """Where ``x``, the current node's tensor on this rank, starts in
        the flat global tensor: ``rank * numel`` for a rank's rows, 0 for
        a whole tensor (and on one device)."""
        if self.group is None or not self.split:
            return 0
        return self.group.rank * x.numel()

    def node_rng(self):
        """``fold_in(rng, node_guid)``: the current node's key (the JAX
        package's ``node_rng``; on one device ``shard_rng`` adds
        nothing to it)."""
        if self.rng is None:
            raise ValueError("op requires an RNG but none was provided")
        from ..generation import prng  # the generation package imports the ops

        return prng.fold_in(self.rng, self.node_guid)


class OpDef:
    """Base operator definition; subclasses register per OpType."""

    op_type: OpType = None  # type: ignore
    params_cls: type = None  # type: ignore  # the frozen params record (graph JSON)

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

    @staticmethod
    def cost(params, input_specs: List[TensorSpec], output_specs: List[TensorSpec]) -> OpCost:
        io_bytes = sum(s.size_bytes for s in input_specs) + sum(s.size_bytes for s in output_specs)
        return OpCost(flops=0.0, bytes_accessed=io_bytes,
                      memory_bytes=sum(s.size_bytes for s in output_specs))


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


def registered_ops() -> Dict[OpType, type]:
    return dict(_REGISTRY)


def io_cost(input_specs: Sequence[TensorSpec], output_specs: Sequence[TensorSpec],
            flops: float = 0.0, extra_mem: float = 0.0) -> OpCost:
    """Every input read once and every output written once; resident:
    the outputs plus ``extra_mem`` (an op's weights)."""
    io = sum(s.size_bytes for s in input_specs) + sum(s.size_bytes for s in output_specs)
    out_mem = sum(s.size_bytes for s in output_specs)
    return OpCost(flops=flops, bytes_accessed=io, memory_bytes=out_mem + extra_mem)
