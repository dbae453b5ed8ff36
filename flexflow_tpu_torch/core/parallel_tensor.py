"""User-inspectable parallel-tensor metadata (port of
``flexflow_tpu/core/parallel_tensor.py``).

Reference: ParallelTensorBase (include/flexflow/parallel_tensor.h:36-71,
134-200): every tensor carries per-dim ``size / degree / parallel_idx /
is_replica_dim`` plus its machine view. Here the same facts are read off
the compiled strategy (partition specs over named mesh axes), so a user
can ask how a tensor is sharded (``FFModel.parallel_tensor`` and
``parallel_weight``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from .tensor import TensorSpec
from .types import DataType


@dataclasses.dataclass(frozen=True)
class ParallelDim:
    """One logical dimension's partitioning (parallel_tensor.h:36-71)."""

    size: int  # global extent
    degree: int  # number of shards along this dim
    mesh_axes: Tuple[str, ...]  # mesh axes sharding it (() = unsharded)

    @property
    def shard_size(self) -> int:
        return self.size // max(1, self.degree)


@dataclasses.dataclass(frozen=True)
class ParallelTensorView:
    """How one tensor is laid out over the mesh.

    ``replica_degree`` is the product of mesh axes that do NOT shard any
    dimension — the reference's replica dims (is_replica_dim): a weight
    under data parallelism has replica_degree == dp.
    """

    shape: Tuple[int, ...]
    dtype: DataType
    dims: Tuple[ParallelDim, ...]
    replica_degree: int
    machine_view_hash: int = 0

    @property
    def num_shards(self) -> int:
        n = 1
        for d in self.dims:
            n *= d.degree
        return n

    @property
    def shard_shape(self) -> Tuple[int, ...]:
        return tuple(d.shard_size for d in self.dims)

    def __repr__(self):
        parts = ", ".join(
            f"{d.size}/{d.degree}" + (f"@{'+'.join(d.mesh_axes)}" if d.mesh_axes else "")
            for d in self.dims
        )
        return (
            f"ParallelTensorView([{parts}], replicas={self.replica_degree}, "
            f"dtype={self.dtype.value})"
        )


def view_from_spec(
    spec: TensorSpec,
    partition_spec,  # SpecTuple (parallel/strategy.py) or None
    axis_sizes: Dict[str, int],
    machine_view_hash: int = 0,
) -> ParallelTensorView:
    """Build a view from a strategy PartitionSpec + mesh axis sizes."""
    active = {k: v for k, v in axis_sizes.items() if v > 1}
    used: set = set()
    dims: List[ParallelDim] = []
    for i, size in enumerate(spec.shape):
        axes: Tuple[str, ...] = ()
        if partition_spec is not None and i < len(partition_spec):
            axes = tuple(a for a in partition_spec[i] if active.get(a, 1) > 1)
        degree = 1
        for a in axes:
            degree *= active[a]
            used.add(a)
        dims.append(ParallelDim(size=size, degree=degree, mesh_axes=axes))
    replica = 1
    for a, v in active.items():
        if a not in used:
            replica *= v
    return ParallelTensorView(
        shape=tuple(spec.shape),
        dtype=spec.dtype,
        dims=tuple(dims),
        replica_degree=replica,
        machine_view_hash=machine_view_hash,
    )
