"""Embedding (port of ``flexflow_tpu/ops/embedding.py``).

A per-token lookup (``AggrMode.NONE``: [..., ] -> [..., out_dim]) or a
bag of indices per sample summed or averaged over its last dim (SUM /
AVG: [B, bag] -> [B, out_dim]). Indices may be int32 or int64. The
lookup keeps ``jnp.take``'s semantics: a negative index counts from the
end of the table and an index outside it gives a row of NaN (JAX's
"fill" mode), with no host sync on the card. The bag sums and means
accumulate in float32 and round once to the table's dtype, as
``jnp.sum`` / ``jnp.mean`` do for a 2-byte input.

Tensor parallel (``runtime/tensor_parallel.py``): with the table's rows
sharded on the ``model`` axis a rank looks up the ids of its vocabulary
range, zeros for the rest, and its bag sums sum those: a partial sum the
executor reduces over the model axis; with its columns sharded a rank
looks up its columns of every id.
"""
from __future__ import annotations

import dataclasses
from typing import List

import torch

from ..core.tensor import TensorSpec
from ..core.types import AggrMode, DataType, OpType
from .base import LowerCtx, OpCost, OpDef, WeightSpec, io_cost, register_op


@dataclasses.dataclass(frozen=True)
class EmbeddingParams:
    num_entries: int
    out_dim: int
    aggr: AggrMode = AggrMode.NONE
    dtype: DataType = DataType.FLOAT
    initializer: str = "glorot_uniform"


def lookup(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``jnp.take(table, idx, axis=0)`` with its gradient (a scatter-add
    into the table's rows)."""
    n = table.shape[0]
    i = idx.long()
    i = torch.where(i < 0, i + n, i)
    inside = (i >= 0) & (i < n)
    vecs = torch.nn.functional.embedding(i.clamp(0, n - 1), table)
    return torch.where(inside[..., None], vecs, float("nan"))


def _row_shard_lookup(table: torch.Tensor, idx: torch.Tensor, rank: int,
                      ranks: int) -> torch.Tensor:
    """This rank's part of ``lookup(whole table, idx)`` when the table's
    rows are sharded on the ``model`` axis (``table`` holds rows ``[rank *
    n, (rank + 1) * n)``): the rows of the ids in that range, zeros for
    the others, so the ranks' parts sum to the whole lookup. An id outside
    the whole table gives NaN, from rank 0 (``jnp.take``'s fill)."""
    n = table.shape[0]
    total = n * ranks
    i = idx.long()
    i = torch.where(i < 0, i + total, i)
    local = i - rank * n
    mine = (local >= 0) & (local < n)
    vecs = torch.nn.functional.embedding(local.clamp(0, n - 1), table)
    vecs = torch.where(mine[..., None], vecs, torch.zeros((), dtype=table.dtype,
                                                          device=table.device))
    if rank == 0:
        inside = (i >= 0) & (i < total)
        vecs = torch.where(inside[..., None], vecs, float("nan"))
    return vecs


@register_op
class EmbeddingOp(OpDef):
    op_type = OpType.EMBEDDING
    params_cls = EmbeddingParams

    @staticmethod
    def infer_output_specs(params: EmbeddingParams, input_specs: List[TensorSpec]):
        (idx,) = input_specs
        if params.aggr == AggrMode.NONE:
            return [TensorSpec(idx.shape + (params.out_dim,), params.dtype)]
        return [TensorSpec(idx.shape[:-1] + (params.out_dim,), params.dtype)]

    @staticmethod
    def weight_specs(params: EmbeddingParams, input_specs: List[TensorSpec]) -> List[WeightSpec]:
        return [WeightSpec("embedding", TensorSpec((params.num_entries, params.out_dim),
                                                   params.dtype), params.initializer)]

    @staticmethod
    def lower(params: EmbeddingParams, inputs, weights, ctx: LowerCtx):
        (idx,) = inputs
        table = weights["embedding"]
        if ctx.sharded.get("embedding") == 0:
            vecs = _row_shard_lookup(table, idx, ctx.model_rank, ctx.model_group.size)
        else:
            vecs = lookup(table, idx)
        if params.aggr == AggrMode.SUM:
            vecs = vecs.float().sum(dim=-2).to(table.dtype)
        elif params.aggr == AggrMode.AVG:
            vecs = vecs.float().mean(dim=-2).to(table.dtype)
        return [vecs]

    @staticmethod
    def cost(params: EmbeddingParams, input_specs, output_specs) -> OpCost:
        (idx,) = input_specs
        gathered = idx.num_elements * params.out_dim * params.dtype.size_bytes
        table_bytes = params.num_entries * params.out_dim * params.dtype.size_bytes
        c = io_cost(input_specs, output_specs, flops=float(idx.num_elements * params.out_dim),
                    extra_mem=table_bytes)
        c.bytes_accessed += gathered
        return c
