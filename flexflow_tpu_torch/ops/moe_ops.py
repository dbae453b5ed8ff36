"""Mixture-of-experts operators: TopK, GroupBy, Experts, Aggregate,
AggregateSpec and Cache (port of ``flexflow_tpu/ops/moe_ops.py``).

The JAX package computes MoE in plain XLA (one-hot, cumsum, scatter,
einsum), with no Pallas kernel, so plain PyTorch is its port here. The
semantics are the JAX package's, at static shapes: each expert holds
``expert_capacity`` rows, a (token, slot) takes the next free row of its
expert in flattened (token, slot) order (a masked cumsum), and a slot
past its expert's capacity is dropped.

Every shape is fixed by the specs: no ``nonzero``, no boolean-mask
indexing, no host sync, so a CUDA graph captures these ops (the
executor's window path). The routing moves rows with gathers only,
forward and backward: every kept (token, slot) owns one (expert, row),
so a scatter into the expert buffers is a gather through the inverse
map, and its transpose a gather through the map itself
(:class:`_Route`). A token's k copies are summed back by a reduction
over the k axis. So no backward adds atomically, and a step gives the
same bits every run on the card.

Routing is global over the batch: ``group_by``'s capacity positions are
a cumsum over every token of the batch and the load-balance loss a mean
over them, so a data-parallel rank routing its rows alone would give
other numbers. A graph with routing ops refuses a data-parallel mesh
(:func:`refuse_data_parallel`) until expert parallelism is ported.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List

import torch

from ..core.tensor import TensorSpec
from ..core.types import ActiMode, DataType, OpType
from .base import LowerCtx, OpCost, OpDef, WeightSpec, io_cost, register_op
from .elementwise import apply_activation
from .linear import promoted


@dataclasses.dataclass(frozen=True)
class TopKParams:
    k: int
    sorted: bool = True


@register_op
class TopKOp(OpDef):
    """``jax.lax.top_k``: the k largest along the last axis, in descending
    order, equal values lowest index first (``torch.topk`` promises no
    order among ties; a stable descending sort keeps equal values in
    index order). The values' gradient is the gather's transpose, a
    scatter onto distinct positions of each row."""

    op_type = OpType.TOPK
    params_cls = TopKParams

    @staticmethod
    def infer_output_specs(params: TopKParams, input_specs: List[TensorSpec]):
        (x,) = input_specs
        shape = x.shape[:-1] + (params.k,)
        return [TensorSpec(shape, x.dtype), TensorSpec(shape, DataType.INT32)]

    @staticmethod
    def lower(params: TopKParams, inputs, weights, ctx):
        x = inputs[0]
        idx = torch.sort(x.detach(), dim=-1, descending=True, stable=True).indices[..., :params.k]
        return [x.gather(-1, idx), idx.to(torch.int32)]

    @staticmethod
    def cost(params, input_specs, output_specs) -> OpCost:
        n = input_specs[0].num_elements
        return io_cost(input_specs, output_specs,
                       flops=float(n) * math.log2(max(2, input_specs[0].shape[-1])))


def expert_capacity(batch: int, k: int, n_experts: int, alpha: float) -> int:
    """Per-expert token capacity (reference: group_by.cc capacity calc)."""
    return max(1, int(math.ceil(alpha * k * batch / n_experts)))


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: an index outside [0, n) gives a row of zeros (a
    comparison, so no device-side range check and no sync)."""
    return (idx.unsqueeze(-1) == torch.arange(n, device=idx.device)).to(dtype)


def _dispatch_positions(assign: torch.Tensor, n: int):
    """(flat_assign [B*K], pos_in_expert [B*K]): each (token, slot)'s
    0-based row within its expert's buffer, by masked cumsum."""
    flat_assign = assign.reshape(-1).to(torch.int64)
    onehot = _one_hot(flat_assign, n, torch.int64)  # [B*K, n]
    pos = torch.cumsum(onehot, dim=0) * onehot  # 1-based position per expert
    return flat_assign, pos.sum(dim=-1) - 1


def _route_maps(assign: torch.Tensor, n: int, cap: int):
    """The dispatch as two index maps: ``dst`` [B*K], each (token, slot)'s
    row of the flattened ``[n * cap]`` buffers, ``n * cap`` when dropped;
    ``inv`` [n * cap], the (token, slot) in each row, ``B * K`` when the
    row is empty. Also the flat expert ids."""
    flat_assign, pos = _dispatch_positions(assign, n)
    rows = flat_assign.shape[0]
    dst = torch.where(pos < cap, flat_assign * cap + pos, torch.full_like(pos, n * cap))
    # every kept slot owns its row: only the dump row n * cap is written twice
    inv = torch.full((n * cap + 1,), rows, dtype=torch.int64, device=assign.device)
    inv.index_copy_(0, dst, torch.arange(rows, device=assign.device))
    return dst, inv[: n * cap], flat_assign


def _gather_padded(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """Rows of ``x`` with one zero row appended, by ``index``: the index
    ``len(x)`` reads zeros."""
    return torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))]).index_select(0, index)


class _Route(torch.autograd.Function):
    """``out = [x; 0][fwd_map]`` whose gradient is ``[g; 0][bwd_map]``:
    exact when the two maps are inverse over the rows they share, as
    ``dst`` and ``inv`` are. Both directions are gathers."""

    @staticmethod
    def forward(ctx, x, fwd_map, bwd_map):
        ctx.save_for_backward(bwd_map)
        return _gather_padded(x, fwd_map)

    @staticmethod
    def backward(ctx, g):
        (bwd_map,) = ctx.saved_tensors
        return _gather_padded(g, bwd_map), None, None


def _dispatch_stacked(data: torch.Tensor, assign: torch.Tensor, n: int, cap: int):
    """The tokens in their experts' buffers, ``[n, cap, D]`` (one dense
    gather; dropped slots are left out, empty rows are zero)."""
    b, d = data.shape
    k = assign.shape[-1]
    dst, inv, _ = _route_maps(assign, n, cap)
    # each token k times, (token, slot) order; the gradient sums over k
    rows = data.unsqueeze(1).expand(b, k, d).reshape(b * k, d)
    return _Route.apply(rows, inv, dst).reshape(n, cap, d)


@dataclasses.dataclass(frozen=True)
class GroupByParams:
    n_experts: int
    alpha: float = 1.0  # capacity factor
    stacked: bool = False  # True -> single [n, cap, D] output (feeds ExpertsOp)


@register_op
class GroupByOp(OpDef):
    """Scatter tokens into per-expert buffers.

    Inputs: data [B, D], assignments [B, K] (int expert ids). Outputs:
    n_experts tensors [capacity, D], or, with stacked=True, one
    [n_experts, capacity, D] tensor. Overflowing tokens are dropped (the
    reference's fixed-size buffers, group_by.cc)."""

    op_type = OpType.GROUP_BY
    params_cls = GroupByParams

    @staticmethod
    def infer_output_specs(params: GroupByParams, input_specs: List[TensorSpec]):
        data, assign = input_specs
        b, d = data.shape
        cap = expert_capacity(b, assign.shape[-1], params.n_experts, params.alpha)
        if params.stacked:
            return [TensorSpec((params.n_experts, cap, d), data.dtype)]
        return [TensorSpec((cap, d), data.dtype) for _ in range(params.n_experts)]

    @staticmethod
    def lower(params: GroupByParams, inputs, weights, ctx: LowerCtx):
        data, assign = inputs
        n = params.n_experts
        cap = expert_capacity(data.shape[0], assign.shape[-1], n, params.alpha)
        buf = _dispatch_stacked(data, assign, n, cap)
        if params.stacked:
            return [buf]
        return [buf[e] for e in range(n)]

    @staticmethod
    def cost(params: GroupByParams, input_specs, output_specs) -> OpCost:
        return io_cost(input_specs, output_specs, flops=2.0 * input_specs[0].num_elements)


@dataclasses.dataclass(frozen=True)
class ExpertsParams:
    """Batched two-layer expert FFN (reference: the n per-expert Dense
    pairs of FFModel::moe, src/ops/moe.cc:20), one op whose weights carry
    a leading expert dim."""

    n_experts: int
    hidden_size: int
    out_dim: int
    activation: ActiMode = ActiMode.RELU
    dtype: DataType = DataType.FLOAT


@register_op
class ExpertsOp(OpDef):
    """[n, cap, D] -> [n, cap, out_dim] batched expert MLP: two batched
    products (cuBLAS on the card), bias and activation. One device holds
    every expert; the expert-parallel form (experts sharded over a mesh
    axis) belongs to the multi-GPU slices, and a context with a mesh
    raises."""

    op_type = OpType.EXPERTS
    params_cls = ExpertsParams

    @staticmethod
    def infer_output_specs(params: ExpertsParams, input_specs: List[TensorSpec]):
        x = input_specs[0]
        return [TensorSpec((x.shape[0], x.shape[1], params.out_dim), params.dtype)]

    @staticmethod
    def weight_specs(params: ExpertsParams, input_specs: List[TensorSpec]):
        d = input_specs[0].shape[-1]
        n, h, o = params.n_experts, params.hidden_size, params.out_dim
        dt = params.dtype
        return [
            WeightSpec("w1", TensorSpec((n, d, h), dt), "glorot_uniform"),
            WeightSpec("b1", TensorSpec((n, h), dt), "zeros"),
            WeightSpec("w2", TensorSpec((n, h, o), dt), "glorot_uniform"),
            WeightSpec("b2", TensorSpec((n, o), dt), "zeros"),
        ]

    @staticmethod
    def _apply(x, w1, b1, w2, b2, activation):
        h = torch.bmm(*promoted(x, w1)) + b1[:, None, :]
        h = apply_activation(activation, h)
        return torch.bmm(*promoted(h, w2)) + b2[:, None, :]

    @staticmethod
    def lower(params: ExpertsParams, inputs, weights, ctx: LowerCtx):
        if getattr(ctx, "mesh", None) is not None:
            raise NotImplementedError("expert-parallel experts over a mesh are not ported")
        y = ExpertsOp._apply(inputs[0], weights["w1"], weights["b1"], weights["w2"],
                             weights["b2"], params.activation)
        return [y.to(params.dtype.torch)]

    @staticmethod
    def cost(params: ExpertsParams, input_specs, output_specs) -> OpCost:
        n, cap, d = input_specs[0].shape
        flops = (2.0 * n * cap * d * params.hidden_size
                 + 2.0 * n * cap * params.hidden_size * params.out_dim)
        w_bytes = ((n * d * params.hidden_size + n * params.hidden_size * params.out_dim)
                   * params.dtype.size_bytes)
        c = io_cost(input_specs, output_specs, flops=flops, extra_mem=w_bytes)
        c.bytes_accessed += w_bytes
        return c


def _stacked(experts) -> torch.Tensor:
    """A single stacked [n, cap, D] tensor, or n [cap, D] tensors stacked."""
    if len(experts) == 1 and experts[0].dim() == 3:
        return experts[0]
    return torch.stack(list(experts))


@dataclasses.dataclass(frozen=True)
class AggregateParams:
    n_experts: int
    lambda_bal: float = 0.0  # load-balance aux loss weight (aggregate.cc)
    alpha: float = 1.0


@register_op
class AggregateOp(OpDef):
    """Gather expert outputs back to token order, weighted by gate scores.

    Inputs: gate_preds [B, K], gate_assign [B, K], then n_experts tensors
    [capacity, D] (or one stacked [n, capacity, D]). Output: [B, D]. With
    ``lambda_bal`` > 0 the load-balance loss goes into
    ``LowerCtx.aux_losses``, in float32."""

    op_type = OpType.AGGREGATE
    params_cls = AggregateParams

    @staticmethod
    def infer_output_specs(params: AggregateParams, input_specs: List[TensorSpec]):
        gate = input_specs[0]
        d = input_specs[2].shape[-1]
        return [TensorSpec((gate.shape[0], d), input_specs[2].dtype)]

    @staticmethod
    def _gather_rows(gate_assign, experts, n: int):
        """Expert rows in (token, slot) order, [B*K, D], zero where the slot
        was dropped, and the flat expert ids."""
        stacked = _stacked(experts)
        cap, d = stacked.shape[1], stacked.shape[2]
        dst, inv, flat_assign = _route_maps(gate_assign, n, cap)
        return _Route.apply(stacked.reshape(n * cap, d), dst, inv), flat_assign

    @staticmethod
    def lower(params: AggregateParams, inputs, weights, ctx: LowerCtx):
        gate_preds, gate_assign = inputs[0], inputs[1]
        b, k = gate_preds.shape
        n = params.n_experts
        rows, flat_assign = AggregateOp._gather_rows(gate_assign, inputs[2:], n)
        d = rows.shape[-1]
        w = gate_preds.reshape(-1, 1).to(rows.dtype)
        out = (rows * w).reshape(b, k, d).sum(dim=1)
        if params.lambda_bal > 0.0:
            # load-balance aux loss (reference: aggregate.cc lambda_bal):
            # squared per-expert token fractions (Shazeer-style)
            onehot = _one_hot(flat_assign, n, torch.float32)
            frac = onehot.mean(dim=0)
            imp = (onehot * gate_preds.reshape(-1, 1).to(torch.float32)).mean(dim=0)
            ctx.aux_losses.append(params.lambda_bal * n * torch.sum(frac * imp))
        return [out]

    @staticmethod
    def cost(params, input_specs, output_specs) -> OpCost:
        return io_cost(input_specs, output_specs, flops=3.0 * output_specs[0].num_elements)


class _AggregateSpec(torch.autograd.Function):
    """Forward: every chosen expert's row, [B*K, D]. Backward: the
    experts' gradient is the gather's transpose (a gather through the
    inverse map); the gate's is the reference's hand-written rule
    (aggregate_spec.cu:64-127), term by term as the JAX package's
    ``custom_vjp``: each selected entry's squared output error times B,
    normalised by the sum over the token's slots (floored at 1e-20), minus
    (1 - gate) on each selected entry, plus ``lambda_bal`` times the
    expert's count, centred to zero mean over the experts. An expert
    chosen twice by one token adds both slots, in slot order, as JAX's
    scatter-add does."""

    @staticmethod
    def forward(ctx, gate_preds, stacked, gate_assign, dst, inv, n: int, lambda_bal: float):
        ctx.save_for_backward(gate_preds, gate_assign, inv)
        ctx.n, ctx.lambda_bal = n, lambda_bal
        ctx.stacked_shape = tuple(stacked.shape)
        return _gather_padded(stacked.reshape(-1, stacked.shape[-1]), dst)

    @staticmethod
    def backward(ctx, g):
        gate_preds, gate_assign, inv = ctx.saved_tensors
        n = ctx.n
        b, k = gate_preds.shape
        experts_grad = _gather_padded(g, inv).reshape(ctx.stacked_shape)
        assign = gate_assign.to(torch.int64)
        sel = _one_hot(assign, n, torch.bool)  # [B, K, n]
        err = (g.to(torch.float32).square().sum(dim=-1) * b).reshape(b, k)
        full = torch.zeros((b, n), dtype=torch.float32, device=g.device)
        for j in range(k):  # full.at[bi, flat_assign].add(err), slot by slot
            full = torch.where(sel[:, j], full + err[:, j:j + 1], full)
        full = full / torch.clamp(err.sum(dim=-1), min=1e-20)[:, None]
        minus = -(1.0 - gate_preds.to(torch.float32))
        for j in range(k):
            full = torch.where(sel[:, j], full + minus[:, j:j + 1], full)
        if ctx.lambda_bal > 0.0:
            counts = sel.to(torch.float32).sum(dim=(0, 1))
            full = full + ctx.lambda_bal * counts[None, :]
        full = full - full.mean(dim=-1, keepdim=True)
        gate_grad = full.gather(1, assign).to(gate_preds.dtype)
        return gate_grad, experts_grad, None, None, None, None, None


@dataclasses.dataclass(frozen=True)
class AggregateSpecParams:
    n_experts: int
    lambda_bal: float = 0.0
    alpha: float = 1.0


@register_op
class AggregateSpecOp(OpDef):
    """Speculative-assignment variant (reference: aggregate_spec.cc/.cu):
    outputs every chosen expert's prediction separately, [B*K, D], so the
    loss evaluates each speculative routing; the gate's gradient is the
    hand-written rule of :class:`_AggregateSpec`."""

    op_type = OpType.AGGREGATE_SPEC
    params_cls = AggregateSpecParams

    @staticmethod
    def infer_output_specs(params: AggregateSpecParams, input_specs: List[TensorSpec]):
        gate = input_specs[0]
        d = input_specs[2].shape[-1]
        return [TensorSpec((gate.shape[0] * gate.shape[1], d), input_specs[2].dtype)]

    @staticmethod
    def lower(params: AggregateSpecParams, inputs, weights, ctx: LowerCtx):
        gate_preds, gate_assign = inputs[0], inputs[1]
        stacked = _stacked(inputs[2:])
        dst, inv, _ = _route_maps(gate_assign, params.n_experts, stacked.shape[1])
        return [_AggregateSpec.apply(gate_preds, stacked, gate_assign, dst, inv,
                                     params.n_experts, float(params.lambda_bal))]

    @staticmethod
    def cost(params, input_specs, output_specs) -> OpCost:
        return io_cost(input_specs, output_specs, flops=3.0 * output_specs[0].num_elements)


@dataclasses.dataclass(frozen=True)
class CacheParams:
    num_batches: int = 1
    trigger_threshold: float = 0.0


@register_op
class CacheOp(OpDef):
    """Input-caching op (reference: cache.cc). Forward is identity; the
    scoring and trigger live on the host (``runtime/recompile.py``)."""

    op_type = OpType.CACHE
    params_cls = CacheParams

    @staticmethod
    def infer_output_specs(params, input_specs: List[TensorSpec]):
        return [input_specs[0]]

    @staticmethod
    def lower(params, inputs, weights, ctx):
        return [inputs[0]]

    @staticmethod
    def cost(params, input_specs, output_specs) -> OpCost:
        return OpCost()


# the ops whose arithmetic spans the whole batch's tokens (the capacity
# cumsum, the load-balance mean over every routed token)
ROUTING_OPS = (OpType.GROUP_BY, OpType.AGGREGATE, OpType.AGGREGATE_SPEC, OpType.EXPERTS)


def refuse_data_parallel(graph, ranks: int) -> None:
    """Raise ``NotImplementedError`` for a graph with routing ops on more
    than one data-parallel rank: the capacity positions and the
    load-balance loss are global over the batch's tokens, which the
    expert-parallel part of ROADMAP queue 1, item 5 will carry."""
    if ranks <= 1:
        return
    found = sorted({n.op_type.value for n in graph.nodes.values() if n.op_type in ROUTING_OPS})
    if found:
        raise NotImplementedError(
            f"a mixture of experts ({', '.join(found)}) on {ranks} data-parallel ranks is not "
            "ported: its routing is global over the batch's tokens (ROADMAP queue 1, item 5: "
            "expert parallelism); train it on one device")
