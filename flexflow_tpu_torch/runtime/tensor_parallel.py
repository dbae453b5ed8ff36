"""Tensor-parallel training over a group of ranks: the ``"model"`` axis of
a strategy (``megatron_strategy``, a strategy file, a searched strategy
with parameter parallelism), alone or with ``"data"`` (the JAX package's
GSPMD over a ``{"data": dp, "model": tp}`` mesh, ``flexflow_tpu/parallel/
strategy.py``, ``search/unity.py`` and ``runtime/executor.py``).

``FFModel(config, mesh=build_mesh({"data": dp, "model": tp}, devices))``
(or any mesh of ``dp * tp`` ranks) compiles a :class:`TensorParallelExecutor`
on every rank. Rank r sits at ``(r // tp, r % tp)`` (the JAX package's
row-major reshape of its device list): its data coordinate picks its rows
of the batch, as in ``runtime/data_parallel.py`` (which this executor
extends), and its model coordinate its shards. ``Mesh.group`` gives each
rank its data sub-group (the ranks with its model coordinate) and its
model sub-group (the ranks with its rows).

* **Weights.** A weight whose spec (``strategy.weight_spec``) names the
  ``model`` axis on dim d is held as the rank's block of d; every other
  weight whole. Every rank draws the whole weights from the model's seed
  and keeps its blocks, so the shards are those of the one-device model.
* **Layouts.** Along the model axis a value is replicated (``R``: every
  model rank holds all of it), sharded on dim d (an int: the rank's block
  of d) or partial (``P``: the ranks' tensors sum to it). Every node's
  output is moved to the layout its output spec names (``model`` on dim d:
  sharded on d; any other spec: replicated; no spec: as the node made
  it), as GSPMD must under the JAX executor's ``with_sharding_constraint``;
  and every input to the layout its node takes (:func:`layout_plan`).
  One function, :meth:`TensorParallelExecutor._move`, makes every move.
* **Sharded lowerings.** A column-parallel linear (kernel dim 1) takes
  its input replicated and makes its columns (sharded on the last dim); a
  row-parallel linear (kernel dim 0) takes its block of the input's last
  dim and makes a partial, summed before its bias and activation
  (``ops/linear.py``); head-parallel attention takes q, k and v replicated,
  runs the flash kernels on its heads and sums the output projection's
  partials before ``bo`` and the dropout (``ops/attention.py``); an
  embedding with its rows sharded makes a partial, with its columns
  sharded its columns (``ops/embedding.py``). An elementwise op whose
  output spec shards dim d computes on the blocks of d of its inputs (all
  of the output's shape), LayerNorm on a block of a dim it does not
  normalize (``megatron_strategy(sp=True)``). The parallel ops move the
  data their params name (``Repartition`` a slice, ``Combine`` an
  all-gather, ``Replicate`` and ``Reduction``/``AllReduce`` the whole,
  ``FusedParallelOp`` its ``out_spec``). Every other op takes its inputs
  replicated and computes in full on every model rank.
* **Partials.** A partial is consumed only by the reduction a move
  inserts, or by a ``Reduction``/``AllReduce`` node, which makes it
  whole; a row-parallel linear whose output spec is None (a searched
  graph's, before its ``Reduction``) keeps it partial, and nothing reduces
  it twice.
* **2-byte models.** Partials and gathers move in the activation's dtype.

The layout rules, forward and backward (``parallel/distributed.py``'s
collectives with a backward):

=============================================  =====================  ==========================
move                                           forward                backward
=============================================  =====================  ==========================
replicated -> sharded on an axis               the rank's block       all-gather over the axis
sharded -> replicated                          all-gather             the rank's block
partial -> replicated                          all-reduce over model  identity
partial -> sharded                             reduce-scatter         all-gather
replicated, fed to an op with a model-sharded  identity               all-reduce over model
weight (its input gradient is a partial)
a replicated weight used on data sharded on    identity               all-reduce over that axis
an axis (LayerNorm under ``sp``)
=============================================  =====================  ==========================

The last rule runs once a step: the gradients of such weights sum over
the model sub-group in one flat all-reduce per dtype (a rank's is the
part its block of the data gives), before the data sub-group's
all-reduce of every gradient. Each rank computes the loss on the whole
output (every model rank the same), so every replicated value's gradient
is whole on every rank and the ranks that hold one shard stay
bit-identical.

ZeRO-1 shards each moment as the JAX executor does: the parameter's own
sharding, plus its first dim that the model axis leaves unsharded and
that the data axis divides (``data_parallel.zero_dims``). A checkpoint,
``get_weight`` and ``set_weight(s)`` see whole tensors: gathered from
the shards to rank 0, or broadcast from rank 0 with each rank keeping
its block (:meth:`DataParallelExecutor.load_whole`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from ..core.graph import Node, PCGraph
from ..core.types import OpType
from ..ops.base import LowerCtx, get_op_def
from ..ops.linear import row_parallel_reduces
from ..parallel import distributed
from ..parallel.distributed import mesh_coords
from ..parallel.mesh import DATA_AXIS, MODEL_AXIS
from ..parallel.propagation import infer_all_specs
from .data_parallel import DataParallelExecutor, _part, _tree_digest
from .executor import node_key
from .optimizers import Params, _leaves

# layouts along the model axis: replicated, partial, or an int d (sharded
# on dim d); and what an input may ask for besides a layout: replicated
# and fed to an op with a model-sharded weight, or the value as it is
R = "R"
P = "P"
F = "F"
ANY = "*"
Layout = Union[str, int]

# ops that compute elementwise on inputs of their output's shape: they
# run on blocks of a sharded dim as on the whole
ELEMENTWISE = frozenset({
    OpType.EW_ADD, OpType.EW_SUB, OpType.EW_MUL, OpType.EW_DIV, OpType.EW_MAX, OpType.EW_MIN,
    OpType.RELU, OpType.SIGMOID, OpType.TANH, OpType.ELU, OpType.GELU, OpType.IDENTITY,
    OpType.EXP, OpType.SIN, OpType.COS, OpType.RSQRT, OpType.POW, OpType.SCALAR_ADD,
    OpType.SCALAR_SUB, OpType.SCALAR_MUL, OpType.SCALAR_TRUE_DIV, OpType.CAST,
})
PARALLEL_OPS = frozenset({OpType.REPARTITION, OpType.COMBINE, OpType.REPLICATE,
                          OpType.REDUCTION, OpType.ALLREDUCE, OpType.FUSED_PARALLEL})


def spec_layout(spec) -> Optional[Layout]:
    """The model-axis layout a partition spec names: the dim it shards on
    ``model``, else replicated; None for no spec (unconstrained)."""
    if spec is None:
        return None
    for d, axes in enumerate(spec):
        if MODEL_AXIS in tuple(axes or ()):
            if len(axes) > 1:
                raise NotImplementedError(
                    f"a dim sharded on {tuple(axes)} together: only 'model' alone is ported")
            return d
    return R


@dataclasses.dataclass
class NodeLayout:
    """How one node runs on a rank: the layout it takes each input in
    (``inputs``, with ``F`` and ``ANY``), the layout of each output it
    makes (``produced``), each output's layout once moved to its spec
    (``outputs``), its weights sharded on the model axis (name -> dim),
    and whether its replicated weights meet model-sharded data (their
    gradients then sum over the model axis)."""

    inputs: List[Layout]
    produced: List[Layout]
    outputs: List[Layout]
    sharded: Dict[str, int]
    model_sum: bool = False


@dataclasses.dataclass
class LayoutPlan:
    nodes: Dict[int, NodeLayout]
    values: Dict[Tuple[int, int], Layout]  # (guid, idx) -> the value's layout
    weight_dims: Dict[str, Dict[str, Optional[int]]]  # node key -> weight -> model dim


def _model_dim(spec, shape, tp: int, what: str) -> Optional[int]:
    """The dim a weight spec shards on the model axis (checked to divide)."""
    if spec is None:
        return None
    for d, axes in enumerate(spec):
        axes = tuple(axes or ())
        if MODEL_AXIS in axes:
            if len(axes) > 1 or shape[d] % tp:
                raise NotImplementedError(f"{what}: dim {d} of {tuple(shape)} sharded on "
                                          f"{axes} over {tp} ranks is not ported")
            return d
        if axes:
            raise NotImplementedError(f"{what}: a weight sharded on {axes} is not ported "
                                      "(only the 'model' axis shards weights)")
    return None


def _parallel_target(node: Node, have: Layout, ndim: int) -> Layout:
    """The model-axis layout a parallel op's params name, from the layout
    its input has (dim 0 is the data axis's: the rank plan's rows)."""
    p = node.params
    out = spec_layout(p.out_spec) if getattr(p, "out_spec", None) is not None else None
    if out is not None:
        return out
    t = node.op_type
    if t == OpType.REPARTITION:
        d = p.dim % ndim
        if d == 0 and p.mesh_axis != MODEL_AXIS:
            return have
        return d
    if t == OpType.COMBINE:
        d = p.dim % ndim
        if d == 0 and have != 0:
            return have
        return R
    if t == OpType.FUSED_PARALLEL:
        return have
    return R  # Replicate, Reduction, AllReduce: the whole value


def _sharded_lowering(node: Node, sharded: Dict[str, int], in_specs, out_specs):
    """(input layouts, produced layouts) of an op with model-sharded
    weights, or NotImplementedError for a layout with no sharded lowering."""
    t, p = node.op_type, node.params
    if t == OpType.LINEAR:
        want_bias = {"bias": 0} if p.use_bias else {}
        if sharded == {"kernel": 1, **want_bias}:
            return [F], [out_specs[0].ndim - 1]
        if sharded == {"kernel": 0}:
            return [in_specs[0].ndim - 1], [R if row_parallel_reduces(p) else P]
    elif t == OpType.MULTIHEAD_ATTENTION:
        want = {"wq": 1, "wk": 1, "wv": 1, "wo": 0}
        if p.use_bias:
            want.update(bq=0, bk=0, bv=0)
        if sharded == want:
            return [F, F, F], [R]
    elif t == OpType.EMBEDDING:
        if sharded == {"embedding": 0}:
            return [R], [P]
        if sharded == {"embedding": 1}:
            return [R], [out_specs[0].ndim - 1]
    raise NotImplementedError(f"{node}: weights {sharded} sharded on the 'model' axis have no "
                              "sharded lowering in the port")


def layout_plan(graph: PCGraph, strategy, tp: int) -> LayoutPlan:
    """Every node's layouts on a model axis of ``tp`` ranks under
    ``strategy`` (module docstring), and every weight's model dim. Raises
    ``NotImplementedError`` for a layout the port does not run."""
    specs = infer_all_specs(graph)
    nodes: Dict[int, NodeLayout] = {}
    values: Dict[Tuple[int, int], Layout] = {}
    wdims: Dict[str, Dict[str, Optional[int]]] = {}
    for node in graph.topo_order():
        edges = graph.in_edges(node)
        in_specs = [specs[e.src][e.src_idx] for e in edges]
        out_specs = specs[node.guid]
        have = [values[(e.src, e.src_idx)] for e in edges]
        key = node_key(node)
        wspecs = get_op_def(node.op_type).weight_specs(node.params, in_specs)
        dims = {w.name: _model_dim(strategy.weight_spec(node.guid, w.name), w.spec.shape, tp,
                                   f"{node}.{w.name}") for w in wspecs}
        if wspecs:
            wdims[key] = dims
        sharded = {n: d for n, d in dims.items() if d is not None}
        targets = [spec_layout(strategy.output_spec(node.guid, i)) for i in range(len(out_specs))]
        model_sum = False
        if node.op_type in PARALLEL_OPS:
            # the value as it comes, moved to the layout the op's params
            # name, or its output spec (GSPMD's constraint after the op)
            ins, produced = [ANY], [have[0]]
            if targets[0] is None:
                targets = [_parallel_target(node, have[0], out_specs[0].ndim)]
        elif sharded:
            ins, produced = _sharded_lowering(node, sharded, in_specs, out_specs)
        elif (node.op_type in ELEMENTWISE and isinstance(targets[0], int)
              and all(tuple(s.shape) == tuple(out_specs[0].shape) for s in in_specs)):
            ins, produced = [targets[0]] * len(edges), [targets[0]]
        elif (node.op_type == OpType.LAYERNORM and isinstance(targets[0], int)
              and targets[0] not in {a % out_specs[0].ndim for a in node.params.axes}):
            ins, produced = [targets[0]], [targets[0]]
            model_sum = bool(wspecs)
        else:
            ins, produced = [R] * len(edges), [R] * len(out_specs)
        outs = [p if t is None else t for p, t in zip(produced, targets)]
        nodes[node.guid] = NodeLayout(ins, produced, outs, sharded, model_sum)
        for i, o in enumerate(outs):
            values[(node.guid, i)] = o
    return LayoutPlan(nodes, values, wdims)


def _block(t: torch.Tensor, d: Optional[int], rank: int, ranks: int) -> torch.Tensor:
    return t if d is None else _part(t, True, rank, ranks, d)


@dataclasses.dataclass(eq=False)
class TensorParallelExecutor(DataParallelExecutor):
    """One rank's executor of a ``{"data": dp, "model": tp}`` mesh
    (``group`` is the whole mesh's group, split into its axes). On rank 0
    its public methods drive every rank, as the data-parallel executor's
    do; the ``_rank_*`` methods are one rank's part."""

    mesh_shape: Optional[Dict[str, int]] = None

    def __post_init__(self):
        super().__post_init__()
        shape = dict(self.mesh_shape)
        self.tp = shape.get(MODEL_AXIS, 1)
        self.coords = mesh_coords(shape, self.group.rank)
        self.model_rank = self.coords.get(MODEL_AXIS, 0)
        self.layout = layout_plan(self.graph, self.strategy, self.tp)
        self._model_sum = [(node_key(self.graph.nodes[g]), n)
                           for g, lay in self.layout.nodes.items() if lay.model_sum
                           for n, d in self.layout.weight_dims.get(
                               node_key(self.graph.nodes[g]), {}).items() if d is None]

    # ----------------------------------------------------------- setup
    @property
    def mgroup(self):
        """The ranks that share this rank's rows (the model axis)."""
        return self.group.axis(MODEL_AXIS)

    def _data_coord(self, r: int) -> int:
        return mesh_coords(self.mesh_shape, r).get(DATA_AXIS, 0)

    def _row_ranks(self) -> List[int]:
        return [r for r in range(self.ranks)
                if mesh_coords(self.mesh_shape, r).get(MODEL_AXIS, 0) == 0]

    def _model_dims(self):
        return self.layout.weight_dims

    def _local_weight(self, key: str, name: str, whole: torch.Tensor) -> torch.Tensor:
        d = self.layout.weight_dims.get(key, {}).get(name)
        return whole if d is None else _block(whole, d, self.model_rank, self.tp).clone()

    def worker_spec(self) -> Dict[str, Any]:
        return dict(super().worker_spec(), strategy=self.strategy,
                    mesh_shape=dict(self.mesh_shape))

    # ------------------------------------------------------- the step
    def _lower_ctx(self, training: bool, rng) -> LowerCtx:
        ctx = super()._lower_ctx(training, rng)
        ctx.group = self.dgroup
        ctx.model_rank, ctx.model_group = self.model_rank, self.mgroup
        return ctx

    def _node_inputs(self, node: Node, values, ctx: LowerCtx) -> List[torch.Tensor]:
        lay = self.layout.nodes[node.guid]
        ctx.sharded = lay.sharded
        out = []
        for e, want in zip(self.graph.in_edges(node), lay.inputs):
            src = (e.src, e.src_idx)
            have = self.layout.values[src]
            if want == ANY or want == have:
                out.append(values[src])
                continue
            # one move of a value to a layout a step, shared by its readers
            key = (e.src, e.src_idx, want)
            if key not in values:
                values[key] = self._move(values[src], have, want)
            out.append(values[key])
        return out

    def _store_outputs(self, node: Node, outs, values) -> None:
        lay = self.layout.nodes[node.guid]
        for i, o in enumerate(outs):
            values[(node.guid, i)] = self._move(o, lay.produced[i], lay.outputs[i])

    def _forward_impl(self, params: Params, state: Params, inputs, training: bool, rng=None):
        outs, new_state, aux = super()._forward_impl(params, state, inputs, training, rng)
        # the loss, the metrics and predict read whole outputs
        outs = [self._move(o, self.layout.values[v], R) for o, v in zip(outs, self.outputs)]
        return outs, new_state, aux

    def _move(self, x: torch.Tensor, have: Layout, want: Layout) -> torch.Tensor:
        """``x`` moved from the layout it has to the one it needs, by the
        layout rules (module docstring)."""
        g = self.mgroup
        if want == ANY or have == want:
            return x
        if want == F:
            return distributed.copy_to_group(self._move(x, have, R), g)
        if have == P:
            if want == R:
                return distributed.reduce_partial(x, g)
            return distributed.reduce_scatter_dim(x, g, want)
        if want == P:
            raise ValueError("no op takes a partial sum: a move never makes one")
        if have == R:
            return distributed.slice_dim(x, g, want)
        whole = distributed.gather_dim(x, g, have)
        return whole if want == R else distributed.slice_dim(whole, g, want)

    def _sync_grads(self, grads: Params) -> None:
        if self._model_sum:
            # replicated weights used on model-sharded data: each rank's
            # gradient is its block's part
            distributed.all_reduce_flat([grads[k][n] for k, n in self._model_sum
                                         if n in grads.get(k, {})], self.mgroup)
        super()._sync_grads(grads)

    # -------------------------------------------------- whole tensors
    def whole_specs(self):
        def whole(tree, dims):
            out = {}
            for k, g in tree.items():
                out[k] = {}
                for n, t in g.items():
                    shape = list(t.shape)
                    d = dims.get(k, {}).get(n)
                    if d is not None:
                        shape[d] *= self.tp
                    out[k][n] = (tuple(shape), t.dtype)
            return out

        return {"params": whole(self.params, self.layout.weight_dims),
                "state": whole(self.state or {}, self.layout.weight_dims)}

    def whole_params(self) -> Params:
        return self._same("_rank_whole_tree", "params")[0]

    def whole_state(self) -> Params:
        return self._same("_rank_whole_tree", "state")[0]

    def whole_weight(self, key: str, name: str) -> torch.Tensor:
        return self._same("_rank_whole_leaf", key, name)[0]

    def full_opt_state(self) -> Optional[dict]:
        if self.opt_state is None:
            return None
        return self._same("_rank_whole_moments")[0]

    @torch.no_grad()
    def _gather_model(self, tree: Params) -> Params:
        """``tree`` (params-shaped, this rank's blocks) with every model-
        sharded leaf all-gathered whole over the model axis (new tensors)."""
        out = {k: {n: t.detach() for n, t in g.items()} for k, g in tree.items()}
        pairs = []
        for k, n, t in _leaves(tree):
            d = self.layout.weight_dims.get(k, {}).get(n)
            if d is None:
                continue
            shape = list(t.shape)
            shape[d] *= self.tp
            out[k][n] = torch.empty(shape, dtype=t.dtype, device=t.device)
            pairs.append((out[k][n], d, t.detach()))
        self._all_gather_slices(pairs, self.mgroup)
        return out

    def _rank_whole_tree(self, part: str) -> Optional[Params]:
        tree = self._gather_model(self.params if part == "params" else (self.state or {}))
        return tree if self.rank == 0 else None

    def _rank_whole_leaf(self, key: str, name: str) -> Optional[torch.Tensor]:
        group = "params" if name in self.params.get(key, {}) else "state"
        leaf = getattr(self, group)[key][name]
        whole = self._gather_model({key: {name: leaf}})[key][name]
        return whole if self.rank == 0 else None

    def _rank_whole_moments(self) -> Optional[dict]:
        if self._zero_dims is not None:
            out = self._local_moments()
        else:
            out = dict(self.opt_state)
        for field in ("m", "v"):
            if out.get(field) is not None:
                out[field] = self._gather_model(out[field])
        return out if self.rank == 0 else None

    # ------------------------------------------------------- per rank
    def _rank_info(self) -> Dict[str, Any]:
        info = super()._rank_info()
        rep = {k: {n: t for n, t in g.items()
                   if self.layout.weight_dims.get(k, {}).get(n) is None}
               for k, g in self.params.items()}
        # ranks of one model coordinate hold the same shards: compare their
        # params_sha; every rank holds the same replicated weights
        info.update(model_rank=self.model_rank, data_rank=self.data_rank,
                    replicated_sha=_tree_digest(rep))
        return info
