"""Parallelization strategy: per-op sharding assignments (port of
``flexflow_tpu/parallel/strategy.py``).

Reference: the output of Unity's search is a map op -> MachineView
(graph.cc optimal_views). A strategy is a map node guid -> OpSharding
(the partition specs of the op's outputs and weights over named mesh
axes, as tuples of axis names) plus the mesh axis sizes. The JSON is the
JAX package's: a strategy file written by either package reads in the
other, and ``remap_to`` rebinds a file's guids onto a rebuilt graph by
layer name. The JAX package's ``to_partition_spec`` (specs as
``jax.sharding.PartitionSpec``) has no counterpart: the port executes on
one device and keeps specs as tuples.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Tuple

from ..core.graph import PCGraph
from ..core.types import OpType
from .mesh import DATA_AXIS, EXPERT_AXIS, MODEL_AXIS, PIPE_AXIS, SEQ_AXIS

# A partition spec as pure data: one entry per tensor dim; each entry is a
# tuple of mesh axis names (usually 0- or 1-long).
SpecTuple = Tuple[Tuple[str, ...], ...]


def pspec(*axes) -> SpecTuple:
    """Helper: pspec('data', None, 'model') -> ((('data',), (), ('model',)))."""
    out = []
    for a in axes:
        if a is None:
            out.append(())
        elif isinstance(a, str):
            out.append((a,))
        else:
            out.append(tuple(a))
    return tuple(out)


def megatron_weight_dims(node) -> Dict[str, int]:
    """The Megatron tp layout for one node: weight name -> sharded dim.
    Name heuristics follow models/transformer.py naming; unmatched nodes
    return {} (replicated). Single source of truth for megatron_strategy,
    pipeline_strategy's in-stage tp, and the search's (pp, tp) proposer."""
    name = node.name or ""
    if node.op_type == OpType.LINEAR:
        if "ff1" in name or "lm_head" in name or name.endswith("_gate"):
            return {"kernel": 1, "bias": 0}  # column parallel
        if "ff2" in name or "out_proj" in name:
            return {"kernel": 0}  # row parallel
        return {}
    if node.op_type == OpType.MULTIHEAD_ATTENTION:
        return {"wq": 1, "wk": 1, "wv": 1, "bq": 0, "bk": 0, "bv": 0, "wo": 0}
    if node.op_type == OpType.EMBEDDING:
        return {"embedding": 0}
    return {}


# ops through which a tp-sharded activation may safely flow inside a
# manual (shard_map) stage program: purely elementwise — anything that
# normalizes/reduces over the sharded feature dim would silently compute
# per-shard results
_TP_TRANSPARENT_OPS = frozenset(
    {
        OpType.RELU, OpType.SIGMOID, OpType.TANH, OpType.ELU, OpType.GELU,
        OpType.IDENTITY, OpType.EXP, OpType.SIN, OpType.COS, OpType.RSQRT,
        OpType.POW, OpType.SCALAR_ADD, OpType.SCALAR_SUB, OpType.SCALAR_MUL,
        OpType.SCALAR_TRUE_DIV, OpType.DROPOUT,
    }
)


def tp_shardable_nodes(graph: PCGraph, block_nodes) -> set:
    """Guids of block nodes whose weights may carry Megatron tp sharding
    under a MANUAL (shard_map) stage program, where GSPMD is not there
    to reshard mid-stage.

    MHA is always self-consistent (head-sharded internally, psum after
    wo). Linears shard only as complete column->row pairs whose sharded
    intermediate flows exclusively through elementwise ops and drains
    into a row-parallel linear within the block — a column output that
    escapes the block or hits a normalizing op would silently compute
    per-shard results. Embeddings never shard in-stage (their row layout
    needs a psum the manual lowering doesn't do)."""
    guids = {n.guid for n in block_nodes}
    by_guid = {n.guid: n for n in block_nodes}
    ok = {n.guid for n in block_nodes if n.op_type == OpType.MULTIHEAD_ATTENTION}
    cols = [
        n for n in block_nodes
        if n.op_type == OpType.LINEAR and megatron_weight_dims(n).get("kernel") == 1
    ]
    rows = {
        n.guid for n in block_nodes
        if n.op_type == OpType.LINEAR and megatron_weight_dims(n).get("kernel") == 0
    }
    if not cols or not rows:
        return ok  # half a pattern cannot re-materialize activations
    for col in cols:
        # per-column: rows reached by an inconsistent column must not be
        # sharded on the strength of a *different* consistent column
        reached_rows = set()
        frontier = [col.guid]
        seen = set()
        consistent = True
        while frontier and consistent:
            g = frontier.pop()
            for e in graph.out_edges(by_guid[g]):
                if e.dst in seen:
                    continue
                seen.add(e.dst)
                if e.dst not in guids:
                    consistent = False  # sharded value escapes the block
                    break
                dst = by_guid[e.dst]
                if dst.guid in rows:
                    reached_rows.add(dst.guid)
                    continue
                if dst.op_type in _TP_TRANSPARENT_OPS:
                    frontier.append(dst.guid)
                else:
                    consistent = False
                    break
        if consistent:
            ok.add(col.guid)
            ok |= reached_rows
    return ok


def shard_weight_entry(weights, by_name, wname: str, dim: int, axis_name: str, axis_size: int):
    """Shard weight ``wname``'s dim ``dim`` on ``axis_name`` if it exists
    and divides evenly; otherwise leave it replicated (graceful degradation
    for odd vocab sizes / head counts). Shared by all strategy builders."""
    w = by_name.get(wname)
    if w is None or axis_size < 2 or w.spec.shape[dim] % axis_size != 0:
        return
    weights[wname] = pspec(*[axis_name if i == dim else None for i in range(w.spec.ndim)])


@dataclasses.dataclass
class OpSharding:
    """Shardings for one PCG node."""

    outputs: List[Optional[SpecTuple]] = dataclasses.field(default_factory=list)
    weights: Dict[str, Optional[SpecTuple]] = dataclasses.field(default_factory=dict)
    machine_view_hash: int = 0  # provenance from the search, for export
    # structural view (start_device_id, dims, strides) — the reference
    # serializes full per-op placement, not just a hash
    # (src/runtime/graph.cc:2162+); round-trips through to_json/from_json
    machine_view: Optional[Tuple[int, Tuple[int, ...], Tuple[int, ...]]] = None


@dataclasses.dataclass
class PipelineAssignment:
    """Stage partition of the PCG for GPipe execution (NEW capability —
    the reference's OP_PIPELINE is an unimplemented placeholder,
    ffconst.h:160; its closest analog is inter-op device placement from
    the DP search's graph splits, graph.cc:206-231)."""

    n_stages: int
    n_microbatches: int
    stage_of: Dict[int, int] = dataclasses.field(default_factory=dict)  # guid -> stage


@dataclasses.dataclass
class ParallelStrategy:
    """Full strategy: mesh shape + per-node shardings.

    Serializable for parity with the reference's --export-strategy /
    --import-strategy (config.h:141-142).
    """

    axis_sizes: Dict[str, int] = dataclasses.field(default_factory=dict)
    node_shardings: Dict[int, OpSharding] = dataclasses.field(default_factory=dict)
    pipeline: Optional[PipelineAssignment] = None
    # guid -> layer name at build time: strategies exported to JSON are
    # name-keyed like the reference's strategy files (triton
    # strategy.cc / DLRM strategies/*.pb map placements by op name), so
    # an import into a REBUILT graph (new guids) can remap
    node_names: Dict[int, str] = dataclasses.field(default_factory=dict)

    def record_names(self, graph) -> "ParallelStrategy":
        self.node_names = {
            n.guid: n.name for n in graph.nodes.values() if n.name
        }
        return self

    def remap_to(self, graph) -> Optional["ParallelStrategy"]:
        """Rebind this strategy's guids onto ``graph`` by layer NAME.
        Returns a remapped copy, self when the guids already match, or
        None when remapping is impossible (missing/ambiguous names).

        "Already matches" requires FULL containment: guids come from a
        per-process counter, so a cross-process import can partially
        collide with unrelated nodes — binding on a partial overlap
        would attach shardings to the wrong ops, the exact silent
        misapply this method exists to prevent."""
        covered = set(self.node_shardings)
        if self.pipeline is not None:
            covered |= set(self.pipeline.stage_of)
        if not self.node_shardings:
            return self
        if covered <= set(graph.nodes):
            # containment alone is not identity: guids restart at 1000
            # per process, so a cross-process import can cover a PREFIX
            # of a larger graph's guids while meaning different ops —
            # accept the identity binding only when the recorded names
            # agree for every covered guid (no names recorded = legacy
            # strategy, keep the old behavior)
            if not self.node_names or all(
                graph.nodes[g].name == self.node_names.get(g, graph.nodes[g].name)
                for g in covered
            ):
                return self
        by_name: Dict[str, int] = {}
        for n in graph.nodes.values():
            if n.name:
                if n.name in by_name:
                    return None  # ambiguous
                by_name[n.name] = n.guid
        out = ParallelStrategy(
            axis_sizes=dict(self.axis_sizes), node_names={}
        )
        for g, sh in self.node_shardings.items():
            name = self.node_names.get(g)
            if not name or name not in by_name:
                return None
            ng = by_name[name]
            out.node_shardings[ng] = sh
            out.node_names[ng] = name
        if self.pipeline is not None:
            stage_of = {}
            for g, s in self.pipeline.stage_of.items():
                name = self.node_names.get(g)
                if not name or name not in by_name:
                    return None
                stage_of[by_name[name]] = s
            out.pipeline = PipelineAssignment(
                self.pipeline.n_stages, self.pipeline.n_microbatches, stage_of
            )
        return out

    def output_spec(self, guid: int, idx: int = 0) -> Optional[SpecTuple]:
        s = self.node_shardings.get(guid)
        if s is None or idx >= len(s.outputs):
            return None
        return s.outputs[idx]

    def weight_spec(self, guid: int, name: str) -> Optional[SpecTuple]:
        s = self.node_shardings.get(guid)
        if s is None:
            return None
        return s.weights.get(name)

    # ------------------------------------------------------------- serde
    def to_json(self) -> str:
        return json.dumps(
            {
                "axis_sizes": self.axis_sizes,
                "pipeline": (
                    {
                        "n_stages": self.pipeline.n_stages,
                        "n_microbatches": self.pipeline.n_microbatches,
                        "stage_of": {str(g): s for g, s in self.pipeline.stage_of.items()},
                    }
                    if self.pipeline
                    else None
                ),
                "node_names": {str(g): n for g, n in self.node_names.items()},
                "nodes": {
                    str(g): {
                        "outputs": [list(map(list, o)) if o is not None else None for o in s.outputs],
                        "weights": {k: (list(map(list, v)) if v is not None else None) for k, v in s.weights.items()},
                        "machine_view_hash": s.machine_view_hash,
                        "machine_view": (
                            [s.machine_view[0], list(s.machine_view[1]), list(s.machine_view[2])]
                            if s.machine_view is not None
                            else None
                        ),
                    }
                    for g, s in self.node_shardings.items()
                },
            },
            indent=1,
        )

    @classmethod
    def from_json(cls, text: str) -> "ParallelStrategy":
        d = json.loads(text)
        st = cls(
            axis_sizes=dict(d["axis_sizes"]),
            node_names={int(g): n for g, n in d.get("node_names", {}).items()},
        )
        if d.get("pipeline"):
            p = d["pipeline"]
            st.pipeline = PipelineAssignment(
                n_stages=p["n_stages"],
                n_microbatches=p["n_microbatches"],
                stage_of={int(g): s for g, s in p["stage_of"].items()},
            )
        for g, s in d["nodes"].items():
            st.node_shardings[int(g)] = OpSharding(
                outputs=[tuple(tuple(e) for e in o) if o is not None else None for o in s["outputs"]],
                weights={
                    k: (tuple(tuple(e) for e in v) if v is not None else None)
                    for k, v in s["weights"].items()
                },
                machine_view_hash=s.get("machine_view_hash", 0),
                machine_view=(
                    (s["machine_view"][0], tuple(s["machine_view"][1]), tuple(s["machine_view"][2]))
                    if s.get("machine_view") is not None
                    else None
                ),
            )
        return st


def megatron_strategy(
    graph: PCGraph,
    dp: int,
    tp: int,
    sp: bool = False,
    batch_dim: int = 0,
) -> ParallelStrategy:
    """Hybrid data + tensor (+ sequence) parallel strategy for
    transformer-shaped graphs — the TPU-native form of the reference's
    --enable-parameter-parallel xfers (replicate-linear-combine /
    partition-linear-combine, substitution.cc:71-77): column-shard the
    up-projection, row-shard the down-projection, shard attention heads,
    and (new capability) shard the sequence dim of pre/post-block
    activations on the "seq"/data axis between attention regions.

    Weight-name heuristics follow models/transformer.py naming; generic
    graphs degrade gracefully to DP (unmatched weights replicated).
    """
    st = ParallelStrategy(axis_sizes={DATA_AXIS: dp, MODEL_AXIS: tp})
    from ..ops.base import get_op_def
    from .propagation import infer_all_specs

    specs = infer_all_specs(graph)
    for node in graph.topo_order():
        out_specs = specs[node.guid]
        in_specs = [specs[e.src][e.src_idx] for e in graph.in_edges(node)]
        op_def = get_op_def(node.op_type)
        wspecs = op_def.weight_specs(node.params, in_specs)
        by_name = {w.name: w for w in wspecs}
        weights: Dict[str, Optional[SpecTuple]] = {w.name: None for w in wspecs}

        for wname, dim in megatron_weight_dims(node).items():
            shard_weight_entry(weights, by_name, wname, dim, MODEL_AXIS, tp)
        shardings: List[Optional[SpecTuple]] = []
        for i, os in enumerate(out_specs):
            spec = None
            if node.op_type != OpType.WEIGHT and os.ndim > batch_dim and os.shape[batch_dim] % dp == 0:
                axes: List[Optional[str]] = [None] * os.ndim
                # build_mesh drops size-1 axes; a spec must not reference
                # a "data" axis the mesh won't have when dp == 1
                if dp > 1:
                    axes[batch_dim] = DATA_AXIS
                # sequence parallelism: shard seq dim of 3-D activations on
                # the model axis outside the attention/ff regions
                if (
                    sp
                    and batch_dim == 0
                    and os.ndim == 3
                    and node.op_type in (OpType.LAYERNORM, OpType.EW_ADD)
                    and os.shape[1] % tp == 0
                ):
                    axes[1] = MODEL_AXIS
                spec = pspec(*axes)
            shardings.append(spec)
        st.node_shardings[node.guid] = OpSharding(outputs=shardings, weights=weights)
    return st.record_names(graph)


def context_parallel_strategy(
    graph: PCGraph,
    dp: int,
    cp: int,
    tp: int = 1,
    batch_dim: int = 0,
    seq_dim: int = 1,
) -> ParallelStrategy:
    """Context parallelism for long sequences (NEW capability — the
    reference has no sequence parallelism, SURVEY §2.2/§5): activations
    shard their sequence dim on the "seq" mesh axis; attention nodes ride
    the ICI ring via ring attention (ops/kernels/ring_attention.py),
    which the attention lowering selects automatically when the mesh has
    a "seq" axis.

    tp > 1 composes Megatron tensor parallelism (cp x tp): block weights
    additionally shard on "model" per megatron_strategy's layout while
    the sequence rides "seq" — this is all GSPMD territory (unlike the
    pipeline's manual stages), so resharding between the two regimes is
    always legal and the compiler inserts the collectives."""
    axes_sizes = {DATA_AXIS: dp, SEQ_AXIS: cp}
    if tp > 1:
        axes_sizes[MODEL_AXIS] = tp
    st = ParallelStrategy(axis_sizes=axes_sizes)
    from ..ops.base import get_op_def
    from .propagation import infer_all_specs

    specs = infer_all_specs(graph)
    for node in graph.topo_order():
        out_specs = specs[node.guid]
        in_specs = [specs[e.src][e.src_idx] for e in graph.in_edges(node)]
        op_def = get_op_def(node.op_type)
        try:
            wspecs = op_def.weight_specs(node.params, in_specs)
        except Exception:
            wspecs = []
        by_name = {w.name: w for w in wspecs}
        weights: Dict[str, Optional[SpecTuple]] = {w.name: None for w in wspecs}
        if tp > 1:
            for wname, dim in megatron_weight_dims(node).items():
                shard_weight_entry(weights, by_name, wname, dim, MODEL_AXIS, tp)
        shardings: List[Optional[SpecTuple]] = []
        for os in out_specs:
            if node.op_type == OpType.WEIGHT or os.ndim <= batch_dim:
                shardings.append(None)
                continue
            axes: List[Optional[str]] = [None] * os.ndim
            if dp > 1 and os.shape[batch_dim] % dp == 0:
                axes[batch_dim] = DATA_AXIS
            if cp > 1 and os.ndim > seq_dim and os.shape[seq_dim] % cp == 0:
                axes[seq_dim] = SEQ_AXIS
            shardings.append(pspec(*axes) if any(a for a in axes) else None)
        st.node_shardings[node.guid] = OpSharding(outputs=shardings, weights=weights)
    return st.record_names(graph)


def expert_parallel_strategy(
    graph: PCGraph,
    dp: int,
    ep: int,
    batch_dim: int = 0,
) -> ParallelStrategy:
    """dp x ep hybrid for MoE graphs (reference: per-op machine views
    placing experts on distinct devices, examples/cpp/mixture_of_experts/
    moe.cc:180-204 + aggregate.cc): the stacked GROUP_BY output and the
    ExpertsOp weights shard their leading expert dim over the "expert"
    axis — each device holds n/ep experts and GSPMD materializes the
    token all_to_all at the dispatch/combine boundaries; token tensors
    ride the "data" axis."""
    from ..ops.base import get_op_def
    from .propagation import infer_all_specs

    st = ParallelStrategy(axis_sizes={DATA_AXIS: dp, EXPERT_AXIS: ep})
    specs = infer_all_specs(graph)
    for node in graph.topo_order():
        out_specs = specs[node.guid]
        in_specs = [specs[e.src][e.src_idx] for e in graph.in_edges(node)]
        op_def = get_op_def(node.op_type)
        try:
            wspecs = op_def.weight_specs(node.params, in_specs)
        except Exception:
            wspecs = []
        by_name = {w.name: w for w in wspecs}
        weights: Dict[str, Optional[SpecTuple]] = {w.name: None for w in wspecs}
        expert_sharded = False
        if node.op_type == OpType.EXPERTS and ep > 1 and node.params.n_experts % ep == 0:
            for wn in ("w1", "b1", "w2", "b2"):
                shard_weight_entry(weights, by_name, wn, 0, EXPERT_AXIS, ep)
            expert_sharded = True
        if node.op_type == OpType.GROUP_BY and getattr(node.params, "stacked", False):
            expert_sharded = ep > 1 and node.params.n_experts % ep == 0
        outputs: List[Optional[SpecTuple]] = []
        for os in out_specs:
            if expert_sharded and os.ndim == 3 and os.shape[0] % ep == 0:
                outputs.append(pspec(EXPERT_AXIS, None, None))
            elif (
                dp > 1
                and node.op_type != OpType.WEIGHT
                and os.ndim > batch_dim
                and os.shape[batch_dim] % dp == 0
            ):
                outputs.append(pspec(*([DATA_AXIS] + [None] * (os.ndim - 1))))
            else:
                outputs.append(None)
        st.node_shardings[node.guid] = OpSharding(outputs=outputs, weights=weights)
    return st.record_names(graph)


def pipeline_strategy(
    graph: PCGraph,
    pp: int,
    dp: int = 1,
    tp: int = 1,
    cp: int = 1,
    n_microbatches: int = 0,
    batch_dim: int = 0,
) -> ParallelStrategy:
    """dp x pp (x tp) (x cp) hybrid: the graph's repeated block stack is
    split into ``pp`` GPipe stages (stage costs balanced via
    balanced_stages over the analytic cost model — the search half the
    reference's graph splits performed, graph.cc:206-231), activations
    ride the "data" axis, stage params ride "pipe".

    tp > 1 composes Megatron tensor parallelism INSIDE each stage (3-D
    parallelism, a capability the reference never had): block weights
    additionally shard on "model" per megatron_strategy's layout, and
    the stage program reduces row-parallel partials with an explicit
    psum over "model" (ops consult LowerCtx.weight_sharded_dim — GSPMD
    cannot see inside the schedule's shard_map).

    cp > 1 additionally shards the CARRY's sequence dim over "seq"
    inside each stage (pp x cp, the long-context composition): every
    stage runs ring attention over its sequence shard
    (LowerCtx.cp_axis), halving per-device activation memory per doubling
    of cp. Weights stay replicated over "seq".

    Requires the number of repeated blocks to be divisible by pp (stages
    must be isomorphic so the executor can stack their params [S, r, ...]
    and run one SPMD stage program).
    """
    from .pipeline import balanced_stages, detect_repeats

    pre, repeats, post = detect_repeats(graph)
    if pp > 1:
        if len(repeats) < pp:
            raise ValueError(
                f"pipeline_stages={pp} but only {len(repeats)} repeated blocks detected"
            )
        if len(repeats) % pp != 0:
            raise ValueError(
                f"{len(repeats)} repeated blocks not divisible into {pp} isomorphic stages"
            )
        # repeats are verified isomorphic (equal cost), so the balanced
        # contiguous split is the uniform one; balanced_stages is the
        # general tool for heterogeneous-cost splits (search integration)
        r = len(repeats) // pp
        bounds = balanced_stages([1.0] * len(repeats), pp)
        if bounds != [i * r for i in range(pp + 1)]:
            bounds = [i * r for i in range(pp + 1)]  # stages must stay stackable
        stage_of = {}
        for s in range(pp):
            for rep in repeats[bounds[s] : bounds[s + 1]]:
                for node in rep:
                    stage_of[node.guid] = s
        if n_microbatches <= 0:
            n_microbatches = default_microbatches(_graph_batch(graph, batch_dim), pp, dp)
        pipeline = PipelineAssignment(pp, n_microbatches, stage_of)
    else:
        pipeline = None

    if tp > 1:
        st = megatron_strategy(graph, dp, tp, sp=False, batch_dim=batch_dim)
    else:
        st = data_parallel_strategy(graph, dp, batch_dim=batch_dim)
    st.axis_sizes = {DATA_AXIS: dp, PIPE_AXIS: pp}
    if tp > 1:
        st.axis_sizes[MODEL_AXIS] = tp
    if cp > 1:
        st.axis_sizes[SEQ_AXIS] = cp
    st.pipeline = pipeline
    if dp <= 1:
        # build_mesh drops size-1 axes: no "data" axis exists, so no
        # sharding constraint may reference it
        for g, s in st.node_shardings.items():
            st.node_shardings[g] = OpSharding(
                outputs=[None] * len(s.outputs), weights=s.weights
            )
    if pipeline is not None:
        # activations inside the pipelined region live under shard_map;
        # sharding constraints there are the schedule's business, not GSPMD's
        if tp > 1:
            # in-stage tp is MANUAL: GSPMD cannot reshard mid-stage, so
            # only provably-consistent nodes keep their Megatron sharding
            # (complete column->row pairs, self-consistent MHA)
            shardable = set()
            for rep in repeats:
                shardable |= tp_shardable_nodes(graph, rep)
        for guid in pipeline.stage_of:
            if guid in st.node_shardings:
                weights = st.node_shardings[guid].weights
                if tp > 1 and guid not in shardable:
                    weights = {w: None for w in weights}
                st.node_shardings[guid] = OpSharding(
                    outputs=[None] * len(st.node_shardings[guid].outputs),
                    weights=weights,
                )
    return st


def default_microbatches(batch: int, pp: int, dp: int = 1) -> int:
    """Pick the GPipe microbatch count: prefer 4*pp (bubble ~ (S-1)/(M+S-1)
    ~= 20%), fall back to smaller multiples, requiring batch % (M*dp) == 0
    so every microbatch keeps an even data-parallel split."""
    for m in (4 * pp, 2 * pp, pp):
        if m <= batch and batch % (m * dp) == 0:
            return m
    for m in range(min(batch // max(1, dp), 4 * pp), 0, -1):
        if batch % (m * dp) == 0:
            return m
    return 1


def _graph_batch(graph: PCGraph, batch_dim: int) -> int:
    from .propagation import infer_all_specs

    specs = infer_all_specs(graph)
    for node in graph.topo_order():
        if node.op_type == OpType.INPUT:
            s = specs[node.guid][0]
            if s.ndim > batch_dim:
                return s.shape[batch_dim]
    return 1


def data_parallel_strategy(graph: PCGraph, num_devices: int, batch_dim: int = 0) -> ParallelStrategy:
    """The reference's --only-data-parallel path (graph.cc:1939-1964):
    shard every activation's batch dim on the "data" axis, replicate all
    weights; gradient psum over "data" is inserted by XLA."""
    st = ParallelStrategy(axis_sizes={DATA_AXIS: num_devices})
    from ..ops.base import get_op_def
    from .propagation import infer_all_specs

    specs = infer_all_specs(graph)
    for node in graph.topo_order():
        out_specs = specs[node.guid]
        shardings = []
        for os in out_specs:
            if os.ndim > batch_dim and os.shape[batch_dim] % num_devices == 0 and node.op_type != OpType.WEIGHT:
                shardings.append(pspec(*([DATA_AXIS] + [None] * (os.ndim - 1))))
            else:
                shardings.append(None)
        in_edges = graph.in_edges(node)
        in_specs = []
        for e in in_edges:
            in_specs.append(specs[e.src][e.src_idx])
        op_def = get_op_def(node.op_type)
        wspecs = op_def.weight_specs(node.params, in_specs)
        st.node_shardings[node.guid] = OpSharding(
            outputs=shardings,
            weights={w.name: None for w in wspecs},  # None -> replicated
        )
    return st.record_names(graph)
