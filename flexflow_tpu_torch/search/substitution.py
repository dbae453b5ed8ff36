"""TASO-style substitution engine: pattern-based PCG rewriting (port of
``flexflow_tpu/search/substitution.py``).

Reference: src/runtime/substitution.cc (3802 LoC) — GraphXfer source/dest
``OpX`` patterns with parameter constraints (substitution.h:39-111),
backtracking match (can_match/match/unmatch substitution.h:173-175),
best-first search ``base_optimize`` with a priority queue and alpha
pruning (substitution.cc:2229-2311), built-in xfers generated per divisor
parallel degree (generate_all_pcg_xfers substitution.cc:1726-1840), and
JSON rule collections (substitution_loader.h/.cc; shipped rules
substitutions/graph_subst_3_v2.json — format preserved here so the
reference's rule files load unchanged).

The rewrites insert/remove *parallel ops* (Repartition/Combine/Replicate/
Reduction) around compute ops; on TPU these lower to sharding constraints
and GSPMD collectives rather than data-movement kernels, but the search
algebra is identical.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import json
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..core.graph import Edge, Node, PCGraph
from ..core.types import ActiMode, OpType
from ..ops.io_ops import NoOpParams
from ..ops.parallel_ops import (
    AllReduceParams,
    CombineParams,
    RepartitionParams,
    ReplicateParams,
    ReductionParams,
)

# ---------------------------------------------------------------------------
# pattern structures
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TensorX:
    """A tensor in a pattern: output ``ts_idx`` of pattern op ``op_idx``,
    or an external input when op_idx < 0 (reference: TensorX)."""

    op_idx: int  # index into the pattern's op list; -1 = external input
    ts_idx: int = 0


@dataclasses.dataclass
class OpX:
    """One pattern operator (reference: OpX substitution.h:85-111).

    constraints: param-name -> required value, checked against the matched
    node's params record (reference PMConstraint).
    make_params: for dest patterns, builds the concrete params given the
    matched source nodes (reference's dest-op construction).
    """

    op_type: OpType
    inputs: Tuple[TensorX, ...] = ()
    constraints: Dict[str, Any] = dataclasses.field(default_factory=dict)
    make_params: Optional[Callable[[List[Node]], Any]] = None
    match_fn: Optional[Callable[[Node], bool]] = None  # extra predicate
    # dest-only: reuse the guid of matched src op i, so compute nodes keep
    # their identity across rewrites and strategies stay addressable by the
    # frontend's node handles (the reference similarly reuses Op instances
    # via get_or_create caches, model.h:678-706)
    reuse_src: Optional[int] = None

    def matches(self, node: Node) -> bool:
        if node.op_type != self.op_type:
            return False
        for k, v in self.constraints.items():
            got = getattr(node.params, k, None)
            # a frozenset constraint means "any of these values" — used
            # for dim constraints whose positive/negative encodings are
            # equivalent for the rule's declared tensor rank
            if isinstance(v, frozenset):
                if got not in v:
                    return False
            elif got != v:
                return False
        if self.match_fn is not None and not self.match_fn(node):
            return False
        return True


@dataclasses.dataclass
class GraphXfer:
    """A rewrite rule: src pattern -> dst pattern
    (reference: GraphXfer substitution.h:169-246)."""

    name: str
    src_ops: List[OpX]
    dst_ops: List[OpX]
    # (src_op_idx, src_ts_idx) -> (dst_op_idx, dst_ts_idx): which dst tensor
    # replaces each src output consumed outside the pattern
    mapped_outputs: Dict[Tuple[int, int], Tuple[int, int]] = dataclasses.field(default_factory=dict)
    # canonical structural signature of the CONVERTED form (JSON-loaded
    # rules only) — duplicate pruning must compare what the matcher will
    # actually run, not the raw export (which still carries the weight
    # inputs conversion drops)
    signature: Optional[str] = None

    # ------------------------------------------------------------ matching
    def find_matches(self, graph: PCGraph, limit: int = 64) -> List[List[Node]]:
        """All assignments of graph nodes to src pattern ops, respecting
        op types, constraints, and internal wiring (reference:
        GraphXfer::run's recursive can_match/match loop)."""
        matches: List[List[Node]] = []
        assign: List[Optional[Node]] = [None] * len(self.src_ops)
        used: set = set()

        def wiring_ok(i: int, node: Node) -> bool:
            pat = self.src_ops[i]
            in_edges = graph.in_edges(node)
            for inp_pos, tx in enumerate(pat.inputs):
                if tx.op_idx < 0:
                    continue  # external input: anything goes
                producer = assign[tx.op_idx]
                if producer is None:
                    continue  # not yet assigned; checked later symmetrical
                e = next((e for e in in_edges if e.dst_idx == inp_pos), None)
                if e is None or e.src != producer.guid or e.src_idx != tx.ts_idx:
                    return False
            # also check edges from this node into already-assigned consumers
            for j, other in enumerate(self.src_ops):
                if assign[j] is None:
                    continue
                for inp_pos, tx in enumerate(other.inputs):
                    if tx.op_idx == i:
                        e = next(
                            (e for e in graph.in_edges(assign[j]) if e.dst_idx == inp_pos),
                            None,
                        )
                        if e is None or e.src != node.guid or e.src_idx != tx.ts_idx:
                            return False
            return True

        nodes = graph.topo_order()

        def rec(i: int):
            if len(matches) >= limit:
                return
            if i == len(self.src_ops):
                matches.append([assign[k] for k in range(len(self.src_ops))])  # type: ignore
                return
            pat = self.src_ops[i]
            for node in nodes:
                if node.guid in used or not pat.matches(node):
                    continue
                # pattern ops spell out EVERY input of the op they match;
                # arity must agree exactly or a 2-input concat pattern
                # swallows a 3-input concat and apply() drops an input
                # (reference: can_match checks numInputs, substitution.cc)
                if len(graph.in_edges(node)) != len(pat.inputs):
                    continue
                if not wiring_ok(i, node):
                    continue
                assign[i] = node
                used.add(node.guid)
                rec(i + 1)
                used.discard(node.guid)
                assign[i] = None

        rec(0)
        return matches

    # ------------------------------------------------------------- rewrite
    def apply(self, graph: PCGraph, match: List[Node]) -> Optional[PCGraph]:
        """Build the rewritten graph (reference: GraphXfer::create_new_graph).

        External inputs of the src pattern bind to the matched nodes'
        actual producers; src outputs consumed outside the pattern are
        re-wired to the mapped dst outputs.
        """
        g = graph.copy()
        matched_guids = {n.guid for n in match}
        # resolve external inputs: TensorX(-1, k) = the k-th distinct external
        # producer feeding the pattern, in (src_op, input_pos) order
        ext_bindings: Dict[int, Tuple[int, int]] = {}  # ext index -> (guid, src_idx)
        for i, pat in enumerate(self.src_ops):
            in_edges = graph.in_edges(match[i])
            for pos, tx in enumerate(pat.inputs):
                if tx.op_idx >= 0:
                    continue
                e = next((e for e in in_edges if e.dst_idx == pos), None)
                if e is None:
                    return None
                key = tx.ts_idx
                if key in ext_bindings and ext_bindings[key] != (e.src, e.src_idx):
                    return None  # inconsistent external binding
                ext_bindings[key] = (e.src, e.src_idx)

        # compute dst params before mutating anything
        dst_params: List[Any] = []
        for d in self.dst_ops:
            params = d.make_params(match) if d.make_params else None
            if params is None:
                return None
            dst_params.append(params)
        # record escaping consumer edges of the src pattern
        escapes: List[Tuple[int, Edge]] = []
        for i, src_node in enumerate(match):
            for e in graph.out_edges(src_node):
                if e.dst in matched_guids:
                    continue
                if (i, e.src_idx) not in self.mapped_outputs:
                    return None  # src output escapes but has no replacement
                escapes.append((i, e))
        # delete matched nodes (and their edges)
        for n in match:
            g.remove_node(n.guid)
        # instantiate dst ops; reuse_src keeps the original node's guid so
        # frontend tensor handles stay valid across rewrites
        new_nodes: List[Node] = []
        for d, params in zip(self.dst_ops, dst_params):
            if d.reuse_src is not None:
                orig = match[d.reuse_src]
                node = Node(orig.guid, d.op_type, params, orig.name)
                g.add_node(node)
            else:
                node = g.new_node(d.op_type, params, name=f"xfer:{self.name}")
            new_nodes.append(node)
        # wire dst inputs
        for di, d in enumerate(self.dst_ops):
            for pos, tx in enumerate(d.inputs):
                if tx.op_idx < 0:
                    if tx.ts_idx not in ext_bindings:
                        return None  # dst consumes an external never bound by src
                    src_guid, src_idx = ext_bindings[tx.ts_idx]
                else:
                    src_guid, src_idx = new_nodes[tx.op_idx].guid, tx.ts_idx
                g.add_edge(src_guid, new_nodes[di].guid, src_idx, pos)
        # re-route escaped consumers to the mapped dst outputs
        for i, e in escapes:
            d_op, d_ts = self.mapped_outputs[(i, e.src_idx)]
            g.add_edge(new_nodes[d_op].guid, e.dst, d_ts, e.dst_idx)
        return g

    def run(self, graph: PCGraph) -> List[PCGraph]:
        """All single-application rewrites of this xfer on the graph."""
        out = []
        for m in self.find_matches(graph):
            ng = self.apply(graph, m)
            if ng is not None:
                out.append(ng)
        return out


# ---------------------------------------------------------------------------
# built-in xfers (reference: substitution.cc:61-121, 1726-1840)
# ---------------------------------------------------------------------------


def _x(op_type, *inputs, **kw):
    return OpX(op_type, tuple(inputs), **kw)


def create_replicate_linear_combine(degree: int, activation: Optional[ActiMode] = None) -> GraphXfer:
    """Linear(x) => Combine(Linear(Replicate(x))) — tensor parallelism on
    the output dim (reference: create_replicate_linear_combine
    substitution.cc:71, 1756)."""

    def linear_params(match: List[Node]):
        return match[0].params  # same Linear params; sharding via neighbors

    constraints = {}
    if activation is not None:
        constraints["activation"] = activation
    src = [_x(OpType.LINEAR, TensorX(-1, 0), constraints=constraints)]
    dst = [
        _x(OpType.REPLICATE, TensorX(-1, 0), make_params=lambda m: ReplicateParams(degree)),
        _x(OpType.LINEAR, TensorX(0, 0), make_params=linear_params, reuse_src=0),
        _x(
            OpType.COMBINE,
            TensorX(1, 0),
            make_params=lambda m: CombineParams(dim=-1, degree=degree),
        ),
    ]
    return GraphXfer(
        name=f"replicate_linear_combine_{degree}",
        src_ops=src,
        dst_ops=dst,
        mapped_outputs={(0, 0): (2, 0)},
    )


def create_partition_linear_combine(degree: int, activation: Optional[ActiMode] = None) -> GraphXfer:
    """Linear(x) => Reduction(Linear(Repartition(x, last dim))) — row
    parallelism on the input dim (reference: create_partition_linear_combine
    substitution.cc:77)."""
    constraints = {}
    if activation is not None:
        constraints["activation"] = activation
    src = [_x(OpType.LINEAR, TensorX(-1, 0), constraints=constraints)]
    dst = [
        _x(
            OpType.REPARTITION,
            TensorX(-1, 0),
            make_params=lambda m: RepartitionParams(dim=-1, degree=degree),
        ),
        _x(OpType.LINEAR, TensorX(0, 0), make_params=lambda m: m[0].params, reuse_src=0),
        _x(
            OpType.REDUCTION,
            TensorX(1, 0),
            make_params=lambda m: ReductionParams(degree=degree),
        ),
    ]
    return GraphXfer(
        name=f"partition_linear_combine_{degree}",
        src_ops=src,
        dst_ops=dst,
        mapped_outputs={(0, 0): (2, 0)},
    )


def create_replicate_embedding_combine(degree: int) -> GraphXfer:
    """Embedding(x) => Combine(Embedding(Replicate(x))) — column parallelism
    over the embedding out_dim (reference: embedding is
    attribute-parallelizable, SURVEY §2.4 / src/ops/embedding.cc)."""

    def ok(node: Node) -> bool:
        return getattr(node.params, "out_dim", 0) % degree == 0

    src = [_x(OpType.EMBEDDING, TensorX(-1, 0), match_fn=ok)]
    dst = [
        _x(OpType.REPLICATE, TensorX(-1, 0), make_params=lambda m: ReplicateParams(degree)),
        _x(OpType.EMBEDDING, TensorX(0, 0), make_params=lambda m: m[0].params, reuse_src=0),
        _x(
            OpType.COMBINE,
            TensorX(1, 0),
            make_params=lambda m: CombineParams(dim=-1, degree=degree),
        ),
    ]
    return GraphXfer(
        name=f"replicate_embedding_combine_{degree}",
        src_ops=src,
        dst_ops=dst,
        mapped_outputs={(0, 0): (2, 0)},
    )


def create_replicate_attention_reduce(degree: int) -> GraphXfer:
    """MHA => Reduction(MHA(Replicate(q,k,v))) — head parallelism via the
    replica dim: each replica computes its head subset (weights sharded by
    the strategy layer), partial outputs sum in the Reduction (reference:
    create_replicate_attention_reduce substitution.cc:3197)."""

    def ok(node: Node) -> bool:
        return getattr(node.params, "num_heads", 0) % degree == 0

    src = [
        _x(
            OpType.MULTIHEAD_ATTENTION,
            TensorX(-1, 0),
            TensorX(-1, 1),
            TensorX(-1, 2),
            match_fn=ok,
        )
    ]
    dst = [
        _x(OpType.REPLICATE, TensorX(-1, 0), make_params=lambda m: ReplicateParams(degree)),
        _x(OpType.REPLICATE, TensorX(-1, 1), make_params=lambda m: ReplicateParams(degree)),
        _x(OpType.REPLICATE, TensorX(-1, 2), make_params=lambda m: ReplicateParams(degree)),
        _x(
            OpType.MULTIHEAD_ATTENTION,
            TensorX(0, 0),
            TensorX(1, 0),
            TensorX(2, 0),
            make_params=lambda m: m[0].params,
            reuse_src=0,
        ),
        _x(
            OpType.REDUCTION,
            TensorX(3, 0),
            make_params=lambda m: ReductionParams(degree=degree),
        ),
    ]
    return GraphXfer(
        name=f"replicate_attention_reduce_{degree}",
        src_ops=src,
        dst_ops=dst,
        mapped_outputs={(0, 0): (4, 0)},
    )


def create_partition_attention_combine(degree: int) -> GraphXfer:
    """MHA => Combine(MHA(Repartition(q,k,v))) — sample parallelism over
    the batch dim (reference: create_partition_attention_combine
    substitution.cc:3169; the reference partitions a data dim, attention
    over the full sequence stays exact when that dim is the batch)."""
    src = [
        _x(
            OpType.MULTIHEAD_ATTENTION,
            TensorX(-1, 0),
            TensorX(-1, 1),
            TensorX(-1, 2),
        )
    ]
    dst = [
        _x(OpType.REPARTITION, TensorX(-1, 0), make_params=lambda m: RepartitionParams(dim=0, degree=degree)),
        _x(OpType.REPARTITION, TensorX(-1, 1), make_params=lambda m: RepartitionParams(dim=0, degree=degree)),
        _x(OpType.REPARTITION, TensorX(-1, 2), make_params=lambda m: RepartitionParams(dim=0, degree=degree)),
        _x(
            OpType.MULTIHEAD_ATTENTION,
            TensorX(0, 0),
            TensorX(1, 0),
            TensorX(2, 0),
            make_params=lambda m: m[0].params,
            reuse_src=0,
        ),
        _x(
            OpType.COMBINE,
            TensorX(3, 0),
            make_params=lambda m: CombineParams(dim=0, degree=degree),
        ),
    ]
    return GraphXfer(
        name=f"partition_attention_combine_{degree}",
        src_ops=src,
        dst_ops=dst,
        mapped_outputs={(0, 0): (4, 0)},
    )


def create_partition_concat_combine(degree: int, num_inputs: int = 2) -> GraphXfer:
    """Concat(xs) => Combine(Concat(Repartition(xs))) on a non-concat dim
    (reference: create_partition_concat_combine substitution.cc:3380)."""

    def concat_params(m: List[Node]):
        if m[0].params.axis == 0:  # partition dim (0) must not be the concat axis
            return None
        return m[0].params

    src = [_x(OpType.CONCAT, *[TensorX(-1, i) for i in range(num_inputs)])]
    dst = (
        [
            _x(
                OpType.REPARTITION,
                TensorX(-1, i),
                make_params=lambda m: RepartitionParams(dim=0, degree=degree),
            )
            for i in range(num_inputs)
        ]
        + [
            _x(
                OpType.CONCAT,
                *[TensorX(i, 0) for i in range(num_inputs)],
                make_params=concat_params,
                reuse_src=0,
            ),
            _x(
                OpType.COMBINE,
                TensorX(num_inputs, 0),
                make_params=lambda m: CombineParams(dim=0, degree=degree),
            ),
        ]
    )
    return GraphXfer(
        name=f"partition_concat_combine_{num_inputs}_{degree}",
        src_ops=src,
        dst_ops=dst,
        mapped_outputs={(0, 0): (num_inputs + 1, 0)},
    )


def leading_relu_branch_combine(degree: int, num_combines: int = 2, dim: int = 0) -> GraphXfer:
    """A tensor feeding one Repartition plus N Combines (a branching point
    after e.g. a partitioned relu): drop the redundant Combines — branches
    consume the tensor directly (reference: leading_relu_branch_combine
    substitution.cc:3464; the Combines become NoOps)."""

    def keep_partition(m: List[Node]):
        p = m[0].params
        for c in m[1:]:
            if c.params.dim != p.dim or c.params.degree != p.degree:
                return None
        return p

    src = [_x(OpType.REPARTITION, TensorX(-1, 0), constraints={"dim": dim, "degree": degree})] + [
        _x(OpType.COMBINE, TensorX(-1, 0), constraints={"dim": dim, "degree": degree})
        for _ in range(num_combines)
    ]
    from ..ops.io_ops import NoOpParams

    dst = [_x(OpType.REPARTITION, TensorX(-1, 0), make_params=keep_partition, reuse_src=0)] + [
        _x(OpType.NOOP, TensorX(-1, 0), make_params=lambda m: NoOpParams())
        for _ in range(num_combines)
    ]
    return GraphXfer(
        name=f"leading_relu_branch_combine_{num_combines}_{degree}",
        src_ops=src,
        dst_ops=dst,
        mapped_outputs={(i, 0): (i, 0) for i in range(num_combines + 1)},
    )


def leading_relu_branch_partition(degree: int, num_partitions: int = 2, dim: int = 0) -> GraphXfer:
    """A tensor feeding N identical Repartitions: dedupe to one, the rest
    become NoOps of its output (reference: leading_relu_branch_partition
    substitution.cc:1841)."""
    from ..ops.io_ops import NoOpParams

    src = [
        _x(OpType.REPARTITION, TensorX(-1, 0), constraints={"dim": dim, "degree": degree})
        for _ in range(num_partitions)
    ]
    dst = [_x(OpType.REPARTITION, TensorX(-1, 0), make_params=lambda m: m[0].params, reuse_src=0)] + [
        _x(OpType.NOOP, TensorX(0, 0), make_params=lambda m: NoOpParams())
        for _ in range(num_partitions - 1)
    ]
    return GraphXfer(
        name=f"leading_relu_branch_partition_{num_partitions}_{degree}",
        src_ops=src,
        dst_ops=dst,
        mapped_outputs={(0, 0): (0, 0), **{(i, 0): (i, 0) for i in range(1, num_partitions)}},
    )


def _partition_unary_combine(op_type: OpType, degree: int, dim: int = 0) -> GraphXfer:
    """<op>(x) => Combine(<op>(Repartition(x))) for ops that commute with
    batch partitioning (reference: create_partition_relu_combine /
    partition_softmax_combine etc., substitution.cc:1797-1830)."""
    src = [_x(op_type, TensorX(-1, 0))]
    dst = [
        _x(
            OpType.REPARTITION,
            TensorX(-1, 0),
            make_params=lambda m: RepartitionParams(dim=dim, degree=degree),
        ),
        _x(op_type, TensorX(0, 0), make_params=lambda m: m[0].params, reuse_src=0),
        _x(
            OpType.COMBINE,
            TensorX(1, 0),
            make_params=lambda m: CombineParams(dim=dim, degree=degree),
        ),
    ]
    return GraphXfer(
        name=f"partition_{op_type.value}_combine_{degree}_d{dim}",
        src_ops=src,
        dst_ops=dst,
        mapped_outputs={(0, 0): (2, 0)},
    )


def create_partition_add_combine(degree: int, dim: int = 0) -> GraphXfer:
    src = [_x(OpType.EW_ADD, TensorX(-1, 0), TensorX(-1, 1))]
    dst = [
        _x(OpType.REPARTITION, TensorX(-1, 0), make_params=lambda m: RepartitionParams(dim=dim, degree=degree)),
        _x(OpType.REPARTITION, TensorX(-1, 1), make_params=lambda m: RepartitionParams(dim=dim, degree=degree)),
        _x(OpType.EW_ADD, TensorX(0, 0), TensorX(1, 0), make_params=lambda m: m[0].params, reuse_src=0),
        _x(OpType.COMBINE, TensorX(2, 0), make_params=lambda m: CombineParams(dim=dim, degree=degree)),
    ]
    return GraphXfer(
        name=f"partition_add_combine_{degree}",
        src_ops=src,
        dst_ops=dst,
        mapped_outputs={(0, 0): (3, 0)},
    )


def create_combine_inception(degree: int, num_branches: int = 2) -> GraphXfer:
    """Concat of partitioned branches: hoist the Combine past the Concat
    (reference: combine_inception/concat xfers substitution.cc:109-121).
    Simplified to 2 branches: Concat(Combine(a), Combine(b)) =>
    Combine(Concat(a, b))."""
    src = [
        _x(OpType.COMBINE, TensorX(-1, 0)),
        _x(OpType.COMBINE, TensorX(-1, 1)),
        _x(OpType.CONCAT, TensorX(0, 0), TensorX(1, 0)),
    ]
    dst = [
        _x(OpType.CONCAT, TensorX(-1, 0), TensorX(-1, 1), make_params=lambda m: m[2].params, reuse_src=2),
        _x(
            OpType.COMBINE,
            TensorX(0, 0),
            make_params=lambda m: m[0].params,
        ),
    ]
    return GraphXfer(
        name=f"combine_concat_{degree}",
        src_ops=src,
        dst_ops=dst,
        mapped_outputs={(2, 0): (1, 0)},
    )


def create_linear_relu_fusion() -> GraphXfer:
    """Relu(Linear(x)) => Linear(x, activation=relu) (reference:
    leading linear+relu fusion xfer substitution.cc:96-105). On TPU XLA
    fuses this anyway; the xfer still shrinks the search graph."""

    def fused_params(match: List[Node]):
        p = match[0].params
        if getattr(p, "activation", None) != ActiMode.NONE:
            return None
        return dataclasses.replace(p, activation=ActiMode.RELU)

    src = [
        _x(OpType.LINEAR, TensorX(-1, 0), constraints={"activation": ActiMode.NONE}),
        _x(OpType.RELU, TensorX(0, 0)),
    ]
    dst = [_x(OpType.LINEAR, TensorX(-1, 0), make_params=fused_params, reuse_src=0)]
    return GraphXfer(
        name="linear_relu_fusion",
        src_ops=src,
        dst_ops=dst,
        mapped_outputs={(1, 0): (0, 0)},
    )


def generate_all_pcg_xfers(
    degrees: Sequence[int],
    enable_parameter_parallel: bool = True,
    enable_attribute_parallel: bool = False,
) -> List[GraphXfer]:
    """All built-in xfers for the given shard degrees (reference:
    generate_all_pcg_xfers substitution.cc:1726-1840, generated per
    divisor of the device count)."""
    xfers: List[GraphXfer] = [create_linear_relu_fusion()]
    for d in degrees:
        if d < 2:
            continue
        if enable_parameter_parallel:
            xfers.append(create_replicate_linear_combine(d))
            xfers.append(create_partition_linear_combine(d))
            xfers.append(create_replicate_attention_reduce(d))
            xfers.append(create_replicate_embedding_combine(d))
        xfers.append(create_partition_attention_combine(d))
        xfers.append(create_partition_add_combine(d))
        xfers.append(_partition_unary_combine(OpType.RELU, d))
        xfers.append(_partition_unary_combine(OpType.SOFTMAX, d))
        # per arity: the matcher requires exact input counts (reference
        # generates per-arity mapping xfers the same way)
        xfers.append(create_partition_concat_combine(d))
        xfers.append(create_partition_concat_combine(d, num_inputs=3))
        xfers.append(create_partition_concat_combine(d, num_inputs=4))
        xfers.append(create_combine_inception(d))
        xfers.append(leading_relu_branch_combine(d))
        xfers.append(leading_relu_branch_partition(d))
        if enable_attribute_parallel:
            # partition spatial dims of conv/pool (reference:
            # create_mapping_xfers<Conv2D/Pool2D> substitution.cc:1797-1800)
            xfers.append(_partition_unary_combine(OpType.CONV2D, d, dim=2))
            xfers.append(_partition_unary_combine(OpType.POOL2D, d, dim=2))
    return xfers


# ---------------------------------------------------------------------------
# JSON rule loading (reference: substitution_loader.cc; format of
# substitutions/graph_subst_3_v2.json)
# ---------------------------------------------------------------------------

_JSON_OP_MAP = {
    "OP_LINEAR": OpType.LINEAR,
    "OP_CONV2D": OpType.CONV2D,
    "OP_POOL2D_MAX": OpType.POOL2D,
    "OP_POOL2D_AVG": OpType.POOL2D,
    "OP_RELU": OpType.RELU,
    "OP_SIGMOID": OpType.SIGMOID,
    "OP_TANH": OpType.TANH,
    "OP_EW_ADD": OpType.EW_ADD,
    "OP_EW_MUL": OpType.EW_MUL,
    "OP_CONCAT": OpType.CONCAT,
    "OP_SPLIT": OpType.SPLIT,
    "OP_RESHAPE": OpType.RESHAPE,
    "OP_TRANSPOSE": OpType.TRANSPOSE,
    "OP_SOFTMAX": OpType.SOFTMAX,
    "OP_MATMUL": OpType.BATCH_MATMUL,
    "OP_BATCHNORM": OpType.BATCHNORM,
    "OP_DROPOUT": OpType.DROPOUT,
    "OP_MULTIHEAD_ATTENTION": OpType.MULTIHEAD_ATTENTION,
    "OP_PARTITION": OpType.REPARTITION,
    "OP_COMBINE": OpType.COMBINE,
    "OP_REPLICATE": OpType.REPLICATE,
    "OP_REDUCE": OpType.REDUCTION,
    "OP_EMBEDDING": OpType.EMBEDDING,
    "OP_NOOP": OpType.NOOP,
}

_PARALLEL_PARAM_MAKERS = {
    OpType.REPARTITION: lambda dim, deg: RepartitionParams(dim=dim, degree=deg),
    OpType.COMBINE: lambda dim, deg: CombineParams(dim=dim, degree=deg),
    OpType.REPLICATE: lambda dim, deg: ReplicateParams(degree=deg),
    OpType.REDUCTION: lambda dim, deg: ReductionParams(degree=deg),
}

# mirror of the reference's get_num_inputs (substitution.cc:1416-1454):
# the TASO export lists weight tensors as op inputs (a Linear srcOp has
# [activation, weight]); the reference truncates each op to its graph
# arity, dropping weight inputs — PCG edges carry data only.
_RULE_NUM_INPUTS = {
    OpType.EW_ADD: 2,
    OpType.EW_MUL: 2,
    OpType.BATCH_MATMUL: 2,
    OpType.LINEAR: 1,
    OpType.CONV2D: 1,
    OpType.POOL2D: 1,
    OpType.RELU: 1,
    OpType.SIGMOID: 1,
    OpType.TANH: 1,
    OpType.IDENTITY: 1,
    OpType.SPLIT: 1,
    OpType.RESHAPE: 1,
    OpType.TRANSPOSE: 1,
    OpType.SOFTMAX: 1,
    OpType.BATCHNORM: 1,
    OpType.DROPOUT: 1,
    OpType.EMBEDDING: 1,
    OpType.NOOP: 1,
    OpType.REPARTITION: 1,
    OpType.COMBINE: 1,
    OpType.REPLICATE: 1,
    OpType.REDUCTION: 1,
    OpType.MULTIHEAD_ATTENTION: 3,
}

# op types whose PCG nodes own NO weights: a dst op of one of these may
# be instantiated FRESH (new guid) when another dst op already reused the
# matched src node's guid — weighted types must stay unique per rule or
# the copy would re-initialize its own weights (changing semantics)
_WEIGHTLESS_RULE_OPS = frozenset(
    {
        OpType.EW_ADD, OpType.EW_MUL, OpType.RELU, OpType.SIGMOID,
        OpType.TANH, OpType.IDENTITY, OpType.CONCAT, OpType.SPLIT,
        OpType.RESHAPE, OpType.TRANSPOSE, OpType.SOFTMAX, OpType.DROPOUT,
        OpType.BATCH_MATMUL, OpType.NOOP, OpType.POOL2D,
    }
)

# TASO's ActiMode enum (ops.h): the exported rules carry these raw ints.
# (The reference compares them against its OWN ActiMode enum, whose
# values start at 10 — ffconst.h:5 — so its PM_ACTI constraints can
# never hold; here they're mapped so activation-constrained rules work.)
_TASO_ACTI = {0: ActiMode.NONE, 1: ActiMode.SIGMOID, 2: ActiMode.RELU, 3: ActiMode.TANH}


def load_substitution_json(path: str, degrees: Sequence[int] = (2,)) -> List[GraphXfer]:
    """Load a reference-format rule collection (--substitution-json,
    config.h:146; serde substitution_loader.cc; conversion semantics of
    create_xfers, substitution.cc:1659-1786).

    Reference parity choices:
      * weight inputs are dropped per-op (get_num_inputs mirror above);
      * distinct external tensors keyed by (opId, tsId) stay distinct
        (the reference allocates one TensorX per distinct pair);
      * rules are exported with PM_PARALLEL_DEGREE == 2 and instantiated
        once per requested runtime degree (create_xfers' parallel_degree);
      * single-op -> single-op rules are skipped;
      * structural duplicates (same types + constraints + wiring) are
        pruned, as in create_xfers' redundant-xfer check.
    Rules whose op types have no analog here, or whose dest compute ops
    cannot inherit params from a unique same-typed src op, are skipped —
    mirroring the reference's partial support for TASO exports (its own
    find_opx_with_type asserts a unique source op).
    """
    with open(path) as f:
        data = json.load(f)
    rules = data["rule"] if isinstance(data, dict) else data
    out: List[GraphXfer] = []
    seen_sigs = set()
    for degree in degrees:
        for rule in rules:
            xfer = _rule_to_xfer(rule, degree)
            if xfer is None:
                continue
            # dedup on the CONVERTED form (reference: create_xfers'
            # check_opxes_have_same_type_and_constraints pruning,
            # substitution.cc:1615) — distinct exports whose dropped
            # weight inputs were the only difference collapse here
            if xfer.signature in seen_sigs:
                continue
            seen_sigs.add(xfer.signature)
            out.append(xfer)
    return out


def _rule_to_xfer(rule: dict, degree: int = 2) -> Optional[GraphXfer]:
    # externals are shared between src and dst sides, keyed by the rule's
    # (opId, tsId) — reference create_xfer's get_input_tensor memo
    ext_keys: Dict[Tuple[int, int], int] = {}

    def ext(op_id: int, ts_id: int) -> TensorX:
        key = (op_id, ts_id)
        if key not in ext_keys:
            ext_keys[key] = len(ext_keys)
        return TensorX(-1, ext_keys[key])

    src_types: List[OpType] = [
        _JSON_OP_MAP.get(op["type"]) for op in rule.get("srcOp", [])
    ]
    if any(t is None for t in src_types):
        return None

    # tensor rank the rule was exported for (PM_NUMDIM; the TASO DNN
    # collection is rank-3 throughout — rules that omit it default to 3).
    # Needed to equate positive and negative dim encodings below.
    nd_vals = [
        p["value"]
        for side in ("srcOp", "dstOp")
        for op in rule.get(side, [])
        for p in op.get("para", [])
        if p["key"] == "PM_NUMDIM"
    ]
    numdim = nd_vals[0] if nd_vals else 3

    # src parallel ops that carry a dim, as (src index, raw innermost-
    # first dim): dst parallel ops mirroring the same declared dim reuse
    # the MATCHED node's actual dim encoding at apply time — rank-correct
    # for any graph, where the -(k+1) fallback assumes rank == numdim
    src_par_dims: List[Tuple[int, int]] = [
        (i, next(p["value"] for p in op.get("para", []) if p["key"] == "PM_PARALLEL_DIM"))
        for i, op in enumerate(rule.get("srcOp", []))
        if src_types[i] in (OpType.REPARTITION, OpType.COMBINE)
        and any(p["key"] == "PM_PARALLEL_DIM" for p in op.get("para", []))
    ]

    def parse_ops(op_list, is_dst: bool, sig_ops: List) -> Optional[List[OpX]]:
        ops: List[OpX] = []
        reused_src: set = set()
        for op in op_list:
            ot = _JSON_OP_MAP.get(op["type"])
            if ot is None:
                return None
            para = {p["key"]: p["value"] for p in op.get("para", [])}
            arity = _RULE_NUM_INPUTS.get(ot, len(op.get("input", [])))
            if ot == OpType.CONCAT:
                arity = para.get("PM_NUM_INPUTS", len(op.get("input", [])))
            raw_inputs = op.get("input", [])[:arity]
            inputs = tuple(
                TensorX(t["opId"], t["tsId"]) if t["opId"] >= 0 else ext(t["opId"], t["tsId"])
                for t in raw_inputs
            )
            # reference ParallelTensor dims are innermost-first (dims[0]
            # = feature); this PCG indexes outermost-first, so rule dim k
            # maps to negative dim -(k+1) — uniform across tensor ranks
            dim = -(para.get("PM_PARALLEL_DIM", 0) + 1)
            acti = _TASO_ACTI.get(para["PM_ACTI"]) if "PM_ACTI" in para else None
            if "PM_ACTI" in para and acti is None:
                return None  # unknown activation encoding
            make = None
            if is_dst:
                maker = _PARALLEL_PARAM_MAKERS.get(ot)
                if maker is not None:
                    raw_k = para.get("PM_PARALLEL_DIM", 0)

                    def make(m, _mk=maker, _neg=dim, _deg=degree, _k=raw_k):
                        for i, k2 in src_par_dims:
                            node_dim = getattr(m[i].params, "dim", None)
                            if k2 == _k and node_dim is not None:
                                return _mk(node_dim, _deg)
                        return _mk(_neg, _deg)

                    ops.append(OpX(ot, inputs, make_params=make))
                    sig_ops.append((ot.name, "par", raw_k, degree, inputs))
                    continue
                elif ot == OpType.NOOP:
                    # pass-through alias op (reference create_noop,
                    # substitution.cc:1063) — needs no source counterpart
                    ops.append(OpX(ot, inputs, make_params=lambda m: NoOpParams()))
                    sig_ops.append((ot.name, "noop", inputs))
                    continue
                else:
                    # dest compute op inherits params (and guid/weights,
                    # via reuse_src below) from the unique same-typed src
                    # op; the reference's find_opx_with_type asserts this
                    # uniqueness for its matchOpX reuse
                    same = [i for i, t in enumerate(src_types) if t == ot]
                    if len(same) != 1:
                        return None
                    idx = same[0]
                    # only ONE dst op may reuse the matched node's guid —
                    # a second same-typed dst (distributivity rules:
                    # mul(add(a,b),c) -> add(mul,mul)) must be a FRESH
                    # node or apply() silently merges the two into one
                    # guid (duplicate in-edges per slot). Fresh copies of
                    # WEIGHTED ops would re-initialize weights, so those
                    # rules are skipped.
                    reuse = idx if idx not in reused_src else None
                    if reuse is None and ot not in _WEIGHTLESS_RULE_OPS:
                        return None
                    if reuse is not None:
                        reused_src.add(idx)

                    def make(m, _i=idx, _acti=acti):
                        p = m[_i].params
                        if _acti is not None and getattr(p, "activation", None) not in (None, _acti):
                            p = dataclasses.replace(p, activation=_acti)
                        return p

                    ops.append(OpX(ot, inputs, make_params=make, reuse_src=reuse))
                    sig_ops.append((ot.name, "compute", idx, reuse, str(acti), inputs))
                    continue
            constraints: Dict[str, Any] = {}
            if not is_dst:
                if ot in _PARALLEL_PARAM_MAKERS:
                    if "PM_PARALLEL_DEGREE" in para:
                        # exported rules always say 2; constrain to the
                        # runtime degree this instantiation targets
                        constraints["degree"] = degree
                    if "PM_PARALLEL_DIM" in para and ot in (OpType.REPARTITION, OpType.COMBINE):
                        # graph nodes use either encoding (builtin xfers
                        # write dim=-1 for feature, dim=0 for batch):
                        # accept both forms, equivalent at the rule's rank
                        forms = {dim}
                        if dim + numdim >= 0:
                            forms.add(dim + numdim)
                        constraints["dim"] = frozenset(forms)
                elif acti is not None:
                    constraints["activation"] = acti

                def axis_forms(k: int) -> frozenset:
                    # same innermost-first convention (and the same
                    # positive/negative dual encoding) as PM_PARALLEL_DIM
                    neg = -(k + 1)
                    forms = {neg}
                    if neg + numdim >= 0:
                        forms.add(neg + numdim)
                    return frozenset(forms)

                if ot == OpType.CONCAT and "PM_AXIS" in para:
                    constraints["axis"] = axis_forms(para["PM_AXIS"])
                if ot == OpType.SOFTMAX and "PM_SOFTMAX_DIM" in para:
                    constraints["axis"] = axis_forms(para["PM_SOFTMAX_DIM"])
            ops.append(OpX(ot, inputs, constraints=constraints, make_params=make))
            sig_ops.append(
                (
                    ot.name,
                    "src" if not is_dst else "dst",
                    tuple(
                        sorted(
                            (k, tuple(sorted(v)) if isinstance(v, frozenset) else str(v))
                            for k, v in constraints.items()
                        )
                    ),
                    inputs,
                )
            )
        return ops

    sig_src: List = []
    sig_dst: List = []
    src = parse_ops(rule.get("srcOp", []), is_dst=False, sig_ops=sig_src)
    dst = parse_ops(rule.get("dstOp", []), is_dst=True, sig_ops=sig_dst)
    if not src or not dst:
        return None
    if len(src) == 1 and len(dst) == 1:
        return None  # reference create_xfers skips 1->1 rules
    mapped = {}
    for mo in rule.get("mappedOutput", []):
        mapped[(mo["srcOpId"], mo["srcTsId"])] = (mo["dstOpId"], mo["dstTsId"])
    signature = repr((degree, sig_src, sig_dst, sorted(mapped.items())))
    return GraphXfer(rule.get("name", "json_rule"), src, dst, mapped, signature=signature)


# ---------------------------------------------------------------------------
# best-first substitution search (reference: base_optimize
# substitution.cc:2229-2311)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SearchStats:
    candidates_explored: int = 0
    best_cost: float = float("inf")
    iterations: int = 0


def base_optimize(
    graph: PCGraph,
    xfers: Sequence[GraphXfer],
    cost_fn: Callable[[PCGraph], float],
    budget: int = 100,
    alpha: float = 1.05,
    max_num_ops: Optional[int] = None,
) -> Tuple[PCGraph, SearchStats]:
    """Best-first search over substitution applications.

    Reference semantics (substitution.cc:2229-2311): priority queue ordered
    by cost; pop best, try every xfer at every match; candidates costing
    more than alpha * best are pruned; stop after ``budget`` pops.
    """
    stats = SearchStats()
    best_graph = graph
    best_cost = cost_fn(graph)
    stats.best_cost = best_cost
    max_ops = max_num_ops or max(64, 2 * len(graph))
    counter = itertools.count()
    pq: List[Tuple[float, int, PCGraph]] = [(best_cost, next(counter), graph)]
    seen = {graph.structural_hash()}
    while pq and stats.iterations < budget:
        cost, _, g = heapq.heappop(pq)
        stats.iterations += 1
        if cost > alpha * best_cost:
            continue  # alpha pruning
        for xfer in xfers:
            for candidate in xfer.run(g):
                if len(candidate) > max_ops:
                    continue
                h = candidate.structural_hash()
                if h in seen:
                    continue
                seen.add(h)
                stats.candidates_explored += 1
                c = cost_fn(candidate)
                if c < best_cost:
                    best_cost = c
                    best_graph = candidate
                    stats.best_cost = c
                if c < alpha * best_cost:
                    heapq.heappush(pq, (c, next(counter), candidate))
    return best_graph, stats
