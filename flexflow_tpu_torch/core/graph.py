"""Parallel computation graph (port of ``flexflow_tpu/core/graph.py``).

Nodes are operator instances (OpType + frozen, hashable param record);
edges carry (src output index, dst input index). The graph supports what
the Unity search needs: adding and removing nodes and edges, queries,
a deterministic topological order, a guid-independent structural hash,
subgraphs, the split at a bottleneck node, and DOT export.
:meth:`PCGraph.to_json` writes the JAX package's JSON, guids kept, and
:meth:`PCGraph.from_json` reads it back: each package reads the other's
graphs (the model repository's ``graph.json``).
"""
from __future__ import annotations

import dataclasses
import enum
import itertools
import json
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from .types import OpType, PARALLEL_OP_TYPES


@dataclasses.dataclass(frozen=True)
class Node:
    """One operator instance in the PCG (reference: graph.h Node — Op* + guid)."""

    guid: int
    op_type: OpType
    params: Any  # frozen dataclass from ops/<op>.py; hashable
    name: str = ""

    def param_hash(self) -> int:
        """Structural hash ignoring guid (for memoization / dedup)."""
        return hash((self.op_type, self.params))

    def __repr__(self):
        return f"Node({self.guid}:{self.op_type.value}{':' + self.name if self.name else ''})"


@dataclasses.dataclass(frozen=True)
class Edge:
    """Tensor flow edge (reference: graph.h Edge — srcOp/dstOp + srcIdx/dstIdx)."""

    src: int  # producer node guid
    dst: int  # consumer node guid
    src_idx: int = 0  # producer output index
    dst_idx: int = 0  # consumer input index


class PCGraph:
    """Mutable computation graph (reference: PCG::Graph, graph.h:293)."""

    _guid_counter = itertools.count(1000)  # guids globally unique, like reference GUIDs

    def __init__(self):
        self.nodes: Dict[int, Node] = {}
        self._in_edges: Dict[int, List[Edge]] = {}
        self._out_edges: Dict[int, List[Edge]] = {}

    def new_node(self, op_type: OpType, params: Any, name: str = "") -> Node:
        node = Node(next(PCGraph._guid_counter), op_type, params, name)
        self.add_node(node)
        return node

    def add_node(self, node: Node) -> Node:
        self.nodes[node.guid] = node
        self._in_edges.setdefault(node.guid, [])
        self._out_edges.setdefault(node.guid, [])
        return node

    def add_edge(self, src: Node | int, dst: Node | int, src_idx: int = 0, dst_idx: int = 0) -> Edge:
        s = src.guid if isinstance(src, Node) else src
        d = dst.guid if isinstance(dst, Node) else dst
        if s not in self.nodes or d not in self.nodes:
            raise KeyError(f"edge endpoints must be in graph: {s}->{d}")
        e = Edge(s, d, src_idx, dst_idx)
        self._out_edges[s].append(e)
        self._in_edges[d].append(e)
        return e

    def remove_node(self, guid: int):
        for e in list(self._in_edges.get(guid, [])):
            self._out_edges[e.src].remove(e)
        for e in list(self._out_edges.get(guid, [])):
            self._in_edges[e.dst].remove(e)
        self._in_edges.pop(guid, None)
        self._out_edges.pop(guid, None)
        self.nodes.pop(guid, None)

    def remove_edge(self, e: Edge):
        self._out_edges[e.src].remove(e)
        self._in_edges[e.dst].remove(e)

    def replace_edge_src(self, e: Edge, new_src: Node | int, new_src_idx: int = 0):
        self.remove_edge(e)
        self.add_edge(new_src, e.dst, new_src_idx, e.dst_idx)

    # ---------------------------------------------------------------- query
    def in_edges(self, n: Node | int) -> List[Edge]:
        g = n.guid if isinstance(n, Node) else n
        return sorted(self._in_edges.get(g, []), key=lambda e: e.dst_idx)

    def out_edges(self, n: Node | int) -> List[Edge]:
        g = n.guid if isinstance(n, Node) else n
        return sorted(self._out_edges.get(g, []), key=lambda e: (e.src_idx, e.dst))

    def predecessors(self, n: Node | int) -> List[Node]:
        return [self.nodes[e.src] for e in self.in_edges(n)]

    def successors(self, n: Node | int) -> List[Node]:
        return [self.nodes[e.dst] for e in self.out_edges(n)]

    def source_nodes(self) -> List[Node]:
        return [self.nodes[g] for g in self.nodes if not self._in_edges[g]]

    def sink_nodes(self) -> List[Node]:
        return [self.nodes[g] for g in self.nodes if not self._out_edges[g]]

    def __len__(self):
        return len(self.nodes)

    def __contains__(self, n: Node | int):
        return (n.guid if isinstance(n, Node) else n) in self.nodes

    def topo_order(self) -> List[Node]:
        """Deterministic topological order (stable across runs: by guid)."""
        indeg = {g: len(self._in_edges[g]) for g in self.nodes}
        ready = sorted(g for g, d in indeg.items() if d == 0)
        order: List[Node] = []
        while ready:
            g = ready.pop(0)
            order.append(self.nodes[g])
            nxt = []
            for e in self._out_edges[g]:
                indeg[e.dst] -= 1
                if indeg[e.dst] == 0:
                    nxt.append(e.dst)
            ready = sorted(set(ready) | set(nxt))
        if len(order) != len(self.nodes):
            raise ValueError("graph has a cycle")
        return order

    # --------------------------------------------------------------- hashing
    def structural_hash(self) -> int:
        """Guid-independent hash for DP memoization (reference:
        graph.cc:1863). Python's hash of the enums in it is salted per
        process, so two processes (or the two packages) agree on which
        graphs hash equal, not on the values."""
        order = self.topo_order()
        canon = {n.guid: i for i, n in enumerate(order)}
        node_sig = tuple((canon[n.guid], n.op_type, n.params) for n in order)
        edge_sig = tuple(
            sorted(
                (canon[e.src], canon[e.dst], e.src_idx, e.dst_idx)
                for g in self.nodes
                for e in self._out_edges[g]
            )
        )
        return hash((node_sig, edge_sig))

    # ----------------------------------------------------------------- algos
    def copy(self) -> "PCGraph":
        g = PCGraph()
        g.nodes = dict(self.nodes)
        g._in_edges = {k: list(v) for k, v in self._in_edges.items()}
        g._out_edges = {k: list(v) for k, v in self._out_edges.items()}
        return g

    def subgraph(self, guids: Iterable[int]) -> "PCGraph":
        keep = set(guids)
        g = PCGraph()
        for guid in keep:
            g.add_node(self.nodes[guid])
        for guid in keep:
            for e in self._out_edges[guid]:
                if e.dst in keep:
                    g._out_edges[e.src].append(e)
                    g._in_edges[e.dst].append(e)
        return g

    def split_at_node(self, bottleneck: Node) -> Tuple["PCGraph", "PCGraph"]:
        """Split into (ancestors + node, node + descendants) at a
        bottleneck (reference: Graph::split_at_node, graph.h:346). The
        node is in both halves: the first's sink and the second's
        source."""
        anc = self.ancestors(bottleneck) | {bottleneck.guid}
        first = self.subgraph(anc)
        rest = (set(self.nodes) - anc) | {bottleneck.guid}
        second = self.subgraph(rest)
        return first, second

    def ancestors(self, n: Node | int) -> set:
        g = n.guid if isinstance(n, Node) else n
        seen: set = set()
        stack = [e.src for e in self._in_edges[g]]
        while stack:
            cur = stack.pop()
            if cur in seen:
                continue
            seen.add(cur)
            stack.extend(e.src for e in self._in_edges[cur])
        return seen

    def descendants(self, n: Node | int) -> set:
        g = n.guid if isinstance(n, Node) else n
        seen: set = set()
        stack = [e.dst for e in self._out_edges[g]]
        while stack:
            cur = stack.pop()
            if cur in seen:
                continue
            seen.add(cur)
            stack.extend(e.dst for e in self._out_edges[cur])
        return seen

    def bottleneck_nodes(self) -> List[Node]:
        """Nodes every other node is an ancestor or a descendant of: the
        DP search's sequential split points (reference:
        SearchHelper::find_optimal_sequence_graph_time, graph.cc:115)."""
        total = set(self.nodes)
        out = []
        for n in self.topo_order():
            anc = self.ancestors(n)
            desc = self.descendants(n)
            if len(anc) + len(desc) + 1 == len(total) and not (anc & desc):
                out.append(n)
        return out

    def to_dot(self, label_fn: Optional[Callable[[Node], str]] = None) -> str:
        """DOT export (reference: --compgraph export, graph.h:339):
        parallel ops as ellipses, the others as boxes."""
        lines = ["digraph PCG {"]
        for n in self.topo_order():
            label = label_fn(n) if label_fn else f"{n.op_type.value}\\n{n.name or n.guid}"
            shape = "ellipse" if n.op_type in PARALLEL_OP_TYPES else "box"
            lines.append(f'  n{n.guid} [label="{label}", shape={shape}];')
        for g in sorted(self.nodes):
            for e in self._out_edges[g]:
                lines.append(f"  n{e.src} -> n{e.dst};")
        lines.append("}")
        return "\n".join(lines)

    # ----------------------------------------------------------------- serde
    def to_json(self) -> str:
        nodes = []
        for n in self.topo_order():
            p = dataclasses.asdict(n.params) if dataclasses.is_dataclass(n.params) else n.params
            nodes.append(
                {"guid": n.guid, "op_type": n.op_type.value, "name": n.name, "params": _jsonable(p)}
            )
        edges = [
            dataclasses.asdict(e)
            for g in sorted(self.nodes)
            for e in self._out_edges[g]
        ]
        return json.dumps({"nodes": nodes, "edges": edges}, indent=1)

    @classmethod
    def from_json(cls, text: str) -> "PCGraph":
        """Inverse of :meth:`to_json`: params dataclasses are rebuilt from
        the op registry, enum and tuple fields coerced from their field
        types."""
        from ..ops.base import get_op_def

        d = json.loads(text)
        g = cls()
        for nd in d["nodes"]:
            op_type = OpType(nd["op_type"])
            params_cls = get_op_def(op_type).params_cls
            raw = nd["params"] or {}
            kwargs = {f.name: _coerce_field(f.type, raw[f.name])
                      for f in dataclasses.fields(params_cls) if f.name in raw}
            g.add_node(Node(nd["guid"], op_type, params_cls(**kwargs), nd.get("name", "")))
        for e in d["edges"]:
            g.add_edge(e["src"], e["dst"], e.get("src_idx", 0), e.get("dst_idx", 0))
        return g


def _coerce_field(field_type, value):
    """A params field from its JSON form by the dataclass's type hint:
    enums from their values, tuples from lists, everything else as it
    is."""
    if isinstance(field_type, str):
        # the ops modules use `from __future__ import annotations`: resolve
        # the string against the core.types namespace
        from . import types as _types

        field_type = getattr(_types, field_type, None) or {
            "int": int, "float": float, "str": str, "bool": bool, "tuple": tuple
        }.get(field_type, None)
    if isinstance(field_type, type) and issubclass(field_type, enum.Enum):
        return field_type(value)
    if isinstance(value, list):
        return tuple(tuple(v) if isinstance(v, list) else v for v in value)
    return value


def _jsonable(x):
    if isinstance(x, dict):
        return {k: _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, enum.Enum):
        return x.value
    if isinstance(x, (int, float, str, bool)) or x is None:
        return x
    return str(x)
