"""Parallel computation graph (port of the construction and query parts
of ``flexflow_tpu/core/graph.py``; serialization, DOT export and the
subgraph algorithms the search uses wait for the search slice).

Nodes are operator instances (OpType + frozen, hashable param record);
edges carry (src output index, dst input index).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, List

from .types import OpType


@dataclasses.dataclass(frozen=True)
class Node:
    """One operator instance in the PCG (reference: graph.h Node — Op* + guid)."""

    guid: int
    op_type: OpType
    params: Any  # frozen dataclass from ops/<op>.py; hashable
    name: str = ""

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

    def in_edges(self, n: Node | int) -> List[Edge]:
        g = n.guid if isinstance(n, Node) else n
        return sorted(self._in_edges.get(g, []), key=lambda e: e.dst_idx)

    def sink_nodes(self) -> List[Node]:
        return [self.nodes[g] for g in self.nodes if not self._out_edges[g]]

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
