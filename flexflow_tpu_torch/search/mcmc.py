"""MCMC strategy search (legacy MLSys'19 path) (port of
``flexflow_tpu/search/mcmc.py``).

Reference: FFModel::mcmc_optimize (src/runtime/model.cc:3704-3775) —
simulated annealing over per-op ParallelConfigs: start from data-parallel,
propose ``rewrite`` (random op -> random valid config, model.cc:3679),
score with the event-driven simulator (simulate_runtime), Metropolis
accept (model.cc:3736-3749). Entry: Simulator::strategy_search_task
(simulator.h:860), run under --budget with --import/--export strategies.

Round-3 adds the reference's FF_USE_PROPAGATE behaviors (model.cc:3599):
  * proposal propagation — a proposed view spreads to adjacent ops with
    decaying probability, so proposals move coherent regions instead of
    fragmenting the graph into reshard boundaries;
  * delta costing — the additive decomposition (per-op time + per-edge
    reshard + per-weight sync) updates in O(degree) per proposal instead
    of replaying the whole task graph; the Metropolis walk runs on it and
    the winner is re-scored with the full event-driven simulator.
"""
from __future__ import annotations

import math
import random
from typing import Dict, List, Optional, Tuple

from ..core.graph import PCGraph
from ..core.types import OpType, PARALLEL_OP_TYPES
from ..ops.base import get_op_def
from ..parallel.machine import MachineSpec, MachineView
from ..parallel.propagation import infer_all_specs
from .dp_search import MachineResource, SearchHelper
from .simulator import Simulator


class _DeltaCost:
    """Additive strategy cost with O(degree) updates (the incremental
    half of FF_USE_PROPAGATE): total = Σ node(view) + Σ edge(src view,
    dst view) + implicit weight sync inside node()."""

    def __init__(self, graph: PCGraph, helper: SearchHelper, specs):
        self.graph = graph
        self.helper = helper
        self.specs = specs
        self._node: Dict[int, float] = {}
        # keyed (src, src_idx, dst, dst_idx): one tensor can feed the
        # same consumer several times (self-attention's q=k=v)
        self._edge: Dict[Tuple[int, int, int, int], float] = {}
        self.total = 0.0

    def _node_time(self, guid: int, view: MachineView) -> float:
        node = self.graph.nodes[guid]
        if node.op_type in (OpType.INPUT, OpType.WEIGHT, OpType.NOOP):
            return 0.0
        t, _ = self.helper.node_cost(self.graph, self.specs, node, view)
        return t

    def _edge_time(self, src: int, src_idx: int, dst: int, views) -> float:
        va, vb = views.get(src), views.get(dst)
        if va is None or vb is None or va == vb:
            return 0.0
        nbytes = self.specs["out"][src][src_idx].size_bytes
        return self.helper.cost_model.xfer_time(
            OpType.FUSED_PARALLEL, nbytes, max(va.num_parts, vb.num_parts)
        )

    def rebuild(self, views: Dict[int, MachineView]) -> float:
        self._node.clear()
        self._edge.clear()
        self.total = 0.0
        for guid, v in views.items():
            t = self._node_time(guid, v)
            self._node[guid] = t
            self.total += t
        for node in self.graph.topo_order():
            for e in self.graph.in_edges(node):
                t = self._edge_time(e.src, e.src_idx, e.dst, views)
                self._edge[(e.src, e.src_idx, e.dst, e.dst_idx)] = t
                self.total += t
        return self.total

    def apply(self, changed: List[int], views: Dict[int, MachineView]) -> float:
        """Re-cost only the changed ops and their incident edges."""
        touched_edges = set()
        for guid in changed:
            old = self._node.get(guid, 0.0)
            new = self._node_time(guid, views[guid])
            self._node[guid] = new
            self.total += new - old
            for e in self.graph.in_edges(guid):
                touched_edges.add((e.src, e.src_idx, e.dst, e.dst_idx))
            for e in self.graph.out_edges(guid):
                touched_edges.add((e.src, e.src_idx, e.dst, e.dst_idx))
        for key in touched_edges:
            src, src_idx, dst, _dst_idx = key
            old = self._edge.get(key, 0.0)
            new = self._edge_time(src, src_idx, dst, views)
            self._edge[key] = new
            self.total += new - old
        return self.total


def mcmc_optimize(
    graph: PCGraph,
    machine: Optional[MachineSpec] = None,
    budget: int = 200,
    alpha: float = 0.05,
    seed: int = 0,
    simulator: Optional[Simulator] = None,
    init_views: Optional[Dict[int, MachineView]] = None,
    propagate: bool = False,
    propagate_decay: float = 0.5,
) -> Tuple[Dict[int, MachineView], float]:
    """Returns (best views, best simulated step time).

    ``alpha`` is the Metropolis temperature scale (reference uses
    exp(-alpha * delta) acceptance, model.cc:3741). ``propagate=True``
    enables the FF_USE_PROPAGATE behaviors: proposals spread to
    neighboring ops with probability ``propagate_decay`` per hop and the
    walk runs on the O(degree)-update delta cost; the returned best time
    is always a full event-driven re-simulation of the winner.
    """
    machine = machine or MachineSpec()
    sim = simulator or Simulator(machine)
    helper = SearchHelper(machine, sim.cost_model, sim)
    rng = random.Random(seed)
    resource = MachineResource(0, machine.num_devices)

    # start from data parallel over all devices (reference: model.cc:3712)
    full = MachineView(0, (machine.num_devices,), (1,))
    views: Dict[int, MachineView] = init_views or {n.guid: full for n in graph.nodes.values()}
    candidates = helper.candidate_views(resource)
    movable = [
        n.guid
        for n in graph.nodes.values()
        if n.op_type not in (OpType.INPUT, OpType.WEIGHT)
    ]

    if propagate:
        from .dp_search import build_cost_specs

        delta = _DeltaCost(graph, helper, build_cost_specs(graph))
        current = best = delta.rebuild(views)
        best_views = dict(views)
        for it in range(budget):
            if not movable:
                break
            guid = rng.choice(movable)
            new = rng.choice(candidates)
            # spread the proposal along edges with decaying probability
            # (reference: FFModel::propagate, model.cc:3599)
            changed: List[int] = []
            saved: Dict[int, Optional[MachineView]] = {}
            frontier = [guid]
            p = 1.0
            seen = set()
            while frontier:
                nxt: List[int] = []
                for g in frontier:
                    if g in seen or g not in views:
                        continue
                    seen.add(g)
                    if views.get(g) == new:
                        continue
                    saved[g] = views.get(g)
                    views[g] = new
                    changed.append(g)
                    if rng.random() < propagate_decay * p:
                        for e in graph.in_edges(g):
                            if graph.nodes[e.src].op_type not in (OpType.INPUT, OpType.WEIGHT):
                                nxt.append(e.src)
                        for e in graph.out_edges(g):
                            nxt.append(e.dst)
                frontier = nxt
                p *= propagate_decay
            if not changed:
                continue
            c = delta.apply(changed, views)
            d = c - current
            if d < 0 or rng.random() < math.exp(-d / max(1e-12, alpha * max(current, 1e-9))):
                current = c
                if c < best:
                    best = c
                    best_views = dict(views)
            else:  # revert
                for g, old in saved.items():
                    if old is None:
                        views.pop(g, None)
                    else:
                        views[g] = old
                current = delta.apply(changed, views)
        # the additive model ranks proposals; the reported time comes from
        # the full event-driven simulator (reference: simulate_runtime)
        return best_views, sim.simulate(graph, best_views)

    def cost(v: Dict[int, MachineView]) -> float:
        return sim.simulate(graph, v)

    current = best = cost(views)
    best_views = dict(views)
    for it in range(budget):
        if not movable:
            break
        guid = rng.choice(movable)
        old = views.get(guid)
        new = rng.choice(candidates)
        if new == old:
            continue
        views[guid] = new
        c = cost(views)
        delta_c = c - current
        if delta_c < 0 or rng.random() < math.exp(-delta_c / max(1e-12, alpha * max(current, 1e-9))):
            current = c
            if c < best:
                best = c
                best_views = dict(views)
        else:
            if old is None:
                views.pop(guid, None)
            else:
                views[guid] = old
    return best_views, best
