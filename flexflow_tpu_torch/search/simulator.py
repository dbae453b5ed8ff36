"""Execution simulators for strategy cost estimation (port of
``flexflow_tpu/search/simulator.py``).

Reference: src/runtime/simulator.cc —
  * event-driven task-graph simulation (simulate_runtime :856-1100):
    per-op-part fwd/bwd SimTasks with measured runtimes, comm tasks per
    path hop with message segmentation (add_task_dependencies_with_xfer
    :440-531), gradient-sync modeling with overlap vs bulk-sync;
  * the fork's LogicalTaskgraphBasedSimulator (simulator.h:917-1021):
    simulates at the logical p2p level, expands allreduces into
    ring / butterfly / double-binary-tree patterns (AllreduceHelper
    simulator.h:614-651, generators simulator.cc:2870+) and picks a
    per-parameter schedule (simulation_with_allreduce_optimize :1721).

The task structures are flat arrays-of-records so the hot loop runs in
the native library (``flexflow_tpu_torch/_native``, built from the
repo's ``native/`` sources) when it is loaded; the Python replay below
is the fallback (``FF_NATIVE_DISABLE=1``).
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Dict, List, Optional, Sequence, Tuple

from ..core.graph import PCGraph
from ..core.types import OpType, PARALLEL_OP_TYPES, ParameterSyncOption
from ..ops.base import get_op_def
from ..parallel.machine import MachineSpec, MachineView
from ..parallel.propagation import infer_all_specs
from .cost_model import CostModel
from .machine_model import MachineModel, NetworkedMachineModel, SimpleMachineModel

TASK_FORWARD = 0
TASK_BACKWARD = 1
TASK_COMM = 2
TASK_UPDATE = 3
TASK_ALLREDUCE = 4


@dataclasses.dataclass
class SimTask:
    """One simulated task (reference: SimTask simulator.h:714-760)."""

    kind: int
    device: int  # device id, or -1 for a pure comm edge
    run_time: float
    name: str = ""
    ready_time: float = 0.0
    next_tasks: List[int] = dataclasses.field(default_factory=list)
    counter: int = 0  # unsatisfied deps


class TaskManager:
    """Task arena (reference: TaskManager simulator.h:780-800)."""

    def __init__(self):
        self.tasks: List[SimTask] = []

    def new_task(self, kind: int, device: int, run_time: float, name: str = "") -> int:
        self.tasks.append(SimTask(kind, device, run_time, name))
        return len(self.tasks) - 1

    def add_dep(self, src: int, dst: int):
        self.tasks[src].next_tasks.append(dst)
        self.tasks[dst].counter += 1


_native_sim = None  # cached: function, or False after a failed import —
# a failed package import is NOT cached by Python, so retrying it every
# call would re-run the module (and its auto-build) in the search loop


def _get_native_sim():
    global _native_sim
    if _native_sim is None:
        try:
            from .._native import simulate_taskgraph as f

            _native_sim = f
        except Exception:
            _native_sim = False
    return _native_sim or None


# task-graph replays by the path that ran them: the native library or
# the Python loop below (its fallback)
REPLAYS: Dict[str, int] = {"native": 0, "python": 0}


def _simulate(tm: TaskManager) -> float:
    """Event-driven replay (reference: simulate_runtime simulator.cc:856):
    per-device serialization, dependency-ordered, returns makespan."""
    native = _get_native_sim()
    if native is not None:
        try:
            makespan = native(tm.tasks)
            REPLAYS["native"] += 1
            return makespan
        except ValueError:
            raise  # deadlock: same error contract as the Python path
        except Exception:
            pass
    REPLAYS["python"] += 1
    device_free: Dict[int, float] = {}
    ready: List[Tuple[float, int]] = []
    for i, t in enumerate(tm.tasks):
        if t.counter == 0:
            heapq.heappush(ready, (t.ready_time, i))
    finish_all = 0.0
    done = 0
    while ready:
        rt, i = heapq.heappop(ready)
        t = tm.tasks[i]
        start = max(rt, device_free.get(t.device, 0.0)) if t.device >= 0 else rt
        end = start + t.run_time
        if t.device >= 0:
            device_free[t.device] = end
        finish_all = max(finish_all, end)
        done += 1
        for j in t.next_tasks:
            nt = tm.tasks[j]
            nt.counter -= 1
            nt.ready_time = max(nt.ready_time, end)
            if nt.counter == 0:
                heapq.heappush(ready, (nt.ready_time, j))
    if done != len(tm.tasks):
        raise ValueError(f"task graph deadlock: {done}/{len(tm.tasks)} ran")
    return finish_all


class Simulator:
    """Full-strategy simulator: PCG + per-op MachineViews -> est. step time.

    Reference: Simulator (simulator.h:823-910). Differences: op run times
    come from the analytic/calibrated CostModel; comm times from the
    MachineModel; XLA-style fusion is approximated by charging the
    per-task overhead once per fusion group of adjacent elementwise ops.
    """

    def __init__(
        self,
        machine: Optional[MachineSpec] = None,
        cost_model: Optional[CostModel] = None,
        machine_model: Optional[MachineModel] = None,
        segment_size: int = 16 * 1024 * 1024,
        max_num_segments: int = 1,
    ):
        self.machine = machine or MachineSpec()
        self.cost_model = cost_model or CostModel(self.machine)
        self.machine_model = machine_model or SimpleMachineModel(self.machine)
        self.segment_size = segment_size
        self.max_num_segments = max_num_segments

    # ------------------------------------------------------------ build
    def build_taskgraph(
        self,
        graph: PCGraph,
        views: Dict[int, MachineView],
        overlap_backward_update: bool = False,
        sync_options: Optional[Dict[int, ParameterSyncOption]] = None,
    ) -> TaskManager:
        """Build fwd+bwd+sync task graph (reference: the task-construction
        half of simulate_runtime, simulator.cc:862-1010)."""
        specs = infer_all_specs(graph)
        tm = TaskManager()
        order = graph.topo_order()
        fwd_ids: Dict[Tuple[int, int], int] = {}  # (guid, part) -> task
        bwd_ids: Dict[Tuple[int, int], int] = {}
        default_view = MachineView.all_devices(1)
        # forward tasks
        for node in order:
            view = views.get(node.guid, default_view)
            parts = view.num_parts
            devs = view.device_ids()
            in_specs = [specs[e.src][e.src_idx] for e in graph.in_edges(node)]
            out_specs = specs[node.guid]
            if node.op_type in PARALLEL_OP_TYPES:
                # resharding: modeled as comm, zero compute
                cm = None
                fwd_t = bwd_t = 0.0
            else:
                cm = self.cost_model.op_cost_metrics(
                    node.op_type, node.params, in_specs, out_specs, parts
                )
                fwd_t, bwd_t = cm.forward_time, cm.backward_time
            for p in range(parts):
                fwd_ids[(node.guid, p)] = tm.new_task(
                    TASK_FORWARD, devs[p], fwd_t, f"fwd:{node.guid}:{p}"
                )
            for p in range(parts):
                bwd_ids[(node.guid, p)] = tm.new_task(
                    TASK_BACKWARD, devs[p], bwd_t, f"bwd:{node.guid}:{p}"
                )
        # data deps + comm
        for node in order:
            view = views.get(node.guid, default_view)
            for e in graph.in_edges(node):
                src_node = graph.nodes[e.src]
                src_view = views.get(e.src, default_view)
                tensor_bytes = specs[e.src][e.src_idx].size_bytes
                self._connect(
                    tm,
                    fwd_ids,
                    e.src,
                    src_view,
                    node.guid,
                    view,
                    tensor_bytes,
                    forward=True,
                )
                # reverse edge for backward
                self._connect(
                    tm,
                    bwd_ids,
                    node.guid,
                    view,
                    e.src,
                    src_view,
                    tensor_bytes,
                    forward=True,
                )
        # fwd -> bwd seam: every bwd task waits for all fwd tasks of its op's
        # consumers (approx: last fwd overall gates first bwd of sink ops)
        sinks = graph.sink_nodes()
        for s in sinks:
            sview = views.get(s.guid, default_view)
            for p in range(sview.num_parts):
                tm.add_dep(fwd_ids[(s.guid, p)], bwd_ids[(s.guid, p)])
        # gradient sync + update per weighted op (reference: nccl_update_task)
        for node in order:
            if node.op_type in PARALLEL_OP_TYPES:
                continue
            view = views.get(node.guid, default_view)
            in_specs = [specs[e.src][e.src_idx] for e in graph.in_edges(node)]
            op_def = get_op_def(node.op_type)
            try:
                wspecs = op_def.weight_specs(node.params, in_specs)
            except Exception:
                wspecs = []
            if not wspecs:
                continue
            n_replicas = view.num_parts
            opt = (sync_options or {}).get(node.guid, ParameterSyncOption.DEFAULT)
            wbytes = sum(w.spec.size_bytes for w in wspecs)
            sync_t = self.cost_model.grad_sync_time(wbytes, view, n_replicas, opt)
            devs = view.device_ids()
            for p in range(n_replicas):
                upd = tm.new_task(
                    TASK_ALLREDUCE, devs[p], sync_t, f"sync:{node.guid}:{p}"
                )
                tm.add_dep(bwd_ids[(node.guid, p)], upd)
        return tm

    def _connect(
        self,
        tm: TaskManager,
        ids: Dict[Tuple[int, int], int],
        src_guid: int,
        src_view: MachineView,
        dst_guid: int,
        dst_view: MachineView,
        tensor_bytes: float,
        forward: bool,
    ):
        """Dependencies between op parts, inserting comm tasks when data
        crosses devices (reference: add_task_dependencies_with_xfer
        simulator.cc:440-531, incl. message segmentation)."""
        sp, dp = src_view.num_parts, dst_view.num_parts
        sdevs, ddevs = src_view.device_ids(), dst_view.device_ids()
        for d in range(dp):
            # which source parts feed dst part d: contiguous block mapping
            lo = d * sp // dp
            hi = max(lo + 1, (d + 1) * sp // dp)
            for s in range(lo, hi):
                a, b = ids[(src_guid, s)], ids[(dst_guid, d)]
                if sdevs[s % len(sdevs)] == ddevs[d % len(ddevs)]:
                    tm.add_dep(a, b)
                    continue
                nbytes = tensor_bytes / max(sp, dp)
                nseg = min(self.max_num_segments, max(1, math.ceil(nbytes / self.segment_size)))
                seg_bytes = nbytes / nseg
                t = self.machine_model.comm_time(
                    sdevs[s % len(sdevs)], ddevs[d % len(ddevs)], seg_bytes
                )
                prev = a
                for k in range(nseg):
                    c = tm.new_task(TASK_COMM, -1, t, f"comm:{src_guid}->{dst_guid}:{k}")
                    tm.add_dep(prev, c)
                    prev = c
                tm.add_dep(prev, b)

    # -------------------------------------------------------------- run
    def simulate(
        self,
        graph: PCGraph,
        views: Dict[int, MachineView],
        sync_options: Optional[Dict[int, ParameterSyncOption]] = None,
    ) -> float:
        tm = self.build_taskgraph(graph, views, sync_options=sync_options)
        return _simulate(tm)

    def export_taskgraph_dot(self, tm: TaskManager) -> str:
        """DOT export (reference: --taskgraph, simulator.cc:1066-1095)."""
        kinds = {0: "F", 1: "B", 2: "C", 3: "U", 4: "AR"}
        lines = ["digraph taskgraph {"]
        for i, t in enumerate(tm.tasks):
            lines.append(
                f'  t{i} [label="{kinds.get(t.kind, "?")} {t.name}\\n{t.run_time*1e6:.1f}us d{t.device}"];'
            )
            for j in t.next_tasks:
                lines.append(f"  t{i} -> t{j};")
        lines.append("}")
        return "\n".join(lines)


# --------------------------------------------------------------------------
# fork: logical task graph + allreduce schedule optimization
# --------------------------------------------------------------------------


class AllreduceHelper:
    """Expand an allreduce over n participants into p2p transfer rounds
    (reference: AllreduceHelper simulator.h:614-651, pattern generators
    simulator.cc:2870+). Each round is a list of (src, dst, bytes)."""

    @staticmethod
    def ring(participants: Sequence[int], nbytes: float) -> List[List[Tuple[int, int, float]]]:
        n = len(participants)
        if n <= 1:
            return []
        chunk = nbytes / n
        rounds = []
        for _ in range(2 * (n - 1)):  # reduce-scatter + all-gather
            rounds.append(
                [
                    (participants[i], participants[(i + 1) % n], chunk)
                    for i in range(n)
                ]
            )
        return rounds

    @staticmethod
    def butterfly(participants: Sequence[int], nbytes: float) -> List[List[Tuple[int, int, float]]]:
        n = len(participants)
        if n <= 1:
            return []
        rounds = []
        steps = max(1, int(math.ceil(math.log2(n))))
        # recursive halving (reduce-scatter) then doubling (allgather)
        size = nbytes
        for k in range(steps):
            dist = 1 << k
            rounds.append(
                [
                    (participants[i], participants[i ^ dist], size / 2)
                    for i in range(n)
                    if (i ^ dist) < n
                ]
            )
            size /= 2
        for k in reversed(range(steps)):
            dist = 1 << k
            size *= 2
            rounds.append(
                [
                    (participants[i], participants[i ^ dist], size / 2)
                    for i in range(n)
                    if (i ^ dist) < n
                ]
            )
        return rounds

    @staticmethod
    def double_binary_tree(participants: Sequence[int], nbytes: float) -> List[List[Tuple[int, int, float]]]:
        n = len(participants)
        if n <= 1:
            return []
        # two complementary binary trees, each carrying half the bytes;
        # reduce up + broadcast down
        half = nbytes / 2
        rounds: List[List[Tuple[int, int, float]]] = []

        def tree_rounds(order: List[int]):
            depth = max(1, int(math.ceil(math.log2(n))))
            up: List[List[Tuple[int, int, float]]] = []
            for lvl in range(depth):
                step = 1 << (lvl + 1)
                r = []
                for i in range(0, n, step):
                    j = i + (1 << lvl)
                    if j < n:
                        r.append((order[j], order[i], half))
                if r:
                    up.append(r)
            down = [[(d, s, b) for (s, d, b) in r] for r in reversed(up)]
            return up + down

        t1 = tree_rounds(list(participants))
        t2 = tree_rounds(list(reversed(participants)))
        for i in range(max(len(t1), len(t2))):
            r = []
            if i < len(t1):
                r += t1[i]
            if i < len(t2):
                r += t2[i]
            rounds.append(r)
        return rounds

    PATTERNS = {
        ParameterSyncOption.DEFAULT: "ring",
        ParameterSyncOption.RING: "ring",
        ParameterSyncOption.BUTTERFLY: "butterfly",
        ParameterSyncOption.DOUBLE_BINARY_TREE: "double_binary_tree",
    }

    @classmethod
    def expand(
        cls, option: ParameterSyncOption, participants: Sequence[int], nbytes: float
    ) -> List[List[Tuple[int, int, float]]]:
        return getattr(cls, cls.PATTERNS[option])(participants, nbytes)


class LogicalTaskgraphSimulator:
    """p2p-level simulation over a (possibly networked) machine model
    (reference: LogicalTaskgraphBasedSimulator simulator.h:917-1021,
    simulation_with_network simulator.cc:1507)."""

    def __init__(self, machine_model: MachineModel, cost_model: Optional[CostModel] = None):
        self.machine_model = machine_model
        self.cost_model = cost_model or CostModel()
        self._native_mm = None  # lazily-mirrored ffcore machine model

    def _native(self):
        if self._native_mm is None:
            try:
                from .._native import NativeMachineModel

                self._native_mm = NativeMachineModel.from_python(self.machine_model)
            except Exception:
                self._native_mm = False
        return self._native_mm or None

    def simulate_allreduce(
        self,
        option: ParameterSyncOption,
        participants: Sequence[int],
        nbytes: float,
    ) -> float:
        """Simulate one allreduce pattern as synchronized p2p rounds with
        congestion: transfers in a round sharing a physical link serialize."""
        nmm = self._native()
        if nmm is not None:
            return nmm.allreduce_time(
                list(participants), nbytes, AllreduceHelper.PATTERNS[option]
            )
        rounds = AllreduceHelper.expand(option, participants, nbytes)
        total = 0.0
        record = isinstance(self.machine_model, NetworkedMachineModel)
        for r in rounds:
            # per-link occupancy within the round
            link_load: Dict[Tuple[int, int], float] = {}
            round_t = 0.0
            for (s, d, b) in r:
                if record:
                    t = self.machine_model.comm_time(s, d, b, record=False)
                    sn = self.machine_model._node_of(s)
                    dn = self.machine_model._node_of(d)
                    routes = self.machine_model.get_routes(sn, dn) if sn != dn else []
                    cong = 1.0
                    for path in routes[:1]:
                        for u, v in zip(path, path[1:]):
                            link_load[(u, v)] = link_load.get((u, v), 0.0) + 1.0
                            cong = max(cong, link_load[(u, v)])
                    t *= cong
                else:
                    t = self.machine_model.comm_time(s, d, b)
                round_t = max(round_t, t)
            total += round_t
        return total

    def simulate_step(
        self,
        graph: PCGraph,
        views: Dict[int, MachineView],
        sync_options: Optional[Dict[int, ParameterSyncOption]] = None,
        simulator: Optional[Simulator] = None,
    ) -> float:
        """Full step: compute via the event-driven sim + per-parameter
        allreduce expansion at the logical level."""
        sim = simulator or Simulator(machine_model=self.machine_model, cost_model=self.cost_model)
        base = sim.simulate(graph, views)
        specs = infer_all_specs(graph)
        extra = 0.0
        for node in graph.topo_order():
            if node.op_type in PARALLEL_OP_TYPES:
                continue
            view = views.get(node.guid)
            if view is None or view.num_parts <= 1:
                continue
            in_specs = [specs[e.src][e.src_idx] for e in graph.in_edges(node)]
            try:
                wspecs = get_op_def(node.op_type).weight_specs(node.params, in_specs)
            except Exception:
                continue
            if not wspecs:
                continue
            wbytes = sum(w.spec.size_bytes for w in wspecs)
            opt = (sync_options or {}).get(node.guid, ParameterSyncOption.DEFAULT)
            analytic = self.cost_model.allreduce_time(wbytes, view.num_parts, opt)
            detailed = self.simulate_allreduce(opt, view.device_ids(), wbytes)
            extra += max(0.0, detailed - analytic)
        return base + extra


def predict_strategy_time(
    graph: PCGraph,
    strategy,
    machine: Optional[MachineSpec] = None,
    calibration=None,
    cost_model: Optional[CostModel] = None,
    ledger_key: Optional[str] = None,
) -> float:
    """Strategy-level step-time predictor: walk the PCG with a
    ParallelStrategy (mesh axis sizes + PartitionSpecs) and charge
    GSPMD-style per-shard compute plus the collectives the shardings
    imply. This is the piece that lets the bench rank dp vs tp vs hybrid
    strategies by simulated cost and compare against measured rank order
    (reference premise: simulated cost predicts real cost, graph.cc:1586).

    Charging rules (scaling-book style):
      * compute: roofline of (flops, bytes) / prod(axis sizes sharding
        this op's outputs or weights), fwd + 2x bwd for matmul ops;
      * gradient sync: per weight, ring allreduce of the weight's shard
        bytes over the product of axes that shard the op's activations
        but not the weight (the data-parallel replica group);
      * tensor-parallel activation collective: a weight sharded on a mesh
        axis that does NOT appear in the op's output spec contracts over
        a sharded dimension -> partial sums -> allreduce of the output
        shard over that axis, charged fwd + bwd (Megatron's 2
        allreduces/block per direction).
    """
    machine = machine or MachineSpec()
    cm = cost_model or CostModel(machine, calibration=calibration)
    specs = infer_all_specs(graph)
    axis = {k: v for k, v in strategy.axis_sizes.items() if v > 1}
    total = 0.0
    # gradient syncs are OFF the critical path and fusable: XLA combines
    # the per-weight allreduces of one replica group into few launches,
    # so the per-invocation rendezvous constant is charged once per
    # distinct group (activation psums stay per-invocation — each sits
    # between two dependent ops and cannot fuse away)
    grad_sync_groups: set = set()
    for node in graph.topo_order():
        if node.op_type in (OpType.INPUT, OpType.WEIGHT, OpType.NOOP):
            continue
        if node.op_type in PARALLEL_OP_TYPES:
            continue
        out_specs = specs[node.guid]
        in_specs = [specs[e.src][e.src_idx] for e in graph.in_edges(node)]
        op_def = get_op_def(node.op_type)
        sh = strategy.node_shardings.get(node.guid)

        def spec_axes(spec) -> set:
            out = set()
            for entry in spec or ():
                out.update(entry)
            return out

        out_axes: set = set()
        weight_axes: Dict[str, set] = {}
        if sh is not None:
            for o in sh.outputs or []:
                out_axes |= spec_axes(o)
            for wname, wspec in (sh.weights or {}).items():
                weight_axes[wname] = spec_axes(wspec)
        all_axes = set().union(out_axes, *weight_axes.values()) if weight_axes else set(out_axes)
        parts = 1
        for a in all_axes:
            parts *= axis.get(a, 1)
        # op_cost_metrics carries the measured-entry override, derates,
        # backward factor and the per-signature cache
        metrics = cm.op_cost_metrics(node.op_type, node.params, in_specs, out_specs, parts)
        total += metrics.forward_time + metrics.backward_time

        try:
            wspecs = op_def.weight_specs(node.params, in_specs)
        except Exception:
            wspecs = []
        out_shard = 1
        for a in out_axes:
            out_shard *= axis.get(a, 1)
        out_bytes = (out_specs[0].size_bytes / max(1, out_shard)) if out_specs else 0.0
        partial_axes: set = set()
        for w in wspecs:
            waxes = weight_axes.get(w.name, set())
            w_shard = 1
            for a in waxes:
                w_shard *= axis.get(a, 1)
            # data-parallel replica group: axes sharding activations but
            # not this weight (reference: nccl allreduce per weight view)
            replicas = 1
            for a in out_axes - waxes:
                replicas *= axis.get(a, 1)
            if replicas > 1:
                total += cm.allreduce_time(
                    w.spec.size_bytes / w_shard, replicas, include_overhead=False
                )
                # key fused launches by the AXES forming the replica
                # group: two equal-sized groups over different axes are
                # distinct launches
                grad_sync_groups.add(frozenset(out_axes - waxes))
            partial_axes |= waxes - out_axes
        # contraction over a sharded dim -> partial-sum allreduce of the
        # output, forward and backward; once per node per axis (a
        # head-parallel attention has 4 sharded weights but ONE allreduce)
        for a in partial_axes:
            n = axis.get(a, 1)
            if n > 1 and out_bytes > 0:
                # a psum over one mesh axis runs n_total/n independent
                # group instances; the virtual CPU mesh serializes their
                # rendezvous (groups multiplier is a no-op when
                # coll_overhead is 0, i.e. on real chips)
                n_total = 1
                for v in axis.values():
                    n_total *= v
                total += 2.0 * cm.allreduce_time(
                    out_bytes, n, groups=max(1, n_total // n)
                )
    total += cm.chip.coll_overhead * len(grad_sync_groups)
    if ledger_key is not None:
        # predict side of the truth ledger: the whole-step estimate,
        # keyed to the executor program that will run this strategy so
        # its measured train windows grade the simulator end to end
        # (obs/truth.py; the per-op predictions above registered via
        # the cost model already)
        from ..obs.truth import GLOBAL_LEDGER

        cal = cm.calibration
        GLOBAL_LEDGER.predict(
            ledger_key,
            total,
            label=f"{ledger_key} (strategy step)",
            provenance=(
                f"predict_strategy_time over calibration "
                f"'{cal.device_kind}' ({getattr(cal, 'source', '(in-memory)')})"
            ),
            # an analytic (uncalibrated) step estimate records pairs for
            # inspection but cannot raise a "calibration drift" alarm —
            # there is no calibration table to be stale
            alarm=cal.device_kind != "analytic",
        )
    return total


def allreduce_optimize(
    graph: PCGraph,
    views: Dict[int, MachineView],
    machine_model: MachineModel,
    cost_model: Optional[CostModel] = None,
) -> Tuple[Dict[int, ParameterSyncOption], float]:
    """Choose the best allreduce schedule per parameter (fork:
    ALLREDUCE_OPTIMIZE task, model.cc:3872-3922 allreduce_optimize;
    simulation_with_allreduce_optimize simulator.cc:1721).

    Returns ({node guid -> option}, saved_seconds_vs_default).
    """
    lsim = LogicalTaskgraphSimulator(machine_model, cost_model)
    specs = infer_all_specs(graph)
    choices: Dict[int, ParameterSyncOption] = {}
    saved = 0.0
    for node in graph.topo_order():
        if node.op_type in PARALLEL_OP_TYPES:
            continue
        view = views.get(node.guid)
        if view is None or view.num_parts <= 1:
            continue
        in_specs = [specs[e.src][e.src_idx] for e in graph.in_edges(node)]
        try:
            wspecs = get_op_def(node.op_type).weight_specs(node.params, in_specs)
        except Exception:
            continue
        if not wspecs:
            continue
        wbytes = sum(w.spec.size_bytes for w in wspecs)
        participants = view.device_ids()
        times = {
            opt: lsim.simulate_allreduce(opt, participants, wbytes)
            for opt in (
                ParameterSyncOption.RING,
                ParameterSyncOption.BUTTERFLY,
                ParameterSyncOption.DOUBLE_BINARY_TREE,
            )
        }
        best = min(times, key=times.get)
        default_t = times[ParameterSyncOption.RING]
        choices[node.guid] = best
        saved += max(0.0, default_t - times[best])
    return choices, saved
