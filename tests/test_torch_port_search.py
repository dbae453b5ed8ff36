"""The Unity search through the port against the JAX package on the CPU:
cost model, machine models and routes, simulators and allreduce
patterns, substitutions and ``base_optimize``, the DP view search,
MCMC, ``unity_optimize``, and the calibration layer with its chip specs.

Both packages run the same host arithmetic in the same order over the
same graph JSON (guids kept; each package's guid counter set to one
value before a search, so the nodes a rewrite creates match), and the
same native library sources, so every number is held at rel 1e-12 and
most are equal outright; ``unity_optimize`` gives the same strategy
(compared by layer name), ``best_cost`` within rel 1e-9 and the same
candidate count. The JAX searches are computed once per module. Without
a card both packages search for the reference preset chip
(``TPUChipSpec()``); the card's spec is ``chip_spec_for`` of its name.
"""
import dataclasses
import itertools
import json
import math
import os

import pytest

from flexflow_tpu.config import FFConfig as JFFConfig
from flexflow_tpu.core.graph import PCGraph as JPCGraph
from flexflow_tpu.core.types import ParameterSyncOption as JSync
from flexflow_tpu.models.transformer import TransformerConfig as JTransformerConfig
from flexflow_tpu.models.transformer import build_transformer as jbuild_transformer
from flexflow_tpu.obs.truth import PredictionLedger as JLedger
from flexflow_tpu.parallel.machine import MachineSpec as JMachineSpec
from flexflow_tpu.parallel.machine import MachineView as JMachineView
from flexflow_tpu.parallel.strategy import megatron_strategy as jmegatron
from flexflow_tpu.search import calibration as jcal
from flexflow_tpu.search import cost_model as jcm
from flexflow_tpu.search import dp_search as jdp
from flexflow_tpu.search import machine_model as jmm
from flexflow_tpu.search import mcmc as jmcmc
from flexflow_tpu.search import simulator as jsim
from flexflow_tpu.search import substitution as jsub
from flexflow_tpu.search import unity as junity
from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.core.graph import PCGraph
from flexflow_tpu_torch.core.types import DataType, OpType, ParameterSyncOption
from flexflow_tpu_torch.obs.truth import PredictionLedger
from flexflow_tpu_torch.parallel.machine import MachineSpec, MachineView, TPUChipSpec
from flexflow_tpu_torch.parallel.strategy import megatron_strategy
from flexflow_tpu_torch.search import calibration as tcal
from flexflow_tpu_torch.search import cost_model as tcm
from flexflow_tpu_torch.search import dp_search as tdp
from flexflow_tpu_torch.search import machine_model as tmm
from flexflow_tpu_torch.search import mcmc as tmcmc
from flexflow_tpu_torch.search import simulator as tsim
from flexflow_tpu_torch.search import substitution as tsub
from flexflow_tpu_torch.search import unity as tunity

pytestmark = pytest.mark.torch_port

SMALL = dict(num_layers=2, hidden_size=64, num_heads=4, ff_size=128, seq_length=16)
WIDE = dict(num_layers=2, hidden_size=128, num_heads=4, ff_size=256, seq_length=32)


def graphs_of(jm):
    text = jm.graph.to_json()
    return JPCGraph.from_json(text), PCGraph.from_json(text)


def align_counters(start=None) -> int:
    """Both packages' guid counters at ``start`` (default: above every
    guid either has handed out), which it returns: run before each
    package's search with one start, the nodes a search creates get the
    same guids in both and collide with no graph built earlier."""
    if start is None:
        start = max(next(JPCGraph._guid_counter), next(PCGraph._guid_counter)) + 1000
    JPCGraph._guid_counter = itertools.count(start)
    PCGraph._guid_counter = itertools.count(start)
    return start


def close(a, b, rel=1e-12):
    return a == b or abs(a - b) <= rel * max(abs(a), abs(b))


def views_of(views):
    return {g: dataclasses.astuple(v) for g, v in views.items()}


def by_name(st):
    return ({k: v for k, v in st.axis_sizes.items()},
            {st.node_names.get(g, str(g)): (sh.outputs, sh.weights, sh.machine_view,
                                           sh.machine_view_hash)
             for g, sh in st.node_shardings.items()})


@pytest.fixture(scope="module")
def small():
    return graphs_of(jbuild_transformer(JFFConfig(batch_size=32), JTransformerConfig(**SMALL)))


@pytest.fixture(scope="module")
def wide():
    return graphs_of(jbuild_transformer(JFFConfig(batch_size=64), JTransformerConfig(**WIDE)))


# ------------------------------------------------------------ cost model
CHIPS = ("v5p", "cpu", "TPU v5 lite x4")


@pytest.mark.parametrize("chip", CHIPS)
def test_cost_model_equals_jax(small, chip):
    jg, tg = small
    jm = JMachineSpec(2, 4, jcal.chip_spec_for(chip))
    tm = MachineSpec(2, 4, tcal.chip_spec_for(chip))
    assert dataclasses.asdict(tm) == dataclasses.asdict(jm)
    jc, tc = jcm.CostModel(jm, ledger=JLedger()), tcm.CostModel(tm, ledger=PredictionLedger())
    jspecs = jsim.infer_all_specs(jg)
    tspecs = tsim.infer_all_specs(tg)
    for node in tg.topo_order():
        if node.op_type in (OpType.INPUT, OpType.WEIGHT):
            continue
        jn = jg.nodes[node.guid]
        for parts in (1, 2, 8):
            a = jc.op_cost_metrics(jn.op_type, jn.params,
                                   [jspecs[e.src][e.src_idx] for e in jg.in_edges(jn)],
                                   jspecs[jn.guid], parts)
            b = tc.op_cost_metrics(node.op_type, node.params,
                                   [tspecs[e.src][e.src_idx] for e in tg.in_edges(node)],
                                   tspecs[node.guid], parts)
            for f in ("forward_time", "backward_time", "sync_time", "memory_requirement"):
                assert close(getattr(b, f), getattr(a, f)), (node, parts, f)
    for nbytes, n, intra, groups in itertools.product((0, 1e3, 3e7), (1, 2, 3, 8), (True, False),
                                                      (1, 4)):
        for opt in ParameterSyncOption:
            assert close(tc.allreduce_time(nbytes, n, opt, intra, groups=groups),
                         jc.allreduce_time(nbytes, n, JSync(opt.value), intra, groups=groups))
        assert close(tc.all_gather_time(nbytes, n, intra), jc.all_gather_time(nbytes, n, intra))
        assert close(tc.all_to_all_time(nbytes, n, intra), jc.all_to_all_time(nbytes, n, intra))
        assert close(tc.p2p_time(nbytes, intra), jc.p2p_time(nbytes, intra))
        for kind in ("repartition", "combine", "replicate", "reduction", "allreduce",
                     "fused_parallel", "linear"):
            assert close(tc.xfer_time(OpType(kind), nbytes, n, intra),
                         jc.xfer_time(type(jn.op_type)(kind), nbytes, n, intra))
    for view in ((0, (4,), (1,)), (2, (4,), (1,)), (0, (2, 2), (2, 1))):
        assert close(tc.grad_sync_time(5e6, MachineView(*view), 4),
                     jc.grad_sync_time(5e6, JMachineView(*view), 4))


# ---------------------------------------------------------- machine models
TOPOS = {
    "fully_connected": lambda m: m.NetworkTopology.fully_connected(4, devices_per_node=2),
    "big_switch": lambda m: m.NetworkTopology.big_switch(5, devices_per_node=2, uplinks=2),
    "fat_tree": lambda m: m.NetworkTopology.fat_tree(2, 3, devices_per_node=2),
    "torus": lambda m: m.NetworkTopology.torus((2, 3), devices_per_node=2),
    "flat_deg": lambda m: m.NetworkTopology.flat_deg_constraint(7, 3, devices_per_node=2, seed=3),
}


@pytest.mark.parametrize("topo", list(TOPOS))
def test_networked_models_and_routes_equal_jax(topo, tmp_path):
    jt, tt = TOPOS[topo](jmm), TOPOS[topo](tmm)
    assert dataclasses.asdict(tt) == dataclasses.asdict(jt)
    # topology files cross both ways
    tt.to_topo_file(str(tmp_path / "port.topo"))
    jt.to_topo_file(str(tmp_path / "jax.topo"))
    assert (tmp_path / "port.topo").read_text() == (tmp_path / "jax.topo").read_text()
    assert dataclasses.asdict(jmm.NetworkTopology.from_topo_file(str(tmp_path / "port.topo"))) == \
        dataclasses.asdict(tmm.NetworkTopology.from_topo_file(str(tmp_path / "jax.topo")))
    for routing in ("shortest", "weighted_shortest", "ecmp"):
        a = jmm.NetworkedMachineModel(jt, routing=routing)
        b = tmm.NetworkedMachineModel(tt, routing=routing)
        nd = b.num_devices()
        for s in range(nd):
            for d in range(0, nd, 2):
                assert b.comm_time(s, d, 1e6, record=True) == a.comm_time(s, d, 1e6, record=True)
                assert [dataclasses.astuple(c) for c in b.comm_path(s, d)] == [
                    dataclasses.astuple(c) for c in a.comm_path(s, d)]
        assert b.link_traffic == a.link_traffic
        for s in range(tt.num_nodes):
            for d in range(tt.num_nodes):
                if s != d:
                    assert b.get_routes(s, d) == a.get_routes(s, d)


def test_simple_enhanced_models_and_selection_equal_jax(tmp_path):
    cfg = tmp_path / "machine_config"
    cfg.write_text("num_nodes = 2\nnum_sockets_per_node = 2\nnum_gpus_per_socket = 2\n"
                   "membus_latency = 0.0001\nmembus_bandwidth = 100\nupi_latency = 0.0004\n"
                   "upi_bandwidth = 30\nnic_latency = 0.001\nnic_bandwidth = 12.5\n"
                   "nvlink_latency = 0.0002\nnvlink_bandwidth = 450\n"
                   "intra_socket_gpu_fb_mem_to_gpu_fb_mem = nvlink\n"
                   "inter_socket_gpu_fb_mem_to_gpu_fb_mem = pci_to_host upi pci_to_dev\n"
                   "inter_node_gpu_fb_mem_to_gpu_fb_mem = pci_to_host nic pci_to_dev\n")
    topo = tmp_path / "net.topo"
    tmm.NetworkTopology.fat_tree(2, 2, devices_per_node=2).to_topo_file(str(topo))
    for kw in ({}, {"version": 1, "machine_model_file": str(cfg)}, {"topo_file": str(topo)},
               {"topo_file": str(topo), "routing": "ecmp"}):
        a = jmm.build_machine_model(JMachineSpec(2, 4), **kw)
        b = tmm.build_machine_model(MachineSpec(2, 4), **kw)
        assert (type(b).__name__, b.version, b.num_devices()) == (
            type(a).__name__, a.version, a.num_devices())
        for s, d in itertools.product(range(b.num_devices()), repeat=2):
            assert b.comm_time(s, d, 3e6) == a.comm_time(s, d, 3e6)


# --------------------------------------------------------------- simulator
def test_simulators_and_allreduce_schedules_equal_jax(small):
    jg, tg = small
    jmach, tmach = JMachineSpec(2, 4), MachineSpec(2, 4)
    jsim_ = jsim.Simulator(jmach, jcm.CostModel(jmach, ledger=JLedger()))
    tsim_ = tsim.Simulator(tmach, tcm.CostModel(tmach, ledger=PredictionLedger()))
    for size, start in ((8, 0), (4, 4), (2, 2), (1, 0)):
        jv = {n.guid: JMachineView(start, (size,), (1,)) for n in jg.topo_order()}
        tv = {n.guid: MachineView(start, (size,), (1,)) for n in tg.topo_order()}
        assert close(tsim_.simulate(tg, tv), jsim_.simulate(jg, jv))
    jst, tst = jmegatron(jg, 2, 4), megatron_strategy(tg, 2, 4)
    assert close(tsim.predict_strategy_time(tg, tst, tmach),
                 jsim.predict_strategy_time(jg, jst, jmach))
    topo = (jmm.NetworkTopology.fat_tree(2, 2, devices_per_node=2),
            tmm.NetworkTopology.fat_tree(2, 2, devices_per_node=2))
    ja = jsim.LogicalTaskgraphSimulator(jmm.NetworkedMachineModel(topo[0]))
    ta = tsim.LogicalTaskgraphSimulator(tmm.NetworkedMachineModel(topo[1]))
    jp = jsim.LogicalTaskgraphSimulator(jmm.NetworkedMachineModel(topo[0]))
    tp = tsim.LogicalTaskgraphSimulator(tmm.NetworkedMachineModel(topo[1]))
    jp._native_mm = tp._native_mm = False  # the Python expansion in both
    for parts in ([0, 1, 2, 3], list(range(8)), [0, 3, 5]):
        for opt in ParameterSyncOption:
            jo = JSync(opt.value)
            assert tsim.AllreduceHelper.expand(opt, parts, 1e6) == jsim.AllreduceHelper.expand(
                jo, parts, 1e6)
            assert close(ta.simulate_allreduce(opt, parts, 4e7), ja.simulate_allreduce(jo, parts, 4e7))
            assert close(tp.simulate_allreduce(opt, parts, 4e7), jp.simulate_allreduce(jo, parts, 4e7))
    jviews = {n.guid: JMachineView(0, (8,), (1,)) for n in jg.topo_order()}
    tviews = {n.guid: MachineView(0, (8,), (1,)) for n in tg.topo_order()}
    jc, js = jsim.allreduce_optimize(jg, jviews, jmm.NetworkedMachineModel(topo[0]))
    tc, ts = tsim.allreduce_optimize(tg, tviews, tmm.NetworkedMachineModel(topo[1]))
    assert {g: o.value for g, o in tc.items()} == {g: o.value for g, o in jc.items()}
    assert close(ts, js)


# ------------------------------------------------------------ substitution
RULES = {"_t": "RuleCollection", "rule": [
    {"name": "partition_combine_noop", "srcOp": [
        {"type": "OP_PARTITION", "input": [{"opId": -1, "tsId": 0}],
         "para": [{"key": "PM_PARALLEL_DIM", "value": 0}, {"key": "PM_PARALLEL_DEGREE", "value": 2}]},
        {"type": "OP_COMBINE", "input": [{"opId": 0, "tsId": 0}],
         "para": [{"key": "PM_PARALLEL_DIM", "value": 0}, {"key": "PM_PARALLEL_DEGREE", "value": 2}]}],
     "dstOp": [{"type": "OP_NOOP", "input": [{"opId": -1, "tsId": 0}], "para": []}],
     "mappedOutput": [{"srcOpId": 1, "srcTsId": 0, "dstOpId": 0, "dstTsId": 0}]},
    {"name": "relu_linear_partition", "srcOp": [
        {"type": "OP_LINEAR", "input": [{"opId": -1, "tsId": 0}, {"opId": -2, "tsId": 0}],
         "para": [{"key": "PM_ACTI", "value": 0}]},
        {"type": "OP_RELU", "input": [{"opId": 0, "tsId": 0}], "para": []}],
     "dstOp": [
        {"type": "OP_PARTITION", "input": [{"opId": -1, "tsId": 0}],
         "para": [{"key": "PM_PARALLEL_DIM", "value": 1}, {"key": "PM_PARALLEL_DEGREE", "value": 2}]},
        {"type": "OP_LINEAR", "input": [{"opId": 0, "tsId": 0}, {"opId": -2, "tsId": 0}],
         "para": [{"key": "PM_ACTI", "value": 2}]},
        {"type": "OP_COMBINE", "input": [{"opId": 1, "tsId": 0}],
         "para": [{"key": "PM_PARALLEL_DIM", "value": 1}, {"key": "PM_PARALLEL_DEGREE", "value": 2}]}],
     "mappedOutput": [{"srcOpId": 1, "srcTsId": 0, "dstOpId": 2, "dstTsId": 0}]},
]}


def xfer_sig(x):
    def ops(lst):
        return [(o.op_type.value, [dataclasses.astuple(t) for t in o.inputs],
                 sorted((k, str(v)) for k, v in o.constraints.items()), o.reuse_src) for o in lst]
    return x.name, ops(x.src_ops), ops(x.dst_ops), sorted(x.mapped_outputs.items()), x.signature


def test_xfers_rewrites_and_base_optimize_equal_jax(small, tmp_path):
    jg, tg = small
    rules = tmp_path / "rules.json"
    rules.write_text(json.dumps(RULES))
    for degrees, pp, ap in (((2, 4, 8), True, False), ((2, 3, 6), False, True)):
        jx = jsub.generate_all_pcg_xfers(degrees, pp, ap)
        tx = tsub.generate_all_pcg_xfers(degrees, pp, ap)
        assert [xfer_sig(x) for x in tx] == [xfer_sig(x) for x in jx]
    jx = jsub.generate_all_pcg_xfers((2, 4)) + jsub.load_substitution_json(str(rules), (2, 4))
    tx = tsub.generate_all_pcg_xfers((2, 4)) + tsub.load_substitution_json(str(rules), (2, 4))
    assert [xfer_sig(x) for x in tx] == [xfer_sig(x) for x in jx]
    # every single rewrite of the graph, as JSON
    for a, b in zip(jx, tx):
        start = align_counters()
        want = [g.to_json() for g in a.run(jg)]
        align_counters(start)
        assert [g.to_json() for g in b.run(tg)] == want, a.name
    # best-first search scored by the DP
    jmach, tmach = JMachineSpec(1, 4), MachineSpec(1, 4)
    jh = jdp.SearchHelper(jmach, jcm.CostModel(jmach, ledger=JLedger()))
    th = tdp.SearchHelper(tmach, tcm.CostModel(tmach, ledger=PredictionLedger()))
    start = align_counters()
    jbest, jstats = jsub.base_optimize(jg, jx, lambda g: jh.optimal_cost(g).cost, budget=4)
    align_counters(start)
    tbest, tstats = tsub.base_optimize(tg, tx, lambda g: th.optimal_cost(g).cost, budget=4)
    assert tbest.to_json() == jbest.to_json()
    assert dataclasses.asdict(tstats) == dataclasses.asdict(jstats)
    assert tstats.candidates_explored > 0


def test_dp_views_and_mcmc_equal_jax(small):
    jg, tg = small
    for nodes, per, two_d in ((1, 8, False), (2, 4, False), (1, 8, True)):
        jmach, tmach = JMachineSpec(nodes, per), MachineSpec(nodes, per)
        jh = jdp.SearchHelper(jmach, jcm.CostModel(jmach, ledger=JLedger()), enable_2d_views=two_d)
        th = tdp.SearchHelper(tmach, tcm.CostModel(tmach, ledger=PredictionLedger()),
                              enable_2d_views=two_d)
        a, b = jh.optimal_cost(jg), th.optimal_cost(tg)
        assert close(b.cost, a.cost) and close(b.memory_per_device, a.memory_per_device)
        assert views_of(b.views) == views_of(a.views)
        assert [dataclasses.astuple(v) for v in th.candidate_views(tdp.MachineResource(0, per), 32)] \
            == [dataclasses.astuple(v) for v in jh.candidate_views(jdp.MachineResource(0, per), 32)]
    # the legacy simulated-annealing search under one seed
    jmach, tmach = JMachineSpec(1, 4), MachineSpec(1, 4)
    for propagate in (False, True):
        ja = jmcmc.mcmc_optimize(jg, jmach, budget=40, seed=3, propagate=propagate,
                                 simulator=jsim.Simulator(jmach, jcm.CostModel(jmach, ledger=JLedger())))
        ta = tmcmc.mcmc_optimize(tg, tmach, budget=40, seed=3, propagate=propagate,
                                 simulator=tsim.Simulator(tmach, tcm.CostModel(
                                     tmach, ledger=PredictionLedger())))
        assert close(ta[1], ja[1]) and views_of(ta[0]) == views_of(ja[0])


# ------------------------------------------------------------------- unity
@pytest.fixture(scope="module")
def searches(small, wide, tmp_path_factory):
    """unity_optimize in both packages: (1, 8) and (2, 4) on both graphs,
    and the knobs unity reads (allreduce schedules over a topology file,
    the memory search, the v1 machine model, attribute parallelism)."""
    d = tmp_path_factory.mktemp("unity")
    topo = d / "fat.topo"
    tmm.NetworkTopology.fat_tree(2, 2, devices_per_node=2).to_topo_file(str(topo))
    mcfg = d / "machine_config"
    mcfg.write_text("num_nodes = 2\nnum_gpus_per_socket = 4\nnvlink_latency = 0.0002\n"
                    "nvlink_bandwidth = 450\nnic_latency = 0.001\nnic_bandwidth = 12.5\n"
                    "inter_node_gpu_fb_mem_to_gpu_fb_mem = nic\n")
    cases = {
        "small 1x8": (small, 32, dict(search_num_workers=8)),
        "small 2x4": (small, 32, dict(search_num_nodes=2, search_num_workers=4)),
        "wide 1x8": (wide, 64, dict(search_num_workers=8)),
        "wide 2x4": (wide, 64, dict(search_num_nodes=2, search_num_workers=4)),
        "wide 2x4 knobs": (wide, 64, dict(search_num_nodes=2, search_num_workers=4,
                                          topo_file=str(topo), allreduce_optimize=True,
                                          memory_search=True, machine_model_version=1,
                                          machine_model_file=str(mcfg),
                                          enable_attribute_parallel=True)),
        "wide one device": (wide, 64, dict()),
    }
    out = {}
    for name, ((jg, tg), batch, kw) in cases.items():
        got, start = [], align_counters()
        for cls, fn, g in ((JFFConfig, junity.unity_optimize, jg),
                           (FFConfig, tunity.unity_optimize, tg)):
            align_counters(start)
            cfg = cls(batch_size=batch, search_budget=8, **kw)
            if cls is JFFConfig:
                cfg.workers_per_node = 1  # one device, as the port: the search knobs decide
            got.append(fn(g, cfg))
        out[name] = got
    return out


@pytest.mark.parametrize("case", ["small 1x8", "small 2x4", "wide 1x8", "wide 2x4",
                                  "wide 2x4 knobs", "wide one device"])
def test_unity_optimize_equals_jax(searches, case):
    (jst, jres), (tst, tres) = searches[case]
    assert by_name(tst) == by_name(jst)
    assert tst.to_json() == jst.to_json()
    assert math.isclose(tres.best_cost, jres.best_cost, rel_tol=1e-9)
    assert tres.candidates_explored == jres.candidates_explored
    assert tres.graph.to_json() == jres.graph.to_json()
    assert views_of(tres.views) == views_of(jres.views)
    for f in ("memory_per_device", "lambda_used", "allreduce_saved", "pipeline", "pipeline_tp",
              "pipeline_cp", "context_parallel", "context_parallel_tp"):
        assert getattr(tres, f) == getattr(jres, f), f
    assert {g: o.value for g, o in tres.sync_options.items()} == {
        g: o.value for g, o in jres.sync_options.items()}
    # the port records what it searched for: the reference preset without a card
    assert tres.machine.chip == TPUChipSpec() and tres.calibration.device_kind == "analytic"
    if case.endswith("knobs"):
        assert tres.sync_options and tres.allreduce_saved >= 0
    if case == "wide one device":
        assert set(tst.axis_sizes.values()) == {1} and tres.candidates_explored == 0


def test_predict_step_time_equals_jax(small):
    jg, tg = small
    for kw in ({}, {"machine_model_version": 0}):
        cfg = dict(batch_size=32, **kw)
        jcfg = JFFConfig(workers_per_node=1, **cfg)
        assert close(tunity.predict_step_time(tg, FFConfig(**cfg)),
                     junity.predict_step_time(jg, jcfg))
    tmach = MachineSpec(1, 8, tcal.chip_spec_for("TPU v5 lite"))
    jmach = JMachineSpec(1, 8, jcal.chip_spec_for("TPU v5 lite"))
    assert close(tunity.predict_step_time(tg, FFConfig(batch_size=32), machine=tmach),
                 junity.predict_step_time(jg, JFFConfig(batch_size=32, workers_per_node=1),
                                          machine=jmach))
    assert tunity._detected_chip() == TPUChipSpec()
    assert tunity._detected_chip(honest_cpu=True) == tcal.chip_spec_for("cpu")


# ------------------------------------------------------------ calibration
JAX_KINDS = ("cpu", "TPU v2", "TPU v3", "TPU v4", "TPU v5 lite", "TPU v5e", "TPU v5litepod",
             "TPU v5p", "TPU v5", "TPU v6 lite", "TPU v6e", "TPU7x", "unknown", "TPU v5 lite x4",
             "cpu x8", "TPU v4 x1")


def test_chip_specs_equal_jax_and_the_card_has_its_own():
    for kind in JAX_KINDS:
        assert dataclasses.asdict(tcal.chip_spec_for(kind)) == dataclasses.asdict(
            jcal.chip_spec_for(kind)), kind
        assert tcal.mesh_device_kind(kind, 4) == jcal.mesh_device_kind(kind, 4)
    card = "NVIDIA H100 80GB HBM3"
    h = tcal.chip_spec_for(card)
    assert h.name == card
    assert (h.bf16_flops, h.f32_flops, h.hbm_bandwidth, h.hbm_capacity, h.ici_bandwidth) == (
        989e12, 67e12, 3.35e12, 80e9, 450e9)
    assert tcal.chip_spec_for(card + " x8").bf16_flops == 8 * 989e12
    assert tcal.detected_device_kind() == "cpu"  # no card here


def test_calibration_tables_keys_and_suite_equal_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("FLEXFLOW_TPU_TORCH_CACHE", str(tmp_path))
    for kind in ("cpu", "TPU v5 lite"):
        a, b = jcal.load_calibration(kind), tcal.load_calibration(kind)
        assert b.to_json() == a.to_json()
        assert b.source.startswith(os.path.join("flexflow_tpu_torch", "search")) or \
            "flexflow_tpu_torch" in b.source
    assert tcal.cache_dir() == tmp_path
    jsuite, tsuite = jcal.default_suite(), tcal.default_suite()
    assert len(tsuite) == len(jsuite) == 10
    for (jo, jp, js), (to, tp, ts) in zip(jsuite, tsuite):
        key = tcal.cost_key(to, tp, ts, 2)
        assert key == jcal.cost_key(jo, jp, js, 2)
        assert tcal.op_class(to) == jcal.op_class(jo)
        assert tcal.op_ledger_key("TPU v5 lite", to, tp, ts, 1) == jcal.op_ledger_key(
            "TPU v5 lite", jo, jp, js, 1)
    # the analytic default without a card, as the JAX package on the CPU
    assert tcal.load_or_calibrate().to_json() == jcal.load_or_calibrate().to_json()
    assert tcal.load_or_calibrate(device_kind="cpu").to_json() == jcal.load_or_calibrate(
        device_kind="cpu").to_json()
    # either package's table reads in the other
    cal = tcal.Calibration("NVIDIA H100 80GB HBM3", {"matmul": 1.5}, {"k": 1e-5}, ["f"])
    assert jcal.Calibration.from_json(cal.to_json()).to_json() == cal.to_json()
    path = cal.save()
    assert path.parent == tmp_path and tcal.load_calibration(cal.device_kind).to_json() == \
        cal.to_json()


def test_recalibration_equals_jax():
    def fill(led):
        for i, (pred, meas) in enumerate(((1e-4, 2e-4), (2e-4, 2.1e-4), (5e-5, 2e-5))):
            key = f"op:tpu_v5_lite:K{i}"
            led.predict(key, pred, label=f"op {i}", provenance="test", alarm=True)
            for _ in range(led.min_samples + 1):
                led.measure(key, meas)
    jl, tl = JLedger(), PredictionLedger()
    fill(jl)
    fill(tl)
    js, ts = jcal.recalibration_suggestions(jl), tcal.recalibration_suggestions(tl)
    assert ts == js and ts
    jc = jcal.Calibration("TPU v5 lite")
    tc = tcal.Calibration("TPU v5 lite")
    assert tcal.apply_recalibration(tc, ledger=tl) == jcal.apply_recalibration(jc, ledger=jl)
    assert tc.to_json() == jc.to_json()


def test_calibrate_and_measure_on_the_cpu(tmp_path, monkeypatch):
    """On the CPU the port's calibrate times its own ops on the host
    clock (the card's path is chip_smoke.py's search phase): every suite
    op measured, positive ratios, the table saved and reloaded."""
    from flexflow_tpu_torch.core.tensor import TensorSpec

    monkeypatch.setenv("FLEXFLOW_TPU_TORCH_CACHE", str(tmp_path))
    # the default suite's ops of both classes at 1/64 of their batch (the
    # convolution and the 30522-row embedding table left to the card)
    suite = [(op, p, [TensorSpec((max(1, s.shape[0] // 64),) + tuple(s.shape[1:]), s.dtype)
                      for s in specs]) for op, p, specs in tcal.default_suite(DataType.FLOAT)
             if op not in (OpType.CONV2D, OpType.EMBEDDING)]
    cal = tcal.calibrate(device_kind="cpu test", suite=suite)
    assert not cal.failed and len(cal.entries) == len(suite)
    assert set(cal.derates) == {"matmul", "memory"}
    assert all(v > 0 and math.isfinite(v) for v in cal.derates.values())
    assert tcal.load_calibration("cpu test").to_json() == cal.to_json()
    op, params, specs = suite[0]
    assert op == OpType.LINEAR
    assert tcal.measure_lowered_op(op, params, specs, n_parts=2) > 0
    # measure mode writes a live measurement through to its table
    cm = tcm.CostModel(MachineSpec(1, 1), measure=True, calibration=tcal.Calibration("cpu m"),
                       ledger=PredictionLedger())
    out = TensorSpec((specs[0].shape[0], params.out_dim), specs[0].dtype)
    m = cm.op_cost_metrics(op, params, specs, [out])
    assert m.forward_time > 0 and tcal.cost_key(op, params, specs, 1) in cm.calibration.entries
