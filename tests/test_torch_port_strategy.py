"""The strategy layer and ``compile``'s strategy branches, through the
port against the JAX package on the CPU.

Machines, machine views, the mesh's axis names and device-count check,
the parallel ops, the strategy builders and their JSON, the
parallel-tensor views, and ``FFModel.compile``: a given strategy, a
strategy file, data parallelism, or the Unity search whose rewritten
graph the model adopts. The strategy layer is host code over the same
graph JSON (guids kept), so its results are equal, not close: strategy
files are compared as text, each package reads the other's. A searched
one-device compile trains as JAX's does (loss rtol 1e-5, float32 in
another summation order). A strategy needing more devices than the one
the port runs on raises the JAX package's ``build_mesh`` error, after
the files compile was asked to export are written. Guids of nodes the
search creates come from each package's own counter: the tests set both
counters to one value before a search, so rewritten graphs compare as
JSON.
"""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.config import FFConfig as JFFConfig
from flexflow_tpu.core.graph import PCGraph as JPCGraph
from flexflow_tpu.core.parallel_tensor import view_from_spec as jview_from_spec
from flexflow_tpu.core.tensor import TensorSpec as JTensorSpec
from flexflow_tpu.core.types import DataType as JDataType
from flexflow_tpu.core.types import LossType as JLossType
from flexflow_tpu.core.types import OpType as JOpType
from flexflow_tpu.model import FFModel as JFFModel
from flexflow_tpu.models.moe import build_moe_mlp as jbuild_moe_mlp
from flexflow_tpu.models.transformer import TransformerConfig as JTransformerConfig
from flexflow_tpu.models.transformer import build_transformer as jbuild_transformer
from flexflow_tpu.ops import parallel_ops as jpo
from flexflow_tpu.ops.base import LowerCtx as JLowerCtx
from flexflow_tpu.parallel import machine as jmachine
from flexflow_tpu.parallel import mesh as jmesh
from flexflow_tpu.parallel import strategy as jstrategy
from flexflow_tpu.runtime.checkpoint import load_strategy as jload_strategy
from flexflow_tpu.runtime.checkpoint import save_checkpoint as jsave_checkpoint
from flexflow_tpu.runtime.optimizers import SGDOptimizer as JSGDOptimizer
from flexflow_tpu.runtime.profiling import export_cost_dot as jexport_cost_dot
from flexflow_tpu.serving import InferenceModel as JInferenceModel
from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.core.graph import PCGraph
from flexflow_tpu_torch.core.parallel_tensor import view_from_spec
from flexflow_tpu_torch.core.tensor import TensorSpec
from flexflow_tpu_torch.core.types import DataType, LossType, OpType
from flexflow_tpu_torch.model import FFModel
from flexflow_tpu_torch.ops import get_op_def
from flexflow_tpu_torch.ops import parallel_ops as tpo
from flexflow_tpu_torch.ops.base import LowerCtx
from flexflow_tpu_torch.parallel import machine, mesh, strategy
from flexflow_tpu_torch.runtime import SGDOptimizer
from flexflow_tpu_torch.runtime.checkpoint import load_strategy, save_checkpoint
from flexflow_tpu_torch.runtime.profiling import export_cost_dot
from flexflow_tpu_torch.serving import InferenceModel
from flexflow_tpu_torch.tools.frontend_probe import bert_onnx_graph

from torch_port_cnn import carry

pytestmark = pytest.mark.torch_port

TCFG = dict(num_layers=2, hidden_size=64, num_heads=4, ff_size=128, seq_length=16)
BATCH = 8


def both_graphs(jm):
    """The JAX model's graph as a JAX and a port PCGraph (guids kept)."""
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


@pytest.fixture(scope="module")
def jtransformer():
    return jbuild_transformer(JFFConfig(batch_size=BATCH), JTransformerConfig(**TCFG))


# ---------------------------------------------------------------- machine
def test_machine_specs_and_views_equal_jax():
    assert dataclasses.asdict(machine.TPUChipSpec()) == dataclasses.asdict(jmachine.TPUChipSpec())
    for nodes, per in ((1, 1), (1, 6), (2, 4), (1, 8), (3, 4)):
        t, j = machine.MachineSpec(nodes, per), jmachine.MachineSpec(nodes, per)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert (t.num_devices, t.torus_dims()) == (j.num_devices, j.torus_dims())
        for max_dims in (1, 2):
            tv = machine.enumerate_machine_views(t, max_dims)
            jv = jmachine.enumerate_machine_views(j, max_dims)
            assert [dataclasses.astuple(v) for v in tv] == [dataclasses.astuple(v) for v in jv]
            assert [v.device_ids() for v in tv] == [v.device_ids() for v in jv]
            assert [v.to_hash() for v in tv] == [v.to_hash() for v in jv]
    assert machine._divisors(12) == jmachine._divisors(12)
    assert dataclasses.astuple(machine.MachineView.all_devices(8)) == dataclasses.astuple(
        jmachine.MachineView.all_devices(8))


# ------------------------------------------------------------------- mesh
def test_mesh_axis_names_and_device_count_check_equal_jax():
    for name in ("DATA_AXIS", "MODEL_AXIS", "SEQ_AXIS", "EXPERT_AXIS", "PIPE_AXIS"):
        assert getattr(mesh, name) == getattr(jmesh, name)
    one = [torch.device("cpu")]
    for axes in ({"data": 8}, {"data": 2, "model": 2}, {"data": 2, "seq": 2, "model": 2}):
        with pytest.raises(ValueError) as want:
            jmesh.build_mesh(axes, jax.devices()[:1])
        with pytest.raises(ValueError) as got:
            mesh.build_mesh(axes, one)
        assert str(got.value) == str(want.value)
    assert mesh.build_mesh({"data": 1, "model": 1}, one) == {"data": 1}
    assert mesh.build_mesh({"data": 2, "model": 1}, one * 2) == {"data": 2}
    assert len(mesh.available_devices()) >= 1


# ------------------------------------------------------------ parallel ops
PARALLEL = {
    "repartition": (jpo.RepartitionParams(dim=0, degree=2), tpo.RepartitionParams(dim=0, degree=2)),
    "combine": (jpo.CombineParams(dim=-1, degree=4), tpo.CombineParams(dim=-1, degree=4)),
    "replicate": (jpo.ReplicateParams(degree=2), tpo.ReplicateParams(degree=2)),
    "reduction": (jpo.ReductionParams(degree=2), tpo.ReductionParams(degree=2)),
    "allreduce": (jpo.AllReduceParams(degree=8), tpo.AllReduceParams(degree=8)),
    "fused_parallel": (jpo.FusedParallelParams(transitions=(("combine", 0, 2),)),
                       tpo.FusedParallelParams(transitions=(("combine", 0, 2),))),
}


@pytest.mark.parametrize("kind", list(PARALLEL))
def test_parallel_op_equals_jax_without_a_mesh(kind):
    from flexflow_tpu.ops.base import get_op_def as jget_op_def

    jp, tp = PARALLEL[kind]
    assert [f.name for f in dataclasses.fields(tp)] == [f.name for f in dataclasses.fields(jp)]
    assert repr(tp) == repr(jp)  # the calibration keys spell params by repr
    jd, td = jget_op_def(JOpType(kind)), get_op_def(OpType(kind))
    assert td.params_cls is type(tp)
    spec, jspec = TensorSpec((8, 4, 16)), JTensorSpec((8, 4, 16))
    assert td.infer_output_specs(tp, [spec]) == [spec]
    assert dataclasses.astuple(td.cost(tp, [spec], [spec])) == dataclasses.astuple(
        jd.cost(jp, [jspec], [jspec]))
    x = np.random.RandomState(0).randn(8, 4, 16).astype(np.float32)
    (want,) = jd.lower(jp, [jnp.asarray(x)], {}, JLowerCtx())
    (got,) = td.lower(tp, [torch.from_numpy(x)], {}, LowerCtx())
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_graph_with_parallel_ops_crosses_and_draws_as_jax(jtransformer):
    """A JAX graph rewritten by the tensor-parallel substitutions
    (replicate -> linear -> combine, partition -> linear -> reduction)
    read by the port: the same JSON back, the same DOT (parallel ops as
    ellipses), and the same values through the ops on one device."""
    from flexflow_tpu.search import substitution as jsub

    g = JPCGraph.from_json(jtransformer.graph.to_json())
    for xfer in (jsub.create_replicate_linear_combine(2), jsub.create_partition_linear_combine(2)):
        g = xfer.run(g)[0]
    kinds = {n.op_type.value for n in g.nodes.values()}
    assert {"replicate", "combine", "repartition", "reduction"} <= kinds
    text = g.to_json()
    tg = PCGraph.from_json(text)
    assert tg.to_json() == text
    assert tg.to_dot() == g.to_dot() and "shape=ellipse" in tg.to_dot()


# --------------------------------------------------------------- strategy
def test_strategy_builders_equal_jax(jtransformer):
    jg, tg = both_graphs(jtransformer)
    cases = [
        ("data_parallel_strategy", (1,), {}), ("data_parallel_strategy", (2,), {}),
        ("data_parallel_strategy", (8,), {}),
        ("megatron_strategy", (2, 4), {}), ("megatron_strategy", (1, 2), {"sp": True}),
        ("context_parallel_strategy", (2, 2), {"tp": 2}), ("context_parallel_strategy", (4, 2), {}),
        ("pipeline_strategy", (2,), {"dp": 2, "tp": 2}), ("pipeline_strategy", (2,), {"cp": 2}),
    ]
    for fn, args, kw in cases:
        want = getattr(jstrategy, fn)(jg, *args, **kw)
        got = getattr(strategy, fn)(tg, *args, **kw)
        assert got.to_json() == want.to_json(), fn
        for g, sh in want.node_shardings.items():
            assert got.output_spec(g) == want.output_spec(g)
            for w in sh.weights:
                assert got.weight_spec(g, w) == want.weight_spec(g, w)
    jmoe = jbuild_moe_mlp(JFFConfig(batch_size=16), in_dim=32, num_classes=4, num_experts=4,
                          num_select=2, expert_hidden=16)
    jg2, tg2 = both_graphs(jmoe)
    for dp, ep in ((2, 2), (1, 4)):
        assert strategy.expert_parallel_strategy(tg2, dp, ep).to_json() == \
            jstrategy.expert_parallel_strategy(jg2, dp, ep).to_json()
    for b, pp, dp in itertools.product((1, 6, 8, 32, 96), (1, 2, 4), (1, 2, 3)):
        assert strategy.default_microbatches(b, pp, dp) == jstrategy.default_microbatches(b, pp, dp)
    for n in tg.topo_order():
        assert strategy.megatron_weight_dims(n) == jstrategy.megatron_weight_dims(jg.nodes[n.guid])
    _, reps, _ = __import__("flexflow_tpu_torch.parallel.pipeline", fromlist=["x"]).detect_repeats(tg)
    from flexflow_tpu.parallel.pipeline import detect_repeats as jdetect

    _, jreps, _ = jdetect(jg)
    for rep, jrep in zip(reps, jreps):
        assert strategy.tp_shardable_nodes(tg, rep) == jstrategy.tp_shardable_nodes(jg, jrep)
    assert strategy.pspec("data", None, ("model", "seq")) == jstrategy.pspec(
        "data", None, ("model", "seq"))


def test_strategy_files_cross_both_ways_and_remap_by_name(jtransformer):
    jg, tg = both_graphs(jtransformer)
    jst = jstrategy.megatron_strategy(jg, 2, 2)
    jst.node_shardings[next(iter(jst.node_shardings))].machine_view = (0, (2, 2), (2, 1))
    jst.pipeline = jstrategy.PipelineAssignment(2, 4, {g: 0 for g in list(jg.nodes)[:3]})
    text = jst.to_json()
    tst = strategy.ParallelStrategy.from_json(text)
    assert tst.to_json() == text
    assert jstrategy.ParallelStrategy.from_json(tst.to_json()).to_json() == text
    # a rebuilt graph (new guids) remaps by layer name, in both packages alike
    jfresh = jbuild_transformer(JFFConfig(batch_size=BATCH), JTransformerConfig(**TCFG)).graph
    tfresh = PCGraph.from_json(jfresh.to_json())
    jr, tr = jst.remap_to(jfresh), tst.remap_to(tfresh)
    assert jr is not None and tr is not None and tr.to_json() == jr.to_json()
    assert set(tr.node_shardings) <= set(tfresh.nodes)
    assert tst.remap_to(tg) is tst  # the same guids and names: itself
    # an ambiguous name: no remap in either
    jbad, tbad = JPCGraph.from_json(jfresh.to_json()), PCGraph.from_json(jfresh.to_json())
    for g in (jbad, tbad):
        first, second = list(g.nodes.values())[1:3]
        g.nodes[second.guid] = dataclasses.replace(second, name=first.name)
    assert jst.remap_to(jbad) is None and tst.remap_to(tbad) is None


def test_parallel_tensor_views_equal_jax(jtransformer):
    for shape, spec, axes in (((8, 16, 64), (("data",), (), ("model",)), {"data": 2, "model": 4}),
                              ((64, 128), ((), ("model",)), {"data": 8, "model": 1}),
                              ((4, 4), None, {"data": 2}),
                              ((8, 6), (("data", "seq"), ()), {"data": 2, "seq": 2, "expert": 2})):
        want = jview_from_spec(JTensorSpec(shape), spec, axes, 7)
        got = view_from_spec(TensorSpec(shape), spec, axes, 7)
        assert repr(got) == repr(want)
        assert (got.num_shards, got.shard_shape, got.replica_degree) == (
            want.num_shards, want.shard_shape, want.replica_degree)
    jm = jbuild_transformer(JFFConfig(batch_size=BATCH, workers_per_node=1),
                            JTransformerConfig(**TCFG))
    jm.compile(optimizer=JSGDOptimizer(lr=0.01), loss_type=JLossType.MEAN_SQUARED_ERROR)
    tm = FFModel.from_graph(PCGraph.from_json(jm.graph.to_json()), FFConfig(batch_size=BATCH),
                            device="cpu")
    tm.compile(optimizer=SGDOptimizer(lr=0.01), loss_type=LossType.MEAN_SQUARED_ERROR,
               outputs=tm.output_tensors([(t.node.guid, t.idx) for t in jm._outputs]))
    assert tm.strategy.to_json() == jm.strategy.to_json()
    jt, tt = jm._outputs[0], tm._outputs[0]
    assert repr(tm.parallel_tensor(tt)) == repr(jm.parallel_tensor(jt))
    node = next(n for n in tm.graph.topo_order() if n.op_type == OpType.LINEAR)
    handle = tm.output_tensors([(node.guid, 0)])[0]
    jhandle = type(jt)(jm, jm.graph.nodes[node.guid], 0, jt.spec)
    assert repr(tm.parallel_weight(handle, "kernel")) == repr(jm.parallel_weight(jhandle, "kernel"))
    with pytest.raises(KeyError):
        tm.parallel_weight(handle, "nope")


# ---------------------------------------------------------------- compile
def _mlp(pkg, config):
    """An MLP whose Linear -> ReLU pairs the one-device search fuses."""
    m = (JFFModel if pkg == "jax" else FFModel)(config, **({} if pkg == "jax" else {"device": "cpu"}))
    t = m.create_tensor([BATCH, 32], name="x")
    for i in range(3):
        t = m.relu(m.dense(t, 32, name=f"d{i}"), name=f"r{i}")
    m.dense(t, 8, name="head")
    return m


@pytest.mark.parametrize("model", ["mlp", "transformer"])
def test_searched_compile_on_one_device_trains_as_jax(model, tmp_path):
    """compile(search_budget=8) on one device: the JAX package's strategy,
    searched graph (the MLP's Linear+ReLU pairs fused) and exported
    files; three SGD steps at loss rtol 1e-5."""
    files = {f"{k}_{p}": str(tmp_path / f"{k}_{p}") for k in ("st", "dot") for p in ("jax", "port")}

    def cfg(cls, pkg, **kw):
        return cls(batch_size=BATCH, search_budget=8, export_strategy_file=files[f"st_{pkg}"],
                   export_strategy_computation_graph_file=files[f"dot_{pkg}"], **kw)

    jcfg = cfg(JFFConfig, "jax", workers_per_node=1)
    jm = _mlp("jax", jcfg) if model == "mlp" else jbuild_transformer(
        jcfg, JTransformerConfig(**TCFG))
    tm = FFModel.from_graph(PCGraph.from_json(jm.graph.to_json()), cfg(FFConfig, "port"),
                            seed=jm._seed, device="cpu")
    out = jm._default_output()
    start = align_counters()
    jm.compile(optimizer=JSGDOptimizer(lr=0.01), loss_type=JLossType.MEAN_SQUARED_ERROR)
    align_counters(start)
    tm.compile(optimizer=SGDOptimizer(lr=0.01), loss_type=LossType.MEAN_SQUARED_ERROR,
               outputs=tm.output_tensors([(out.node.guid, 0)]))
    assert tm.strategy.axis_sizes == jm.strategy.axis_sizes == {"data": 1, "model": 1}
    assert tm.graph.to_json() == jm.graph.to_json()
    assert tm._search_result.best_cost == jm._search_result.best_cost
    assert tm._search_result.candidates_explored == jm._search_result.candidates_explored
    if model == "mlp":  # the fusion was adopted: no ReLU node is left
        assert not any(n.op_type == OpType.RELU for n in tm.graph.nodes.values())
    for k in ("st", "dot"):
        assert open(files[f"{k}_port"]).read() == open(files[f"{k}_jax"]).read()
    carry(jm, tm)
    rs = np.random.RandomState(5)
    x_shape = next(n for n in jm.graph.nodes.values() if n.op_type == JOpType.INPUT).params.shape
    for step in range(3):
        x = rs.randn(*x_shape).astype(np.float32)
        y = rs.randn(*out.spec.shape).astype(np.float32)
        jl = jm.executor.train_batch([jnp.asarray(x)], jnp.asarray(y), jax.random.key(step))
        tl = tm.executor.train_batch([x], y)
        np.testing.assert_allclose(float(tl["loss"]), float(jl["loss"]), rtol=1e-5)


def test_search_for_eight_devices_exports_then_raises_jax_words(tmp_path):
    """search_num_workers=8 on one device: the strategy file is written
    (the JAX package's, which runs it on its 8 CPU devices), then compile
    raises the JAX package's build_mesh error; the file, imported, raises
    the same; a one-device file imports and runs."""
    kw = dict(num_layers=2, hidden_size=128, num_heads=4, ff_size=256, seq_length=32)
    jm = jbuild_transformer(JFFConfig(batch_size=64, search_budget=8, search_num_workers=8,
                                      export_strategy_file=str(tmp_path / "j.json")),
                            JTransformerConfig(**kw))
    text = jm.graph.to_json()
    start = align_counters()
    jm.compile(optimizer=JSGDOptimizer(lr=0.01), loss_type=JLossType.MEAN_SQUARED_ERROR)
    need = int(np.prod(list(jm.strategy.axis_sizes.values())))
    assert need == 8
    with pytest.raises(ValueError) as want:
        jmesh.build_mesh(jm.strategy.axis_sizes, jax.devices()[:1])
    tm = FFModel.from_graph(PCGraph.from_json(text), FFConfig(
        batch_size=64, search_budget=8, search_num_workers=8,
        export_strategy_file=str(tmp_path / "t.json")), device="cpu")
    align_counters(start)
    with pytest.raises(ValueError) as got:
        tm.compile(optimizer=SGDOptimizer(lr=0.01), loss_type=LossType.MEAN_SQUARED_ERROR)
    assert str(got.value) == str(want.value) == "mesh needs 8 devices, have 1"
    assert tm.executor is None
    assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json").read_text()
    # the JAX file imported into a rebuild of the model (new guids: remapped)
    tm2 = FFModel.from_graph(PCGraph.from_json(jbuild_transformer(
        JFFConfig(batch_size=64), JTransformerConfig(**kw)).graph.to_json()),
        FFConfig(batch_size=64, import_strategy_file=str(tmp_path / "j.json")), device="cpu")
    with pytest.raises(ValueError, match="^mesh needs 8 devices, have 1$"):
        tm2.compile()
    # a one-device strategy: a file, and the strategy= argument
    one = strategy.data_parallel_strategy(tm2.graph, 1)
    (tmp_path / "one.json").write_text(one.to_json())
    tm2.config.import_strategy_file = str(tmp_path / "one.json")
    tm2.compile()
    assert tm2.strategy.to_json() == one.to_json() and tm2.executor is not None
    tm2.config.import_strategy_file = ""
    tm2.compile(strategy=one)
    assert tm2.strategy is one
    # a strategy of another graph: the JAX package's refusal
    other = strategy.data_parallel_strategy(PCGraph.from_json(text), 1)
    other.node_names = {g: f"elsewhere{i}" for i, g in enumerate(other.node_names)}
    with pytest.raises(ValueError, match="strategy was built for a different graph"):
        tm2.compile(strategy=other)


def test_from_onnx_compiles_with_a_strategy_file_as_jax(tmp_path):
    """A one-device strategy file written by the JAX package's served
    BERT: the port's from_onnx reads it, compiles with it and serves the
    JAX package's outputs."""
    kw = dict(vocab=50, layers=2, hidden=32, heads=2, ff=64, classes=2)
    proto = bert_onnx_graph(0, **kw)
    jim = JInferenceModel.from_onnx(proto, {"ids": (8,)}, max_batch=4,
                                    input_dtypes={"ids": JDataType.INT32},
                                    config=JFFConfig(batch_size=4, workers_per_node=1))
    path = tmp_path / "strategy.json"
    path.write_text(jim.model.strategy.to_json())
    jim2 = JInferenceModel.from_onnx(proto, {"ids": (8,)}, max_batch=4, strategy_file=str(path),
                                     input_dtypes={"ids": JDataType.INT32},
                                     config=JFFConfig(batch_size=4, workers_per_node=1))
    tim = InferenceModel.from_onnx(proto, {"ids": (8,)}, max_batch=4, strategy_file=str(path),
                                   input_dtypes={"ids": DataType.INT32}, device="cpu")
    assert tim.model.strategy.axis_sizes == jim2.model.strategy.axis_sizes == {"data": 1}
    names = {n.guid: n.name for n in tim.model.graph.nodes.values()}
    assert {names[g] for g in tim.model.strategy.node_shardings} == set(names.values()) - {""}
    ids = np.random.RandomState(1).randint(0, 50, size=(3, 8)).astype(np.int32)
    for got, want in zip(tim.infer([ids]), jim2.infer([ids])):
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-5)


def test_checkpoint_strategy_files_cross_both_ways(tmp_path):
    jm = jbuild_transformer(JFFConfig(batch_size=BATCH, workers_per_node=1),
                            JTransformerConfig(**TCFG))
    jm.compile(optimizer=JSGDOptimizer(lr=0.01), loss_type=JLossType.MEAN_SQUARED_ERROR)
    tm = FFModel.from_graph(PCGraph.from_json(jm.graph.to_json()), FFConfig(batch_size=BATCH),
                            device="cpu")
    tm.compile(optimizer=SGDOptimizer(lr=0.01), loss_type=LossType.MEAN_SQUARED_ERROR,
               outputs=tm.output_tensors([(t.node.guid, t.idx) for t in jm._outputs]))
    jst = jstrategy.megatron_strategy(jm.graph, 2, 2)
    jsave_checkpoint(str(tmp_path / "jax"), jm.executor, step=3, strategy=jst)
    save_checkpoint(str(tmp_path / "port"), tm.executor, step=3,
                    strategy=strategy.ParallelStrategy.from_json(jst.to_json()))
    for d in ("jax", "port"):
        assert load_strategy(str(tmp_path / d)).to_json() == jst.to_json()
        assert jload_strategy(str(tmp_path / d)).to_json() == jst.to_json()
    save_checkpoint(str(tmp_path / "none"), tm.executor, step=1)
    assert load_strategy(str(tmp_path / "none")) is None
    assert jload_strategy(str(tmp_path / "none")) is None


def test_export_cost_dot_equals_jax(jtransformer):
    from flexflow_tpu.search.calibration import chip_spec_for as jchip_spec_for
    from flexflow_tpu_torch.search.calibration import chip_spec_for

    jg, tg = both_graphs(jtransformer)
    assert export_cost_dot(tg) == jexport_cost_dot(jg)
    assert export_cost_dot(tg, machine.MachineSpec(1, 4, chip_spec_for("TPU v5 lite"))) == \
        jexport_cost_dot(jg, jmachine.MachineSpec(1, 4, jchip_spec_for("TPU v5 lite")))
    assert "GFLOP" in export_cost_dot(tg)
