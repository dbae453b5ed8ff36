"""The rest of the runtime and the graph, through the port against the
JAX package on the CPU: every registered op's analytic cost, the per-op
profile and ``FFConfig(profiling=True)``, ``ElasticTrainer``, the
``PCGraph`` methods the search uses, and ``get_output`` / ``num_layers``.

The costs and the graph queries are exact (the same integer and float
arithmetic on the same specs). The elastic runs hold the JAX package's
own tests (``tests/test_runtime_aux.py``) in both packages: the same
counters and backoffs, a recovered run bit for bit with the clean one in
the port, and within 1e-6 of JAX's (float32, another summation order).
``structural_hash`` and ``param_hash`` use Python's ``hash`` of enums,
which is salted per process, so they are held by which graphs (nodes)
hash equal, not by their values.
"""
import itertools
import re

import jax.numpy as jnp
import numpy as np
import pytest

from flexflow_tpu.config import FFConfig as JFFConfig
from flexflow_tpu.core import types as jtypes
from flexflow_tpu.core.tensor import TensorSpec as JTensorSpec
from flexflow_tpu.model import FFModel as JFFModel
from flexflow_tpu.models.moe import build_moe_mlp as jbuild_moe_mlp
from flexflow_tpu.models.nmt import build_nmt as jbuild_nmt
from flexflow_tpu.models.transformer import TransformerConfig as JTransformerConfig
from flexflow_tpu.models.transformer import build_transformer as jbuild_transformer
from flexflow_tpu.models.vision import build_resnet50 as jbuild_resnet50
from flexflow_tpu.ops.base import get_op_def as jget_op_def
from flexflow_tpu.parallel.propagation import infer_all_specs as jinfer_all_specs
from flexflow_tpu.runtime import faults as jfaults
from flexflow_tpu.runtime.elastic import ElasticTrainer as JElasticTrainer
from flexflow_tpu.runtime.optimizers import SGDOptimizer as JSGDOptimizer
from flexflow_tpu.runtime.profiling import OpProfile as JOpProfile
from flexflow_tpu.runtime.profiling import format_profiles as jformat_profiles
from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.core import types
from flexflow_tpu_torch.core.graph import PCGraph
from flexflow_tpu_torch.core.tensor import TensorSpec
from flexflow_tpu_torch.model import FFModel
from flexflow_tpu_torch.ops import get_op_def, registered_ops
from flexflow_tpu_torch.parallel.propagation import infer_all_specs
from flexflow_tpu_torch.runtime import SGDOptimizer, faults
from flexflow_tpu_torch.runtime.elastic import ElasticTrainer
from flexflow_tpu_torch.runtime.profiling import OpProfile, format_profiles, trace

from torch_port_cnn import assert_weights_match, port_from_jax

pytestmark = pytest.mark.torch_port


def every_op(m, t):
    """One graph through every layer method the port has, in either package
    (``t``: that package's ``core.types``)."""
    B = 2
    img = m.create_tensor((B, 3, 8, 8), name="img")
    c = m.conv2d(img, 4, 3, 3, 1, 1, 1, 1, activation=t.ActiMode.RELU, groups=1, name="conv")
    p = m.pool2d(c, 2, 2, 2, 2, 0, 0, name="maxpool")
    m.pool2d(c, 3, 3, 1, 1, 1, 1, pool_type=t.PoolType.AVG, name="avgpool")
    bn = m.batch_norm(p, name="bn")
    h = m.dense(m.flat(bn, name="flat"), 16, name="fc")
    h2 = m.dense(h, 16, activation=t.ActiMode.GELU, use_bias=False, name="fc2")
    for op in ("add", "subtract", "multiply", "divide", "max", "min"):
        getattr(m, op)(h, h2, name=op)
    for op in ("relu", "sigmoid", "tanh", "elu", "gelu", "identity", "exp", "sin", "cos", "rsqrt"):
        getattr(m, op)(h, name=op)
    m.pow(h, 1.5, name="pow")
    for op in ("scalar_add", "scalar_sub", "scalar_multiply", "scalar_true_divide"):
        getattr(m, op)(h, 2.0, name=op)
    seq = m.create_tensor((B, 4, 16), name="seq")
    att = m.multihead_attention(seq, seq, seq, 16, 2, bias=True, name="att")
    ln = m.layer_norm(att, name="ln")
    m.dropout(m.softmax(ln, name="sm"), 0.1, name="drop")
    ids = m.create_tensor((B, 4), t.DataType.INT32, name="ids")
    emb = m.embedding(ids, 10, 16, name="emb")
    m.reshape(emb, (B, 64), name="reshape")
    tr = m.transpose(emb, (0, 2, 1), name="transpose")
    m.reverse(emb, 1, name="reverse")
    cat = m.concat([emb, att], 2, name="concat")
    m.split(cat, 2, 2, name="split")
    m.cast(emb, t.DataType.BFLOAT16, name="cast")
    m.batch_matmul(seq, tr, name="bmm")
    idx = m.create_tensor((B, 4, 16), t.DataType.INT32, name="idx")
    m.gather(emb, idx, 1, name="gather")
    m.reduce_sum(emb, (1,), name="reduce_sum")
    m.mean(emb, (1, 2), keepdims=True, name="mean")
    m.rnn(seq, 8, name="rnn")
    m.lstm(seq, 8, name="lstm")
    m.create_weight((4, 16), name="weight")
    tok = m.create_tensor((8, 16), name="tok")
    tok = m.cache(tok, num_batches=2, name="cache")
    gate = m.softmax(m.dense(tok, 4, name="gate"), name="gate_sm")
    v, i = m.top_k(gate, 2, name="topk")
    grouped = m.group_by(tok, i, 4, 1.0, stacked=True, name="groupby")
    listed = m.group_by(tok, i, 4, 1.0, name="groupby_listed")
    ex = m.experts(grouped, 4, 8, 16, name="experts")
    m.aggregate(v, i, [ex], 4, 0.04, name="agg")
    m.aggregate_spec(v, i, listed, 4, 0.01, name="agg_spec")
    return m


def _small_bert(cfg):
    return jbuild_transformer(cfg, JTransformerConfig(num_layers=2, hidden_size=16, num_heads=2,
                                                      ff_size=32, seq_length=8, vocab_size=20,
                                                      num_classes=2, dropout=0.1))


def _jax_graphs():
    cfg = JFFConfig(batch_size=2, workers_per_node=1)
    return {
        "every_op": every_op(JFFModel(cfg), jtypes).graph,
        "bert": _small_bert(cfg).graph,
        "nmt": jbuild_nmt(cfg, src_vocab=30, tgt_vocab=30, embed_dim=8, hidden_size=8,
                          src_len=4, tgt_len=4).graph,
        "resnet50": jbuild_resnet50(cfg, num_classes=10, image_hw=32).graph,
        "moe": jbuild_moe_mlp(cfg, in_dim=16, num_classes=4, num_experts=4, use_cache=True).graph,
    }


@pytest.fixture(scope="module")
def graphs():
    """{name: (JAX graph, the port's graph read from its JSON)}."""
    return {k: (g, PCGraph.from_json(g.to_json())) for k, g in _jax_graphs().items()}


def _cost(c):
    return (c.flops, c.bytes_accessed, c.memory_bytes)


def test_every_registered_op_cost_equals_jax(graphs):
    """Each node's cost (flops, bytes accessed, resident bytes) in the
    port equals JAX's for the same specs, over every op the port
    registers; NOOP, which no layer method records, and the parallel ops,
    which only the strategy search writes into a graph, at a spec of
    their own."""
    seen = set()
    for name, (jg, tg) in graphs.items():
        jspecs, tspecs = jinfer_all_specs(jg), infer_all_specs(tg)
        for node in tg.topo_order():
            jnode = jg.nodes[node.guid]
            jin = [jspecs[e.src][e.src_idx] for e in jg.in_edges(jnode)]
            tin = [tspecs[e.src][e.src_idx] for e in tg.in_edges(node)]
            want = jget_op_def(jnode.op_type).cost(jnode.params, jin, jspecs[node.guid])
            got = get_op_def(node.op_type).cost(node.params, tin, tspecs[node.guid])
            assert _cost(got) == _cost(want), (name, node)
            seen.add(node.op_type)
    spec = TensorSpec((3, 5))

    assert _cost(get_op_def(types.OpType.NOOP).cost(None, [spec], [spec])) == _cost(
        jget_op_def(jtypes.OpType.NOOP).cost(None, [JTensorSpec((3, 5))], [JTensorSpec((3, 5))]))
    seen.add(types.OpType.NOOP)
    from flexflow_tpu.ops import parallel_ops as jpo
    from flexflow_tpu_torch.ops import parallel_ops as tpo

    for cls, args in (("RepartitionParams", (0, 2)), ("CombineParams", (1, 2)),
                      ("ReplicateParams", (2,)), ("ReductionParams", (2,)),
                      ("AllReduceParams", (4,)), ("FusedParallelParams", ())):
        tp, jp = getattr(tpo, cls)(*args), getattr(jpo, cls)(*args)
        op = next(t for t, d in registered_ops().items() if d.params_cls is type(tp))
        assert _cost(get_op_def(op).cost(tp, [spec], [spec])) == _cost(jget_op_def(
            jtypes.OpType(op.value)).cost(jp, [JTensorSpec((3, 5))], [JTensorSpec((3, 5))]))
        seen.add(op)
    assert seen == set(registered_ops())


# --------------------------------------------------------------- profile
MOE = dict(in_dim=24, num_classes=4, num_experts=4, num_select=2, expert_hidden=16)


@pytest.fixture(scope="module")
def moe_pair():
    from flexflow_tpu.core.types import LossType as JLossType

    jm = jbuild_moe_mlp(JFFConfig(batch_size=8, workers_per_node=1), **MOE)
    jm.compile(optimizer=JSGDOptimizer(lr=0.05), loss_type=JLossType.SPARSE_CATEGORICAL_CROSSENTROPY)
    tm = port_from_jax(jm, FFConfig(batch_size=8), SGDOptimizer(lr=0.05),
                       types.LossType.SPARSE_CATEGORICAL_CROSSENTROPY, [])
    return jm, tm


def _rows(profiles):
    return [(p.guid, p.op_type, p.name, p.flops, p.bytes_accessed) for p in profiles]


def test_profile_gives_jax_ops_names_and_costs(moe_pair, capsys):
    """``profile()`` without inputs (JAX's RandomState(0) draws): the same
    ops, names, flops and bytes in JAX's order, each time positive, and
    the printed table in ``format_profiles``' layout."""
    jm, tm = moe_pair
    jp = jm.profile(verbose=False)
    tp = tm.profile(verbose=True)
    assert _rows(tp) == _rows(jp)
    assert all(p.ms > 0 for p in tp)
    out = capsys.readouterr().out.splitlines()
    assert out[0] == format_profiles(tp).splitlines()[0]
    assert len(out) == len(tp) + 2 and out[-1].startswith("TOTAL")
    # the layout, at equal times, character for character
    fixed = [(g, o, n, f, b) for g, o, n, f, b in _rows(tp)]
    ms = [0.5 + i for i in range(len(fixed))]
    assert format_profiles([OpProfile(*r[:3], m, *r[3:]) for r, m in zip(fixed, ms)]) == \
        jformat_profiles([JOpProfile(*r[:3], m, *r[3:]) for r, m in zip(fixed, ms)])


def _table_ops(text):
    """The (op, name) columns of a printed profile table, in its order."""
    rows = [ln for ln in text.splitlines() if re.match(r"^\S+\s+\S*\s+\d+\.\d{3}\s", ln)]
    return sorted(tuple(ln.split()[:2]) for ln in rows if not ln.startswith("TOTAL"))


def test_fit_with_profiling_prints_the_table_then_trains(capsys):
    """``FFConfig(profiling=True)`` no longer raises: ``fit`` prints the
    per-op table once, over the ops JAX's prints, then trains as JAX's
    (losses rtol 1e-5)."""
    from flexflow_tpu.core.types import LossType as JLossType

    jm = jbuild_moe_mlp(JFFConfig(batch_size=8, workers_per_node=1, profiling=True), **MOE)
    jm.compile(optimizer=JSGDOptimizer(lr=0.05), loss_type=JLossType.SPARSE_CATEGORICAL_CROSSENTROPY)
    tm = port_from_jax(jm, FFConfig(batch_size=8, profiling=True), SGDOptimizer(lr=0.05),
                       types.LossType.SPARSE_CATEGORICAL_CROSSENTROPY, [])
    assert FFConfig.from_args(["--profiling"]).profiling
    rs = np.random.RandomState(3)
    x = rs.randn(16, MOE["in_dim"]).astype(np.float32)
    y = rs.randint(0, MOE["num_classes"], (16,)).astype(np.int32)
    jm.fit(jnp.asarray(x), jnp.asarray(y), epochs=1, verbose=False)
    jout = capsys.readouterr().out
    tm.fit(x, y, epochs=1, verbose=False)
    tout = capsys.readouterr().out
    assert tout.count("TFLOP/s") == jout.count("TFLOP/s") == 1
    assert _table_ops(tout) == _table_ops(jout) and len(_table_ops(tout)) == 8
    assert len(tm.step_losses) == 2
    assert_weights_match(jm, tm, atol=1e-6)


def test_trace_writes_a_chrome_trace(tmp_path, moe_pair):
    _, tm = moe_pair
    with trace(str(tmp_path / "tr")):
        tm.predict(np.zeros((8, MOE["in_dim"]), np.float32))
    files = list((tmp_path / "tr").iterdir())
    assert len(files) == 1 and files[0].name == "trace_0.json"
    assert '"traceEvents"' in files[0].read_text()


# --------------------------------------------------------------- elastic
def _elastic_models():
    def jbuild():
        from flexflow_tpu.core.types import LossType as JLossType

        m = JFFModel(JFFConfig(batch_size=8, workers_per_node=1))
        x = m.create_tensor((8, 16), name="x")
        t = m.dense(x, 32, activation="relu", name="f1")
        m.dense(t, 16, name="f2")
        m.compile(optimizer=JSGDOptimizer(lr=0.05), loss_type=JLossType.MEAN_SQUARED_ERROR)
        return m

    def port(jm):
        return port_from_jax(jm, FFConfig(batch_size=8), SGDOptimizer(lr=0.05),
                             types.LossType.MEAN_SQUARED_ERROR, [])

    return jbuild, port


_DATA = [(x.astype(np.float32), y.astype(np.float32)) for x, y in
         ((r.randn(8, 16), r.randn(8, 16)) for r in [np.random.RandomState(0)] for _ in range(12))]


def _report(r):
    return (r.steps_completed, r.restarts, r.checkpoints_saved, len(r.failures), r.backoffs)


def _batches(jax_side: bool, poison_at=None):
    armed = {"on": poison_at is not None}

    def batches(step):
        x, y = _DATA[step]
        if armed["on"] and step == poison_at:
            armed["on"] = False  # once, like a transient device loss
            x = np.full_like(x, np.nan)
        return ([jnp.asarray(x)], jnp.asarray(y)) if jax_side else ([x], y)

    return batches


def test_elastic_trainer_recovers_as_jax(tmp_path):
    """A NaN batch at step 7 (checkpoints every 5): one restart from
    step 5, the same report as JAX's (steps, restarts, checkpoints,
    failures, the seeded backoffs), the replayed run's weights equal to
    the clean run's bit for bit, and to JAX's within 1e-6."""
    jbuild, port = _elastic_models()
    runs = {}
    for tag, poison in (("clean", None), ("fault", 7)):
        jm = jbuild()
        tm = port(jm)
        jr = JElasticTrainer(jm, str(tmp_path / f"j{tag}"), checkpoint_every=5,
                             sleep=lambda s: None).run(_batches(True, poison), num_steps=12)
        tr = ElasticTrainer(tm, str(tmp_path / f"t{tag}"), checkpoint_every=5,
                            sleep=lambda s: None).run(_batches(False, poison), num_steps=12)
        assert _report(tr) == _report(jr), tag
        assert [f.split(":")[0] for f in tr.failures] == [f.split(":")[0] for f in jr.failures]
        np.testing.assert_allclose(tr.final_loss, jr.final_loss, rtol=1e-5)
        assert_weights_match(jm, tm, atol=1e-6)
        runs[tag] = (tr, tm)
    assert runs["fault"][0].restarts == 1 and "non-finite" in runs["fault"][0].failures[0]
    for layer in ("f1", "f2"):
        for w in ("kernel", "bias"):
            np.testing.assert_array_equal(runs["fault"][1].get_weight(layer, w),
                                          runs["clean"][1].get_weight(layer, w))


def test_elastic_fault_site_and_exhaustion_as_jax(tmp_path):
    """An error injected at ``elastic.step`` on step 3 before any
    checkpoint: each package re-initialises the model from its seed and
    replays from step 0, with JAX's report; the port's run ends bit for
    bit as a clean run from the port's own initial weights (each package
    draws its own). Then an always-poisoned batch exhausts
    ``max_restarts`` with JAX's error and backoffs."""
    jbuild, port = _elastic_models()
    jm = jbuild()

    def native():  # the JAX graph in the port, the port's own initial weights
        m = FFModel.from_graph(PCGraph.from_json(jm.graph.to_json()), FFConfig(batch_size=8),
                               seed=jm._seed, device="cpu")
        return m.compile(optimizer=SGDOptimizer(lr=0.05), loss_type=types.LossType.MEAN_SQUARED_ERROR,
                         outputs=m.output_tensors([(t.node.guid, t.idx) for t in jm._outputs]))

    tm, clean = native(), native()
    reports = []
    for pkg, plan, model, trainer, side in (
            ("jax", jfaults.FaultPlan(), jm, JElasticTrainer, True),
            ("port", faults.FaultPlan(), tm, ElasticTrainer, False)):
        plan.on("elastic.step", mode="error", error=RuntimeError("device lost"),
                when=lambda step: step == 3, max_fires=1)
        with plan.active():
            reports.append(trainer(model, str(tmp_path / pkg), checkpoint_every=5,
                                   sleep=lambda s: None).run(_batches(side), num_steps=6))
    assert _report(reports[1]) == _report(reports[0])
    assert reports[1].restarts == 1 and "device lost" in reports[1].failures[0]
    ElasticTrainer(clean, str(tmp_path / "clean"), checkpoint_every=5).run(_batches(False),
                                                                           num_steps=6)
    for layer in ("f1", "f2"):
        for w in ("kernel", "bias"):
            np.testing.assert_array_equal(tm.get_weight(layer, w), clean.get_weight(layer, w))
    tm = port(jm)

    def poisoned(jax_side):
        def batches(step):
            x, y = np.full((8, 16), np.nan, np.float32), np.zeros((8, 16), np.float32)
            return ([jnp.asarray(x)], jnp.asarray(y)) if jax_side else ([x], y)
        return batches

    backoffs = []
    for model, trainer, side, d in ((jm, JElasticTrainer, True, "je"),
                                    (tm, ElasticTrainer, False, "te")):
        t = trainer(model, str(tmp_path / d), checkpoint_every=2, max_restarts=2,
                    sleep=backoffs.append)
        with pytest.raises(RuntimeError, match="exhausted 2 restarts"):
            t.run(poisoned(side), num_steps=4)
    assert backoffs[:2] == backoffs[2:] and len(backoffs) == 4


# ----------------------------------------------------------------- graph
GRAPH_NAMES = ["bert", "resnet50", "moe"]


def _guids(nodes):
    return [n.guid for n in nodes]


def _edges(g):
    return sorted((e.src, e.dst, e.src_idx, e.dst_idx) for n in g.nodes for e in g.out_edges(n))


@pytest.mark.parametrize("name", GRAPH_NAMES)
def test_graph_queries_match_jax(graphs, name):
    """len, membership, predecessors and successors, sources and sinks,
    ancestors and descendants, bottleneck nodes and the DOT text."""
    jg, tg = graphs[name]
    assert len(tg) == len(jg) and 10 ** 9 not in tg
    assert all(n in tg and n.guid in tg for n in tg.nodes.values())
    for g in tg.nodes:
        assert _guids(tg.predecessors(g)) == _guids(jg.predecessors(g))
        assert _guids(tg.successors(tg.nodes[g])) == _guids(jg.successors(jg.nodes[g]))
        assert tg.ancestors(g) == jg.ancestors(g) and tg.descendants(g) == jg.descendants(g)
    assert _guids(tg.source_nodes()) == _guids(jg.source_nodes())
    assert _guids(tg.sink_nodes()) == _guids(jg.sink_nodes())
    assert _guids(tg.bottleneck_nodes()) == _guids(jg.bottleneck_nodes())
    assert tg.to_dot() == jg.to_dot()
    label = lambda n: f"{n.name}:{n.guid}"
    assert tg.to_dot(label_fn=label) == jg.to_dot(label_fn=label)


@pytest.mark.parametrize("name", GRAPH_NAMES)
def test_graph_algorithms_match_jax(graphs, name):
    """copy, subgraph, split_at_node at a bottleneck (the node in both
    halves), and the same mutations (remove_edge, replace_edge_src,
    remove_node) on both packages' copies: the same nodes and edges."""
    jg, tg = graphs[name]
    tc, jc = tg.copy(), jg.copy()
    assert tc.to_json() == tg.to_json() and tc is not tg
    order = _guids(tg.topo_order())
    keep = order[: len(order) // 2]
    assert _edges(tg.subgraph(keep)) == _edges(jg.subgraph(keep))
    assert sorted(tg.subgraph(keep).nodes) == sorted(jg.subgraph(keep).nodes)
    bott = tg.bottleneck_nodes()
    mid = bott[len(bott) // 2]
    for th, jh in zip(tg.split_at_node(mid), jg.split_at_node(jg.nodes[mid.guid])):
        assert sorted(th.nodes) == sorted(jh.nodes) and mid.guid in th
        assert _edges(th) == _edges(jh)
    # mutations, in the same order on both copies
    node = tc.nodes[order[len(order) // 2]]
    e = tc.in_edges(node)[0]
    je = jc.in_edges(node.guid)[0]
    src2 = order[0]
    tc.replace_edge_src(e, src2, 0)
    jc.replace_edge_src(je, src2, 0)
    last = tc.out_edges(order[1])
    if last:
        tc.remove_edge(last[0])
        jc.remove_edge(jc.out_edges(order[1])[0])
    tc.remove_node(order[-1])
    jc.remove_node(order[-1])
    assert _edges(tc) == _edges(jc) and sorted(tc.nodes) == sorted(jc.nodes)
    assert order[-1] not in tc and len(tc) == len(tg) - 1
    assert tg.to_json() == jg.to_json()  # the originals untouched


def test_structural_and_param_hashes_agree_with_jax_on_equality(graphs):
    """Over the graphs, their copies, a rebuilt BERT (other guids), a
    subgraph and a mutated copy: structural_hash equal exactly where
    JAX's are equal; param_hash over every pair of nodes likewise."""
    cfg = JFFConfig(batch_size=2, workers_per_node=1)
    rebuilt = _small_bert(cfg).graph
    pairs = [(jg, tg) for jg, tg in graphs.values()]
    pairs.append((rebuilt, PCGraph.from_json(rebuilt.to_json())))
    pairs += [(jg.copy(), tg.copy()) for jg, tg in pairs[:2]]
    jg, tg = graphs["bert"]
    keep = _guids(tg.topo_order())[:7]
    pairs.append((jg.subgraph(keep), tg.subgraph(keep)))
    jm, tmut = jg.copy(), tg.copy()
    last = tg.topo_order()[-1].guid
    jm.remove_node(last)
    tmut.remove_node(last)
    pairs.append((jm, tmut))
    jh = [g.structural_hash() for g, _ in pairs]
    th = [g.structural_hash() for _, g in pairs]
    eq = lambda hs: [[a == b for b in hs] for a in hs]
    assert eq(th) == eq(jh)
    # copies and the rebuilt BERT (other guids) hash as their originals
    assert th[0] == th[6] and th[1] == th[7] == th[5] != th[8]
    jn = [n.param_hash() for n in jg.topo_order()]
    tn = [n.param_hash() for n in tg.topo_order()]
    assert eq(tn) == eq(jn)
    assert any(a == b for a, b in itertools.combinations(tn, 2))  # repeated layers hash equal


def test_get_output_and_num_layers_match_jax():
    cfg = JFFConfig(batch_size=2, workers_per_node=1)
    jm = every_op(JFFModel(cfg), jtypes)
    tm = FFModel.from_graph(PCGraph.from_json(jm.graph.to_json()), FFConfig(batch_size=2),
                            device="cpu")
    assert tm.num_layers() == jm.num_layers() > 40
    jm2 = jbuild_moe_mlp(cfg, **MOE)
    tm2 = FFModel.from_graph(PCGraph.from_json(jm2.graph.to_json()), FFConfig(batch_size=2),
                             device="cpu")
    jo, to = jm2.get_output(), tm2.get_output()
    assert (to.node.guid, to.idx, to.shape) == (jo.node.guid, jo.idx, jo.shape)
    tm2.compile(optimizer=SGDOptimizer(lr=0.1),
                loss_type=types.LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
                outputs=tm2.output_tensors([(to.node.guid, 0)]))
    assert tm2.get_output().node.guid == to.node.guid
