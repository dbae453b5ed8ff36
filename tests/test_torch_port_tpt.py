"""Tensor-parallel training in the port (``runtime/tensor_parallel.py``)
on 2 and 4 CPU ranks over gloo, against the JAX package's GSPMD steps of
the same strategy on its virtual CPU devices (``tests/conftest.py``).

Every JAX model's graph comes into the port through its JSON (the same
guids: dropout folds the same guid into the step key) with its initial
weights by layer name; the port compiles the same strategy
(``megatron_strategy`` with ``sp`` off and on, ``dp x tp``, a strategy
file, the lowering of the search's parameter-parallel rewrites). Gates:
losses rtol 1e-5 and parameters atol 1e-5 against JAX and against the
port's one-device run (float32 in another summation order: a rank sums
its heads' or its rows' partial products, XLA its own way); bfloat16 at
the bf16 gates (losses within 2^-8, each parameter within 2 ulps + 1/8
of its tensor's update); ZeRO-1 against the replicated run bit for bit;
the ranks that hold one shard bit-identical after every step. One mesh
of 2 ranks and one of 4 serve every model of the module.
"""
import dataclasses
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.config import FFConfig as JFFConfig
from flexflow_tpu.core.types import ActiMode as JActiMode
from flexflow_tpu.core.types import DataType as JDataType
from flexflow_tpu.core.types import LossType as JLossType
from flexflow_tpu.core.types import MetricsType as JMetricsType
from flexflow_tpu.model import FFModel as JFFModel
from flexflow_tpu.models.transformer import TransformerConfig as JTransformerConfig
from flexflow_tpu.models.transformer import build_transformer as jbuild_transformer
from flexflow_tpu.parallel.strategy import ParallelStrategy as JParallelStrategy
from flexflow_tpu.parallel.strategy import megatron_strategy as jmegatron_strategy
from flexflow_tpu.runtime.optimizers import SGDOptimizer as JSGDOptimizer
from flexflow_tpu.search.substitution import (
    create_partition_linear_combine,
    create_replicate_linear_combine,
)
from flexflow_tpu.search.unity import strategy_from_pcg as jstrategy_from_pcg
from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.core.graph import PCGraph
from flexflow_tpu_torch.core.types import AggrMode, LossType, MetricsType, OpType
from flexflow_tpu_torch.generation import prng
from flexflow_tpu_torch.model import FFModel
from flexflow_tpu_torch.models import TransformerConfig, build_transformer
from flexflow_tpu_torch.obs.truth import GLOBAL_LEDGER
from flexflow_tpu_torch.ops.base import LowerCtx
from flexflow_tpu_torch.ops.embedding import EmbeddingOp, EmbeddingParams, lookup
from flexflow_tpu_torch.parallel.mesh import data_parallel_mesh, tensor_parallel_mesh
from flexflow_tpu_torch.parallel.strategy import (
    ParallelStrategy,
    context_parallel_strategy,
    expert_parallel_strategy,
    megatron_strategy,
    pipeline_strategy,
)
from flexflow_tpu_torch.runtime import AdamOptimizer, SGDOptimizer
from flexflow_tpu_torch.runtime.tensor_parallel import P, R
from torch_port_cnn import carry, named

pytestmark = pytest.mark.torch_port

U = 2.0 ** -8  # bf16 unit roundoff
TKW = dict(num_layers=2, hidden_size=64, num_heads=4, ff_size=128, seq_length=16)
DKW = dict(num_layers=2, hidden_size=32, num_heads=2, ff_size=64, seq_length=8, dropout=0.1,
           vocab_size=40, num_classes=2)
MSE = (JLossType.MEAN_SQUARED_ERROR, LossType.MEAN_SQUARED_ERROR)


@pytest.fixture(scope="module")
def mesh2():
    m = tensor_parallel_mesh(2, devices=["cpu"] * 2, timeout_s=60)
    yield m
    m.close()


@pytest.fixture(scope="module")
def mesh4():
    m = tensor_parallel_mesh(2, dp=2, devices=["cpu"] * 4, timeout_s=60)
    yield m
    m.close()


def port_of(jm, config, mesh, optimizer, loss_type, metrics=(), strategy=None):
    """The JAX model's graph and weights in the port on ``mesh`` (None:
    one CPU device), compiled with ``strategy`` (a function of the port's
    graph, or None)."""
    kw = dict(mesh=mesh) if mesh is not None else dict(device="cpu")
    tm = FFModel.from_graph(PCGraph.from_json(jm.graph.to_json()), config, seed=jm._seed, **kw)
    tm.compile(optimizer=optimizer, loss_type=loss_type, metrics=list(metrics),
               outputs=tm.output_tensors([(t.node.guid, t.idx) for t in jm._outputs]),
               strategy=None if strategy is None else strategy(tm.graph))
    carry(jm, tm)
    return tm


def assert_shards_identical(tm):
    """The ranks of one model coordinate hold the same bits, and every
    rank the same replicated weights."""
    info = tm.executor.rank_info()
    for m in {i["model_rank"] for i in info}:
        assert len({i["params_sha"] for i in info if i["model_rank"] == m}) == 1, m
    assert len({i["replicated_sha"] for i in info}) == 1
    return info


def assert_params(jm, tm, atol=1e-5):
    for layer, ws in named(jm, jm.executor.params).items():
        for name, arr in ws.items():
            np.testing.assert_allclose(tm.get_weight(layer, name), np.asarray(arr, np.float32),
                                       atol=atol, rtol=0, err_msg=f"{layer}.{name}")


def port_alone(graph, config, mesh, optimizer, strategy=None):
    """A port model of ``graph`` (the port's own, no JAX model behind it)
    on ``mesh`` (None: one CPU device), MSE: models of one graph and seed
    start from the same weights."""
    kw = dict(mesh=mesh) if mesh is not None else dict(device="cpu")
    m = FFModel.from_graph(graph, config, seed=3, **kw)
    m.compile(optimizer=optimizer, loss_type=MSE[1],
              strategy=None if strategy is None else strategy(graph))
    return m


def weight_names(m):
    """(layer name, weight name) of every parameter of a port model."""
    return [(layer, n) for layer, key in m.executor._by_name.items()
            for n in m.executor.params.get(key, {})]


def _jtransformer(strategy, batch=8, **kw):
    jm = jbuild_transformer(JFFConfig(batch_size=batch), JTransformerConfig(**TKW, **kw))
    jm.compile(optimizer=JSGDOptimizer(lr=0.05), loss_type=MSE[0],
               metrics=[JMetricsType.MEAN_SQUARED_ERROR], strategy=strategy(jm.graph))
    return jm


# -------------------------------------------------- megatron on the transformer
@pytest.mark.parametrize("dp,sp", [(1, False), (1, True), (2, False)],
                         ids=["tp2", "tp2_sp", "dp2_tp2"])
def test_megatron_steps_match_jax(dp, sp, mesh2, mesh4, tmp_path):
    """``test_megatron_matches_dp``'s shape (2 layers, batch 8, MSE, 3 SGD
    steps) under ``megatron_strategy(dp, tp=2, sp)`` in both packages;
    the dp x tp case imports JAX's strategy from its file."""
    jm = _jtransformer(lambda g: jmegatron_strategy(g, dp=dp, tp=2, sp=sp))
    assert dict(jm.mesh.shape) == ({"model": 2} if dp == 1 else {"data": 2, "model": 2})
    mesh = mesh2 if dp == 1 else mesh4
    cfg = FFConfig(batch_size=8)
    if dp == 2:
        path = tmp_path / "strategy.json"
        path.write_text(jmegatron_strategy(jm.graph, dp=2, tp=2).to_json())
        cfg = dataclasses.replace(cfg, import_strategy_file=str(path))
        strategy = None
    else:
        strategy = lambda g: megatron_strategy(g, dp=dp, tp=2, sp=sp)  # noqa: E731
    tm = port_of(jm, cfg, mesh, SGDOptimizer(lr=0.05), MSE[1],
                 [MetricsType.MEAN_SQUARED_ERROR], strategy)
    one = port_of(jm, FFConfig(batch_size=8), None, SGDOptimizer(lr=0.05), MSE[1],
                  [MetricsType.MEAN_SQUARED_ERROR])
    try:
        assert tm.mesh is mesh and tm.strategy.axis_sizes == {"data": dp, "model": 2}
        rs = np.random.RandomState(0)
        x = rs.randn(8, 16, 64).astype(np.float32)
        y = rs.randn(8, 16, 64).astype(np.float32)
        for _ in range(3):
            jl = jm.executor.train_batch([jnp.asarray(x)], jnp.asarray(y), jax.random.key(42))
            tl = tm.executor.train_batch([x], y, rng=prng.key(42))
            ol = one.executor.train_batch([x], y, rng=prng.key(42))
            for k in ("loss", "mse_loss"):
                np.testing.assert_allclose(float(tl[k]), float(jl[k]), rtol=1e-5)
                np.testing.assert_allclose(float(tl[k]), float(ol[k]), rtol=1e-5)
            info = assert_shards_identical(tm)
        assert_params(jm, tm)
        for layer, ws in named(jm, jm.executor.params).items():
            for name in ws:
                np.testing.assert_allclose(tm.get_weight(layer, name),
                                           one.get_weight(layer, name), atol=1e-5, rtol=0)
        # every block weight shards: a rank holds about half of N=1's bytes
        whole = sum(t.numel() * 4 for g in one.executor.params.values() for t in g.values())
        for i in info:
            assert 0.45 * whole < i["param_bytes"] < 0.55 * whole
        assert all(i["collectives"]["all_gather"] > 0 for i in info)
        # the truth ledger: the strategy's predicted step on its 2 or 4
        # devices, and the sampled steps measured beside it
        e = next(e for e in GLOBAL_LEDGER.report()["entries"]
                 if e["key"] == f"{tm.executor._prog_ns}.train_step")
        assert e["predicted_s"] > 0 and e["pairs"] == 2
        if sp:
            # LayerNorm ran on its sequence block: its gradients summed over the model axis
            lns = [n for n in tm.graph.nodes.values() if n.op_type == OpType.LAYERNORM]
            assert all(tm.executor.layout.nodes[n.guid].model_sum for n in lns)
            assert all(tm.executor.layout.nodes[n.guid].outputs == [1] for n in lns)
        if dp == 2:
            np.testing.assert_allclose(tm.predict(x).numpy(), np.asarray(jm.predict(x)),
                                       atol=1e-5, rtol=1e-5)
            ev_j, ev_t = jm.evaluate(x, y, batch_size=8), tm.evaluate(x, y, batch_size=8)
            np.testing.assert_allclose(ev_t.mse_loss, ev_j.mse_loss, rtol=1e-5)
    finally:
        tm.close()


# ------------------------------------------------------------------ bf16
def test_bf16_tp2_steps_match_jax_at_the_bf16_gates(mesh2):
    """A bf16 transformer under ``megatron_strategy(1, 2)``: partials and
    gathers move in bfloat16; 3 SGD steps against JAX's at the bf16
    gates."""
    jm = _jtransformer(lambda g: jmegatron_strategy(g, dp=1, tp=2), dtype=JDataType.BFLOAT16)
    tm = port_of(jm, FFConfig(batch_size=8), mesh2, SGDOptimizer(lr=0.05), MSE[1],
                 [MetricsType.MEAN_SQUARED_ERROR], lambda g: megatron_strategy(g, dp=1, tp=2))
    try:
        p0 = {layer: {n: a.astype(np.float32) for n, a in ws.items()}
              for layer, ws in named(jm, jm.executor.params).items()}
        rs = np.random.RandomState(1)
        for s in range(3):
            x, y = (np.asarray(jnp.asarray(rs.randn(8, 16, 64), jnp.bfloat16)) for _ in range(2))
            jl = jm.executor.train_batch([jnp.asarray(x)], jnp.asarray(y), jax.random.key(s))
            tl = tm.executor.train_batch([x], y, rng=prng.key(s))
            np.testing.assert_allclose(float(tl["loss"]), float(jl["loss"]), rtol=U)
            assert_shards_identical(tm)
        for layer, ws in named(jm, jm.executor.params).items():
            for name, arr in ws.items():
                got, want = tm.get_weight(layer, name), arr.astype(np.float32)
                a = np.maximum(np.maximum(np.abs(got), np.abs(want)), 1e-30)
                ulp = 2.0 ** (np.floor(np.log2(a)) - 7)
                tol = 2 * ulp + np.abs(want - p0[layer][name]).max() / 8
                bad = np.abs(got - want) > tol
                assert not bad.any(), f"{layer}.{name}: {int(bad.sum())} beyond the bf16 gate"
    finally:
        tm.close()


# ------------------------------------------------------ BERT-CLS with dropout
def test_bert_cls_with_dropout_and_row_sharded_embedding_matches_jax(mesh2):
    """BERT-CLS (vocab 40: ``tok_embed``'s rows sharded, 20 a rank) with
    dropout 0.1 under ``megatron_strategy(1, 2)``: every model rank draws
    JAX's whole masks; three steps on ids in both ranks' ranges."""
    jm = jbuild_transformer(JFFConfig(batch_size=4), JTransformerConfig(**DKW))
    jm.compile(optimizer=JSGDOptimizer(lr=0.05),
               loss_type=JLossType.SPARSE_CATEGORICAL_CROSSENTROPY,
               metrics=[JMetricsType.ACCURACY], strategy=jmegatron_strategy(jm.graph, 1, 2))
    tm = port_of(jm, FFConfig(batch_size=4), mesh2, SGDOptimizer(lr=0.05),
                 LossType.SPARSE_CATEGORICAL_CROSSENTROPY, [MetricsType.ACCURACY],
                 lambda g: megatron_strategy(g, dp=1, tp=2))
    try:
        emb = next(n for n in tm.graph.nodes.values() if n.name == "tok_embed")
        lay = tm.executor.layout.nodes[emb.guid]
        assert lay.sharded == {"embedding": 0} and lay.produced == [P] and lay.outputs == [R]
        x = np.random.RandomState(9).randint(0, 40, (4, 8)).astype(np.int32)
        ranks = tm.executor.dropout_masks([x], prng.key(77))
        sites = [n.guid for n in tm.graph.topo_order() if n.op_type == OpType.DROPOUT
                 or (n.op_type == OpType.MULTIHEAD_ATTENTION and n.params.dropout > 0)]
        assert len(ranks[0]) == len(ranks[1]) == len(sites) == 2 * DKW["num_layers"]
        for i, guid in enumerate(sites):
            want = jax.random.bernoulli(jax.random.fold_in(jax.random.key(77), guid), 0.9,
                                        tuple(ranks[0][i].shape))
            for r in ranks:
                assert np.array_equal(r[i].numpy(), np.asarray(want))
        rs = np.random.RandomState(3)
        for s in range(3):
            x = rs.randint(0, 40, (4, 8)).astype(np.int32)
            assert (x < 20).any() and (x >= 20).any()
            y = rs.randint(0, 2, (4, 1)).astype(np.int32)
            jl = jm.executor.train_batch([jnp.asarray(x)], jnp.asarray(y), jax.random.key(10 + s))
            tl = tm.executor.train_batch([x], y, rng=prng.key(10 + s))
            np.testing.assert_allclose(float(tl["loss"]), float(jl["loss"]), rtol=1e-5)
            assert int(tl["correct"]) == int(jl["correct"])
        assert_shards_identical(tm)
        assert_params(jm, tm)
    finally:
        tm.close()


def test_row_sharded_embedding_parts_sum_to_the_lookup():
    """Each rank's part of a row-sharded lookup (ids in both ranks'
    ranges, negative ids, one outside the table) and of a SUM bag: the
    parts sum to the whole table's lookup, NaN where ``jnp.take`` fills."""

    class Group:
        size = 2

    table = torch.randn(10, 3)
    ids = torch.tensor([[0, 4, 5, 9], [-1, -6, 3, 10]])
    for aggr in (AggrMode.NONE, AggrMode.SUM, AggrMode.AVG):
        p = EmbeddingParams(num_entries=10, out_dim=3, aggr=aggr)
        whole = EmbeddingOp.lower(p, [ids], {"embedding": table}, LowerCtx())[0]
        parts = [EmbeddingOp.lower(p, [ids], {"embedding": table[5 * r:5 * r + 5]},
                                   LowerCtx(model_rank=r, model_group=Group(),
                                            sharded={"embedding": 0}))[0] for r in range(2)]
        got = parts[0] + parts[1]
        assert torch.equal(torch.isnan(got), torch.isnan(whole))
        ok = ~torch.isnan(whole)
        torch.testing.assert_close(got[ok], whole[ok], rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(torch.isnan(lookup(table, ids))[1, 3].numpy(), [True] * 3)


# ------------------------------------------ searched layouts and partials
def _jmlp_rewritten():
    """An MLP rewritten by the search's parameter-parallel xfers: f1 column
    parallel (Replicate -> f1 -> Combine), f2 (no bias) row parallel
    (Repartition -> f2 -> Reduction)."""
    jm = JFFModel(JFFConfig(batch_size=16))
    x = jm.create_tensor((16, 32), name="x")
    t = jm.dense(x, 64, JActiMode.RELU, name="f1")
    t = jm.dense(t, 64, use_bias=False, name="f2")
    t = jm.dense(t, 8, name="out")
    jm.softmax(t, name="sm")
    for xfer, layer in ((create_replicate_linear_combine(2), "f1"),
                        (create_partition_linear_combine(2), "f2")):
        match = next(m for m in xfer.find_matches(jm.graph) if m[0].name == layer)
        jm.graph = xfer.apply(jm.graph, match)
    return jm


def _hand_strategy(graph, f2_out=None) -> str:
    """A strategy file written by hand: f1's kernel and bias sharded on
    ``model`` (columns), f2's kernel rows; f2's output spec ``f2_out``
    (None: unconstrained, a partial) and the Reduction's replicated."""
    node = {n.name: n for n in graph.nodes.values() if n.name}
    red = next(n for n in graph.nodes.values() if n.op_type.value == "reduction")
    nodes = {
        str(node["f1"].guid): {"outputs": [[[], ["model"]]],
                               "weights": {"kernel": [[], ["model"]], "bias": [["model"]]}},
        str(node["f2"].guid): {"outputs": [f2_out], "weights": {"kernel": [["model"], []]}},
        str(red.guid): {"outputs": [[[], []]], "weights": {}},
    }
    return json.dumps({"axis_sizes": {"data": 1, "model": 2}, "pipeline": None,
                       "node_names": {g: n for g, n in ((str(v.guid), k) for k, v in node.items())},
                       "nodes": nodes})


@pytest.mark.parametrize("kind", ["searched_lowering", "hand_built_file", "scattered"])
def test_reduction_fed_by_a_row_parallel_partial_reduces_once(kind, mesh2):
    """The search's rewrites lowered by ``strategy_from_pcg`` (the Unity
    search's own lowering), and a hand-built strategy JSON, in both
    packages: f2's partial reaches its Reduction node unreduced and is
    summed there once (twice would double the logits). ``scattered``: f2's
    spec shards its last dim, so its partial is reduce-scattered there and
    the Reduction gathers the blocks."""
    jm = _jmlp_rewritten()
    if kind == "searched_lowering":
        text = jstrategy_from_pcg(jm.graph, {}, 2).to_json()
    else:
        text = _hand_strategy(jm.graph, [[], ["model"]] if kind == "scattered" else None)
    jm.compile(optimizer=JSGDOptimizer(lr=0.1), loss_type=JLossType.SPARSE_CATEGORICAL_CROSSENTROPY,
               strategy=JParallelStrategy.from_json(text))
    assert dict(jm.mesh.shape) == {"model": 2}
    loss = LossType.SPARSE_CATEGORICAL_CROSSENTROPY
    tm = port_of(jm, FFConfig(batch_size=16), mesh2, SGDOptimizer(lr=0.1), loss,
                 strategy=lambda g: ParallelStrategy.from_json(text))
    one = port_of(jm, FFConfig(batch_size=16), None, SGDOptimizer(lr=0.1), loss)
    try:
        lay = tm.executor.layout
        f2 = next(n for n in tm.graph.nodes.values() if n.name == "f2")
        red = next(n for n in tm.graph.nodes.values() if n.op_type == OpType.REDUCTION)
        assert lay.nodes[f2.guid].sharded == {"kernel": 0}
        assert lay.nodes[f2.guid].produced == [P]
        have = 1 if kind == "scattered" else P
        assert lay.nodes[f2.guid].outputs == [have]
        assert lay.nodes[red.guid].produced == [have] and lay.nodes[red.guid].outputs == [R]
        rs = np.random.RandomState(5)
        for s in range(3):
            x = rs.randn(16, 32).astype(np.float32)
            y = rs.randint(0, 8, (16,)).astype(np.int32)
            jl = jm.executor.train_batch([jnp.asarray(x)], jnp.asarray(y), jax.random.key(s))
            tl = tm.executor.train_batch([x], y, rng=prng.key(s))
            ol = one.executor.train_batch([x], y, rng=prng.key(s))
            np.testing.assert_allclose(float(tl["loss"]), float(jl["loss"]), rtol=1e-5)
            np.testing.assert_allclose(float(tl["loss"]), float(ol["loss"]), rtol=1e-5)
        info = assert_shards_identical(tm)
        if kind == "scattered":
            assert all(i["collectives"]["reduce_scatter"] == 3 for i in info)
        assert_params(jm, tm)
    finally:
        tm.close()


# ------------------------------------------------------------------ ZeRO-1
def test_zero1_dp2_tp2_is_the_replicated_run_bit_for_bit(mesh4):
    """Adam under ``megatron_strategy(2, 2)`` with ``zero_optimizer`` on
    and off: the same losses and parameters bit for bit; each moment
    sharded as the JAX executor's rule says (its model dim, then the
    first free dim the data axis divides); the gathered moments equal."""
    graph = build_transformer(FFConfig(batch_size=8), TransformerConfig(**TKW), device="cpu").graph
    runs = {z: port_alone(graph, FFConfig(batch_size=8, zero_optimizer=z), mesh4,
                          AdamOptimizer(alpha=0.01), lambda g: megatron_strategy(g, dp=2, tp=2))
            for z in (True, False)}
    try:
        zx = runs[True].executor
        for k, ws in zx.params.items():
            for n, p in ws.items():
                md, d = zx.layout.weight_dims[k][n], zx._zero_dims[k][n]
                assert d is None or (d != md and p.shape[d] % 2 == 0)
                want = list(p.shape)
                if d is not None:
                    want[d] //= 2
                assert list(zx.opt_state["m"][k][n].shape) == want
        rs = np.random.RandomState(0)
        for s in range(3):
            x, y = rs.randn(8, 16, 64).astype(np.float32), rs.randn(8, 16, 64).astype(np.float32)
            lz, lr_ = (float(runs[z].executor.train_batch([x], y, rng=prng.key(s))["loss"])
                       for z in (True, False))
            assert lz == lr_
        a, b = (runs[z].executor.whole_params() for z in (True, False))
        for k in a:
            for n in a[k]:
                assert torch.equal(a[k][n], b[k][n])
        wa, wb = (runs[z].executor.full_opt_state() for z in (True, False))
        for f in ("m", "v"):
            for k in wb[f]:
                for n in wb[f][k]:
                    assert torch.equal(wa[f][k][n], wb[f][k][n])
        for z in (True, False):
            assert_shards_identical(runs[z])
        zb = [i["moment_bytes"] for i in runs[True].executor.rank_info()]
        rb = [i["moment_bytes"] for i in runs[False].executor.rank_info()]
        assert all(z < r for z, r in zip(zb, rb))
    finally:
        for m in runs.values():
            m.close()


# --------------------------------------------------------------- checkpoints
def test_tp2_checkpoint_restores_at_one_device_and_at_dp2(mesh2, tmp_path):
    """A checkpoint written at tp=2 (Adam) holds whole tensors (a restore
    checks every leaf's whole shape); restored at N=1 and at data
    parallel over 2 ranks, the next step equals tp=2's; and one-device
    and data-parallel checkpoints restore at tp=2."""
    graph = build_transformer(FFConfig(batch_size=8), TransformerConfig(**TKW), device="cpu").graph
    opt = lambda: AdamOptimizer(alpha=0.01)  # noqa: E731
    tp = port_alone(graph, FFConfig(batch_size=8), mesh2, opt(),
                    lambda g: megatron_strategy(g, dp=1, tp=2))
    one = port_alone(graph, FFConfig(batch_size=8), None, opt())
    dmesh = data_parallel_mesh(2, ["cpu"] * 2, timeout_s=60)
    dp = port_alone(graph, FFConfig(batch_size=8), dmesh, opt())
    try:
        rs = np.random.RandomState(4)
        xs = rs.randn(3, 8, 16, 64).astype(np.float32)
        for s in range(2):
            tp.executor.train_batch([xs[s]], xs[s], rng=prng.key(s))
        tp.save_checkpoint(str(tmp_path / "tp"), step=2)
        want = float(tp.executor.train_batch([xs[2]], xs[2], rng=prng.key(2))["loss"])
        for m in (one, dp):
            assert m.load_checkpoint(str(tmp_path / "tp")) == 2
            got = float(m.executor.train_batch([xs[2]], xs[2], rng=prng.key(2))["loss"])
            np.testing.assert_allclose(got, want, rtol=1e-5)
        one.save_checkpoint(str(tmp_path / "one"), step=3)
        assert tp.load_checkpoint(str(tmp_path / "one")) == 3
        assert_shards_identical(tp)
        for layer, n in weight_names(one):
            assert np.array_equal(tp.get_weight(layer, n), one.get_weight(layer, n))
        a = float(tp.executor.train_batch([xs[0]], xs[1], rng=prng.key(5))["loss"])
        b = float(one.executor.train_batch([xs[0]], xs[1], rng=prng.key(5))["loss"])
        np.testing.assert_allclose(a, b, rtol=1e-5)
        # and from data parallel over 2 ranks to tp=2
        dp.save_checkpoint(str(tmp_path / "dp"), step=4)
        assert tp.load_checkpoint(str(tmp_path / "dp")) == 4
        a = float(tp.executor.train_batch([xs[1]], xs[0], rng=prng.key(6))["loss"])
        b = float(dp.executor.train_batch([xs[1]], xs[0], rng=prng.key(6))["loss"])
        np.testing.assert_allclose(a, b, rtol=1e-5)
    finally:
        for m in (tp, dp):
            m.close()
        dmesh.close()


# ------------------------------------------------- fit, windows, accumulation
def test_fit_windows_and_accumulation_at_dp2_tp2(mesh4):
    """``fit`` ships each rank its rows (the data coordinate's), with
    ``grad_accum_steps=2``: two steps a window equal one a window bit for
    bit, and both the one-device run within rtol 1e-5."""
    graph = build_transformer(FFConfig(batch_size=8), TransformerConfig(**TKW), device="cpu").graph
    cfg = FFConfig(batch_size=8, grad_accum_steps=2)
    runs = [port_alone(graph, cfg, mesh4, SGDOptimizer(lr=0.05),
                       lambda g: megatron_strategy(g, dp=2, tp=2)) for _ in range(2)]
    one = port_alone(graph, cfg, None, SGDOptimizer(lr=0.05))
    try:
        rs = np.random.RandomState(6)
        X, Y = rs.randn(32, 16, 64).astype(np.float32), rs.randn(32, 16, 64).astype(np.float32)
        for m, tw in zip(runs + [one], (2, 1, 1)):
            m.fit(X, Y, epochs=1, verbose=False, trace_window=tw)
        a, b = runs
        assert a.step_losses == b.step_losses
        np.testing.assert_allclose(a.step_losses, one.step_losses, rtol=1e-5)
        assert [i["eager_window_steps"] for i in a.executor.rank_info()] == [4] * 4
        for layer, n in weight_names(one):
            assert np.array_equal(a.get_weight(layer, n), b.get_weight(layer, n))
    finally:
        for m in runs:
            m.close()


# ------------------------------------------------------------------ refusals
def test_seq_expert_and_pipe_axes_raise_after_the_device_count_check(mesh2):
    from flexflow_tpu_torch.models.moe import build_moe_mlp

    def tiny(**kw):
        return build_transformer(FFConfig(batch_size=8), TransformerConfig(**TKW), **kw)

    cases = [(lambda g: context_parallel_strategy(g, dp=1, cp=2), "'seq' axis.*item 5b", tiny),
             (lambda g: pipeline_strategy(g, pp=2), "'pipe' axis.*item 5d", tiny),
             (lambda g: expert_parallel_strategy(g, dp=1, ep=2), "'expert' axis.*item 5c",
              lambda **kw: build_moe_mlp(FFConfig(batch_size=8), in_dim=8, num_classes=4,
                                         num_experts=4, num_select=2, expert_hidden=8, **kw))]
    for strategy, match, build in cases:
        m = build(device="cpu")
        with pytest.raises(ValueError, match="^mesh needs 2 devices, have 1$"):
            m.compile(optimizer=SGDOptimizer(lr=0.1), loss_type=LossType.MEAN_SQUARED_ERROR,
                      strategy=strategy(m.graph))
        m = FFModel.from_graph(m.graph, FFConfig(batch_size=8), mesh=mesh2)
        with pytest.raises(NotImplementedError, match=match):
            m.compile(optimizer=SGDOptimizer(lr=0.1), loss_type=LossType.MEAN_SQUARED_ERROR,
                      strategy=strategy(m.graph))


def test_a_weight_layout_with_no_sharded_lowering_raises_before_any_rank_starts():
    """A linear whose kernel rows and bias are both sharded on ``model``
    (no lowering computes that layout): ``NotImplementedError`` at
    compile, and the mesh's ranks never start."""
    own = tensor_parallel_mesh(2, devices=["cpu"] * 2)
    m = FFModel(FFConfig(batch_size=8), mesh=own)
    x = m.create_tensor((8, 16))
    m.dense(x, 16, name="fc")
    st = megatron_strategy(m.graph, dp=1, tp=2)
    fc = next(n for n in m.graph.nodes.values() if n.name == "fc")
    st.node_shardings[fc.guid].weights = {"kernel": (("model",), ()), "bias": (("model",),)}
    with pytest.raises(NotImplementedError, match="no sharded lowering"):
        m.compile(optimizer=SGDOptimizer(lr=0.1), loss_type=LossType.MEAN_SQUARED_ERROR,
                  strategy=st)
    assert not own.started


def test_a_killed_rank_makes_train_batch_raise_within_the_timeout():
    own = tensor_parallel_mesh(2, devices=["cpu"] * 2, timeout_s=10)
    graph = build_transformer(FFConfig(batch_size=8), TransformerConfig(**TKW), device="cpu").graph
    m = port_alone(graph, FFConfig(batch_size=8), own, SGDOptimizer(lr=0.05),
                   lambda g: megatron_strategy(g, dp=1, tp=2))
    try:
        x = np.random.RandomState(0).randn(8, 16, 64).astype(np.float32)
        m.executor.train_batch([x], x)
        proc = own.group()._procs[0]
        proc.kill()
        proc.join(10)
        t0 = time.monotonic()
        with pytest.raises(RuntimeError):
            m.executor.train_batch([x], x)
        assert time.monotonic() - t0 < 10 + 15
    finally:
        m.close()
        own.close()


def test_tensor_parallel_mesh_takes_the_gpus_and_jaxs_device_order():
    """No CPU rank unless listed: the default devices are the GPUs; rank r
    sits at (r // tp, r % tp), the JAX package's reshape of its devices."""
    from flexflow_tpu_torch.parallel.distributed import mesh_coords

    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="^mesh needs 4 devices, have 0$"):
            tensor_parallel_mesh(2, dp=2)
    m = tensor_parallel_mesh(2, dp=2, devices=["cpu"] * 4)
    assert m.shape == {"data": 2, "model": 2} and not m.started
    assert [mesh_coords(m.shape, r) for r in range(4)] == [
        {"data": d, "model": t} for d in range(2) for t in range(2)]
    assert tensor_parallel_mesh(2, devices=["cpu"] * 2).shape == {"model": 2}
    from flexflow_tpu.parallel.mesh import build_mesh as jbuild_mesh

    devs = jax.devices()[:4]
    jm = jbuild_mesh({"data": 2, "model": 2}, devs)
    for r, d in enumerate(devs):
        (coord,) = np.argwhere(jm.devices == d)
        assert dict(zip(jm.axis_names, map(int, coord))) == mesh_coords(m.shape, r)
