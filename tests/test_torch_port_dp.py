"""Data-parallel training in the port (``runtime/data_parallel.py``) on
two CPU ranks over gloo, against the JAX package's GSPMD data
parallelism at ``workers_per_node=2`` on its virtual CPU devices.

Every JAX model's graph comes into the port through its JSON (the same
guids, so dropout folds the same guid into the step key) with its
initial weights by layer name. Gates: losses rtol 1e-5 and parameters
atol 1e-5 against JAX (float32 in another summation order: the port's
ranks all-reduce their gradients, XLA its own way); the ZeRO-1 run
against the port's replicated run, and the dropout masks against JAX's
global mask, bit for bit; the ranks' parameters bit-identical after
every step (a digest of every leaf's bytes on each rank); BatchNorm's
running statistics within 1e-6 of their largest magnitude. One group of
two ranks serves every model of the module (a second one is killed on
purpose).
"""
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.config import FFConfig as JFFConfig
from flexflow_tpu.core.types import ActiMode as JActiMode
from flexflow_tpu.core.types import LossType as JLossType
from flexflow_tpu.core.types import MetricsType as JMetricsType
from flexflow_tpu.model import FFModel as JFFModel
from flexflow_tpu.models.moe import build_moe_mlp as jbuild_moe_mlp
from flexflow_tpu.models.transformer import TransformerConfig as JTransformerConfig
from flexflow_tpu.models.transformer import build_transformer as jbuild_transformer
from flexflow_tpu.runtime.optimizers import AdamOptimizer as JAdamOptimizer
from flexflow_tpu.runtime.optimizers import SGDOptimizer as JSGDOptimizer
from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.core.graph import PCGraph
from flexflow_tpu_torch.core.types import ActiMode, LossType, MetricsType, OpType
from flexflow_tpu_torch.generation import prng
from flexflow_tpu_torch.model import FFModel
from flexflow_tpu_torch.obs.truth import GLOBAL_LEDGER
from flexflow_tpu_torch.ops.base import LowerCtx
from flexflow_tpu_torch.ops.softmax import dropout
from flexflow_tpu_torch.parallel.mesh import build_mesh, data_parallel_mesh
from flexflow_tpu_torch.parallel.propagation import infer_all_specs
from flexflow_tpu_torch.parallel.strategy import context_parallel_strategy, megatron_strategy
from flexflow_tpu_torch.runtime import AdamOptimizer, SGDOptimizer
from flexflow_tpu_torch.runtime.checkpoint import restore_checkpoint
from torch_port_cnn import carry, cnn_data, named, small_cnn

pytestmark = pytest.mark.torch_port


@pytest.fixture(scope="module")
def mesh():
    m = data_parallel_mesh(2, ["cpu", "cpu"], timeout_s=60)
    yield m
    m.close()


def port_of(jm, config, mesh, optimizer, loss_type, metrics=(), zero=False):
    """The JAX model's graph and weights (and state) in the port on
    ``mesh`` (None: one CPU device)."""
    import dataclasses

    config = dataclasses.replace(config, zero_optimizer=zero)
    kw = dict(mesh=mesh) if mesh is not None else dict(device="cpu")
    tm = FFModel.from_graph(PCGraph.from_json(jm.graph.to_json()), config, seed=jm._seed, **kw)
    tm.compile(optimizer=optimizer, loss_type=loss_type, metrics=list(metrics),
               outputs=tm.output_tensors([(t.node.guid, t.idx) for t in jm._outputs]))
    carry(jm, tm)
    return tm


def assert_ranks_identical(tm):
    info = tm.executor.rank_info()
    assert len({i["params_sha"] for i in info}) == 1, "the ranks' parameters differ"
    return info


def assert_params(jm, tm, atol=1e-5):
    for layer, ws in named(jm, jm.executor.params).items():
        for name, arr in ws.items():
            np.testing.assert_allclose(tm.get_weight(layer, name), arr, atol=atol, rtol=0,
                                       err_msg=f"{layer}.{name}")


# ------------------------------------------------------------ transformer
TKW = dict(num_layers=2, hidden_size=64, num_heads=4, ff_size=128, seq_length=16)


def test_transformer_sgd_steps_match_jax_data_parallel(mesh):
    """``test_megatron_matches_dp``'s shape: 2 layers, batch 8, MSE, 3 SGD
    steps; the JAX model trains over 2 virtual devices."""
    jm = jbuild_transformer(JFFConfig(batch_size=8, workers_per_node=2),
                            JTransformerConfig(**TKW))
    jm.compile(optimizer=JSGDOptimizer(lr=0.05), loss_type=JLossType.MEAN_SQUARED_ERROR,
               metrics=[JMetricsType.MEAN_SQUARED_ERROR])
    assert jm.mesh.shape["data"] == 2
    tm = port_of(jm, FFConfig(batch_size=8, workers_per_node=2), mesh, SGDOptimizer(lr=0.05),
                 LossType.MEAN_SQUARED_ERROR, [MetricsType.MEAN_SQUARED_ERROR])
    try:
        assert tm.mesh is mesh and tm.strategy.axis_sizes == {"data": 2}
        rs = np.random.RandomState(0)
        x = rs.randn(8, 16, 64).astype(np.float32)
        y = rs.randn(8, 16, 64).astype(np.float32)
        for i in range(3):
            jl = jm.executor.train_batch([jnp.asarray(x)], jnp.asarray(y), jax.random.key(42))
            tl = tm.executor.train_batch([x], y, rng=prng.key(42))
            np.testing.assert_allclose(float(tl["loss"]), float(jl["loss"]), rtol=1e-5)
            np.testing.assert_allclose(float(tl["mse_loss"]), float(jl["mse_loss"]), rtol=1e-5)
            assert int(tl["count"]) == 8
            info = assert_ranks_identical(tm)
        assert_params(jm, tm)
        # one flat all-reduce a step (one dtype): no per-parameter calls
        assert all(i["collectives"]["all_reduce"] == 3 for i in info)
        # each rank ran its 4 rows
        assert tm.executor.plan(8).local == 4
        # the truth ledger: the 2-device strategy's prediction, and the
        # sampled steps measured beside it (the first call traced)
        e = next(e for e in GLOBAL_LEDGER.report()["entries"]
                 if e["key"] == f"{tm.executor._prog_ns}.train_step")
        assert e["predicted_s"] > 0 and e["pairs"] == 2
    finally:
        tm.close()


# ------------------------------------------------------------------ ZeRO-1
def _jmlp(zero, batch=32):
    m = JFFModel(JFFConfig(batch_size=batch, workers_per_node=2, zero_optimizer=zero))
    x = m.create_tensor((batch, 16))
    t = m.dense(x, 64, JActiMode.RELU, name="fc1")
    t = m.dense(t, 4, name="fc2")
    m.softmax(t)
    return m


def test_zero1_matches_jax_and_the_replicated_run_bit_for_bit(mesh):
    """``tests/test_runtime_aux.py``'s ZeRO-1 case (Adam, batch 32): the
    port's losses against JAX's (rtol 1e-5), ZeRO-1 against the port's
    replicated run bit for bit, each rank's moments on JAX's dimension."""
    jm = _jmlp(True)
    jm.compile(optimizer=JAdamOptimizer(alpha=0.01),
               loss_type=JLossType.SPARSE_CATEGORICAL_CROSSENTROPY)
    cfg = FFConfig(batch_size=32, workers_per_node=2)
    runs = {z: port_of(jm, cfg, mesh, AdamOptimizer(alpha=0.01),
                       LossType.SPARSE_CATEGORICAL_CROSSENTROPY, zero=z) for z in (True, False)}
    try:
        zx = runs[True].executor
        # the JAX executor's sharding of each moment leaf: its "data" dim
        jdims = {}
        names = {f"{n.op_type.value}_{n.guid}": n.name for n in jm.graph.nodes.values()}
        for key, ws in jm.executor.opt_state["m"].items():
            for w, leaf in ws.items():
                spec = list(leaf.sharding.spec) + [None] * leaf.ndim
                jdims[(names[key], w)] = next((i for i, s in enumerate(spec[:leaf.ndim])
                                               if s == "data"), None)
        for key, ws in zx.params.items():
            layer = next(n.name for n in zx.graph.nodes.values()
                         if f"{n.op_type.value}_{n.guid}" == key)
            for w, p in ws.items():
                d = zx._zero_dims[key][w]
                assert d == jdims[(layer, w)], (layer, w)
                assert d is not None
                want = list(p.shape)
                want[d] //= 2
                assert list(zx.opt_state["m"][key][w].shape) == want
                assert list(zx.opt_state["v"][key][w].shape) == want
        rs = np.random.RandomState(0)
        X = rs.randn(32, 16).astype(np.float32)
        Y = rs.randint(0, 4, (32,)).astype(np.int32)
        for i in range(3):
            jl = float(jm.executor.train_batch([jnp.asarray(X)], jnp.asarray(Y),
                                               jax.random.key(i))["loss"])
            lz, lr_ = (float(runs[z].executor.train_batch([X], Y, rng=prng.key(i))["loss"])
                       for z in (True, False))
            np.testing.assert_allclose(lz, jl, rtol=1e-5)
            assert lz == lr_
        for z in (True, False):
            assert_ranks_identical(runs[z])
        for layer in ("fc1", "fc2"):
            for w in ("kernel", "bias"):
                assert np.array_equal(runs[True].get_weight(layer, w),
                                      runs[False].get_weight(layer, w))
        assert_params(jm, runs[True])
        # each rank holds half of the replicated moments (every leaf shards)
        zb = [i["moment_bytes"] for i in runs[True].executor.rank_info()]
        rb = [i["moment_bytes"] for i in runs[False].executor.rank_info()]
        assert zb[0] == zb[1] and 2 * zb[0] == rb[0] == rb[1]
        # the whole moments equal the replicated run's, bit for bit
        whole = runs[True].executor.full_opt_state()
        rep = runs[False].executor.opt_state
        for f in ("m", "v"):
            for key in rep[f]:
                for w in rep[f][key]:
                    assert torch.equal(whole[f][key][w], rep[f][key][w])
    finally:
        for m in runs.values():
            m.close()


# ----------------------------------------------------------------- dropout
def test_rank_masks_are_rows_of_jax_global_mask():
    """Each rank's dropout mask, drawn at its element offset, is its rows
    of the mask JAX draws at the global shape; concatenated, bit for bit."""

    class Rank:  # the part of a RankGroup the dropout reads
        def __init__(self, rank, size):
            self.rank, self.size = rank, size

    key, guid, keep = 7, 1234, 0.9
    shape = (8, 16, 32)
    want = np.asarray(jax.random.bernoulli(jax.random.fold_in(jax.random.key(key), guid),
                                           keep, shape))
    for n in (2, 4):
        parts = []
        for r in range(n):
            ctx = LowerCtx(training=True, rng=prng.key(key), group=Rank(r, n), split=True)
            ctx.node_guid = guid
            x = torch.ones((8 // n,) + shape[1:])
            parts.append((dropout(x, 1 - keep, ctx) != 0).numpy())
        assert np.array_equal(np.concatenate(parts), want)


DKW = dict(num_layers=2, hidden_size=32, num_heads=2, ff_size=64, seq_length=8, dropout=0.1,
           vocab_size=40, num_classes=2)


def test_bert_cls_with_dropout_matches_jax_data_parallel(mesh):
    """BERT-CLS (its CLS reshape holds the batch literal) with dropout 0.1
    at N=2: three steps on the same keys, losses rtol 1e-5 (a mask off
    by one element moves the loss far more), parameters atol 1e-5."""
    jm = jbuild_transformer(JFFConfig(batch_size=4, workers_per_node=2), JTransformerConfig(**DKW))
    jm.compile(optimizer=JSGDOptimizer(lr=0.05),
               loss_type=JLossType.SPARSE_CATEGORICAL_CROSSENTROPY,
               metrics=[JMetricsType.ACCURACY])
    tm = port_of(jm, FFConfig(batch_size=4, workers_per_node=2), mesh, SGDOptimizer(lr=0.05),
                 LossType.SPARSE_CATEGORICAL_CROSSENTROPY, [MetricsType.ACCURACY])
    try:
        plan = tm.executor.plan(4)
        reshape = next(n for n in tm.graph.nodes.values() if n.name == "cls_squeeze")
        assert plan.nodes[reshape.guid].params.shape == (2, 32)  # re-batched, same guid
        # the masks each rank draws, concatenated, are JAX's global masks
        x = np.random.RandomState(9).randint(0, 40, (4, 8)).astype(np.int32)
        ranks = tm.executor.dropout_masks([x], prng.key(77))
        specs = infer_all_specs(tm.graph)
        sites = [(n.guid, specs[n.guid][0].shape) for n in tm.graph.topo_order()
                 if n.op_type == OpType.DROPOUT
                 or (n.op_type == OpType.MULTIHEAD_ATTENTION and n.params.dropout > 0)]
        assert len(sites) == len(ranks[0]) == len(ranks[1]) == 2 * DKW["num_layers"]
        for i, (guid, shape) in enumerate(sites):
            want = jax.random.bernoulli(jax.random.fold_in(jax.random.key(77), guid), 0.9, shape)
            got = torch.cat([ranks[0][i], ranks[1][i]])
            assert ranks[0][i].shape[0] == 2 and np.array_equal(got.numpy(), np.asarray(want))
        rs = np.random.RandomState(3)
        for s in range(3):
            x = rs.randint(0, 40, (4, 8)).astype(np.int32)
            y = rs.randint(0, 2, (4, 1)).astype(np.int32)
            jl = jm.executor.train_batch([jnp.asarray(x)], jnp.asarray(y), jax.random.key(10 + s))
            tl = tm.executor.train_batch([x], y, rng=prng.key(10 + s))
            np.testing.assert_allclose(float(tl["loss"]), float(jl["loss"]), rtol=1e-5)
            assert int(tl["correct"]) == int(jl["correct"])
        assert_ranks_identical(tm)
        assert_params(jm, tm)
    finally:
        tm.close()


# --------------------------------------------------------------- BatchNorm
def test_cnn_batchnorm_global_statistics_match_jax(mesh):
    """The residual CNN (7 BatchNorms) at batch 8 over 2 ranks: losses
    rtol 1e-5, parameters atol 1e-5, running statistics within 1e-6 of
    their largest magnitude, as JAX's global-batch statistics give."""
    jm = small_cnn(JFFModel(JFFConfig(batch_size=8, workers_per_node=2), seed=4), 8)
    jm.compile(optimizer=JSGDOptimizer(lr=0.05, momentum=0.9),
               loss_type=JLossType.SPARSE_CATEGORICAL_CROSSENTROPY)
    tm = port_of(jm, FFConfig(batch_size=8, workers_per_node=2), mesh,
                 SGDOptimizer(lr=0.05, momentum=0.9), LossType.SPARSE_CATEGORICAL_CROSSENTROPY)
    try:
        x, y = cnn_data(5, 24)
        for s in range(3):
            sl = slice(8 * s, 8 * s + 8)
            jl = jm.executor.train_batch([jnp.asarray(x[sl])], jnp.asarray(y[sl]),
                                         jax.random.key(s))
            tl = tm.executor.train_batch([x[sl]], y[sl], rng=prng.key(s))
            np.testing.assert_allclose(float(tl["loss"]), float(jl["loss"]), rtol=1e-5)
        assert_ranks_identical(tm)
        assert_params(jm, tm)
        for layer, ws in named(jm, jm.executor.state).items():
            for name, arr in ws.items():
                tol = 1e-6 * float(np.abs(arr).max())
                np.testing.assert_allclose(tm.get_weight(layer, name), arr, atol=tol, rtol=0,
                                           err_msg=f"{layer}.{name}")
    finally:
        tm.close()


# ------------------------------------------------------ indivisible batch
def _jmlp_sgd(batch, **cfg):
    m = JFFModel(JFFConfig(batch_size=batch, workers_per_node=2, **cfg))
    x = m.create_tensor((batch, 16))
    t = m.dense(x, 32, JActiMode.RELU, name="fc1")
    t = m.dense(t, 4, name="fc2")
    m.softmax(t)
    m.compile(optimizer=JSGDOptimizer(lr=0.1, momentum=0.9),
              loss_type=JLossType.SPARSE_CATEGORICAL_CROSSENTROPY,
              metrics=[JMetricsType.ACCURACY, JMetricsType.SPARSE_CATEGORICAL_CROSSENTROPY])
    return m


def test_batch_not_divisible_by_the_ranks_gives_jax_numbers(mesh):
    """Batch 5 over 2 ranks: JAX's strategy leaves the batch unsharded;
    every port rank runs the whole batch, none dropped or padded."""
    jm = _jmlp_sgd(5)
    tm = port_of(jm, FFConfig(batch_size=5, workers_per_node=2), mesh,
                 SGDOptimizer(lr=0.1, momentum=0.9), LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
                 [MetricsType.ACCURACY, MetricsType.SPARSE_CATEGORICAL_CROSSENTROPY])
    try:
        assert not tm.executor.plan(5).split
        rs = np.random.RandomState(1)
        for s in range(3):
            x = rs.randn(5, 16).astype(np.float32)
            y = rs.randint(0, 4, (5,)).astype(np.int32)
            jl = jm.executor.train_batch([jnp.asarray(x)], jnp.asarray(y), jax.random.key(s))
            tl = tm.executor.train_batch([x], y, rng=prng.key(s))
            for k in ("loss", "sparse_cce_loss"):
                np.testing.assert_allclose(float(tl[k]), float(jl[k]), rtol=1e-5)
            assert int(tl["count"]) == 5 and int(tl["correct"]) == int(jl["correct"])
        assert_ranks_identical(tm)
        assert_params(jm, tm)
    finally:
        tm.close()


# -------------------------------------- accumulation, windows, evaluation
def test_accumulation_windows_evaluate_and_predict(mesh):
    """``grad_accum_steps=2`` at N=2 against JAX's; ``fit(trace_window=2)``
    equal to ``trace_window=1`` bit for bit (the window runs eagerly: no
    capture); ``evaluate`` and ``predict`` against JAX's."""
    jm = _jmlp_sgd(8, grad_accum_steps=2)
    cfg = FFConfig(batch_size=8, workers_per_node=2, grad_accum_steps=2)
    mets = [MetricsType.ACCURACY, MetricsType.SPARSE_CATEGORICAL_CROSSENTROPY]
    tm = port_of(jm, cfg, mesh, SGDOptimizer(lr=0.1, momentum=0.9),
                 LossType.SPARSE_CATEGORICAL_CROSSENTROPY, mets)
    runs = []
    try:
        rs = np.random.RandomState(2)
        X = rs.randn(32, 16).astype(np.float32)
        Y = rs.randint(0, 4, (32,)).astype(np.int32)
        for s in range(2):
            sl = slice(8 * s, 8 * s + 8)
            jl = jm.executor.train_batch([jnp.asarray(X[sl])], jnp.asarray(Y[sl]),
                                         jax.random.key(s))
            tl = tm.executor.train_batch([X[sl]], Y[sl], rng=prng.key(s))
            np.testing.assert_allclose(float(tl["loss"]), float(jl["loss"]), rtol=1e-5)
            np.testing.assert_allclose(float(tl["sparse_cce_loss"]),
                                       float(jl["sparse_cce_loss"]), rtol=1e-5)
        assert_params(jm, tm)
        ev_j, ev_t = jm.evaluate(X, Y, batch_size=8), tm.evaluate(X, Y, batch_size=8)
        assert ev_t.train_all == ev_j.train_all == 32
        assert ev_t.train_correct == ev_j.train_correct
        np.testing.assert_allclose(ev_t.sparse_cce_loss, ev_j.sparse_cce_loss, rtol=1e-5)
        np.testing.assert_allclose(tm.predict(X[:8]).numpy(), np.asarray(jm.predict(X[:8])),
                                   atol=1e-6, rtol=1e-5)
        # fit windows: two steps a window (eager on every rank) = one a window
        for tw in (2, 1):
            m = port_of(jm, FFConfig(batch_size=8, workers_per_node=2), mesh,
                        SGDOptimizer(lr=0.1, momentum=0.9),
                        LossType.SPARSE_CATEGORICAL_CROSSENTROPY, mets)
            runs.append(m)
            perf = m.fit(X, Y, epochs=1, verbose=False, trace_window=tw)
            assert perf.train_all == 32
        (a, b) = runs
        assert a.step_losses == b.step_losses
        for layer in ("fc1", "fc2"):
            for w in ("kernel", "bias"):
                assert np.array_equal(a.get_weight(layer, w), b.get_weight(layer, w))
        ia = assert_ranks_identical(a)
        assert [i["eager_window_steps"] for i in ia] == [4, 4]
        assert [i["graph_captures"] for i in ia] == [0, 0]
        assert [i["eager_window_steps"] for i in b.executor.rank_info()] == [0, 0]
    finally:
        for m in [tm] + runs:
            m.close()


# -------------------------------------------------------------- checkpoint
def test_zero1_checkpoint_at_two_ranks_restores_at_one(mesh, tmp_path):
    """A checkpoint written at N=2 with ZeRO-1 holds the whole moments and
    equals the one written at N=1 after the same steps (within the
    training gates); restored at N=1 it continues as the N=1 run and the
    JAX data-parallel run do."""
    jm = _jmlp(False, batch=16)
    jm.compile(optimizer=JAdamOptimizer(alpha=0.01),
               loss_type=JLossType.SPARSE_CATEGORICAL_CROSSENTROPY)
    two = port_of(jm, FFConfig(batch_size=16, workers_per_node=2), mesh,
                  AdamOptimizer(alpha=0.01), LossType.SPARSE_CATEGORICAL_CROSSENTROPY, zero=True)
    one = port_of(jm, FFConfig(batch_size=16), None, AdamOptimizer(alpha=0.01),
                  LossType.SPARSE_CATEGORICAL_CROSSENTROPY)
    back = port_of(jm, FFConfig(batch_size=16), None, AdamOptimizer(alpha=0.01),
                   LossType.SPARSE_CATEGORICAL_CROSSENTROPY)
    try:
        rs = np.random.RandomState(4)
        X = rs.randn(48, 16).astype(np.float32)
        Y = rs.randint(0, 4, (48,)).astype(np.int32)
        jl = [float(jm.executor.train_batch([jnp.asarray(X[16 * s:16 * s + 16])],
                                            jnp.asarray(Y[16 * s:16 * s + 16]),
                                            jax.random.key(s))["loss"]) for s in range(3)]
        for s in range(2):
            sl = slice(16 * s, 16 * s + 16)
            l2 = float(two.executor.train_batch([X[sl]], Y[sl], rng=prng.key(s))["loss"])
            l1 = float(one.executor.train_batch([X[sl]], Y[sl], rng=prng.key(s))["loss"])
            np.testing.assert_allclose(l2, l1, rtol=1e-5)
            np.testing.assert_allclose(l2, jl[s], rtol=1e-5)
        two.save_checkpoint(str(tmp_path / "two"), step=2)
        one.save_checkpoint(str(tmp_path / "one"), step=2)
        a = torch.load(os.path.join(tmp_path, "two", "train_state.pt"), weights_only=True)
        b = torch.load(os.path.join(tmp_path, "one", "train_state.pt"), weights_only=True)
        assert a["step"] == b["step"] == 2 and a["opt_state"]["step"] == b["opt_state"]["step"]
        for part in ("params", ("opt_state", "m"), ("opt_state", "v")):
            ta = a[part] if isinstance(part, str) else a[part[0]][part[1]]
            tb = b[part] if isinstance(part, str) else b[part[0]][part[1]]
            assert set(ta) == set(tb)
            for k in ta:
                for w in ta[k]:
                    assert ta[k][w].shape == tb[k][w].shape  # whole, not a slice
                    scale = float(tb[k][w].abs().max())
                    np.testing.assert_allclose(ta[k][w].numpy(), tb[k][w].numpy(), rtol=0,
                                               atol=1e-5 * max(scale, 1.0), err_msg=f"{k}.{w}")
        assert restore_checkpoint(str(tmp_path / "two"), back.executor) == 2
        sl = slice(32, 48)
        lb = float(back.executor.train_batch([X[sl]], Y[sl], rng=prng.key(2))["loss"])
        l1 = float(one.executor.train_batch([X[sl]], Y[sl], rng=prng.key(2))["loss"])
        np.testing.assert_allclose(lb, l1, rtol=1e-5)
        np.testing.assert_allclose(lb, jl[2], rtol=1e-5)
        # and back onto two ranks: every rank takes its slice of the file's moments
        assert two.load_checkpoint(str(tmp_path / "one")) == 2
        whole = two.executor.full_opt_state()
        for k, ws in one.executor.opt_state["m"].items():
            for w, t in ws.items():
                assert torch.equal(whole["m"][k][w], b["opt_state"]["m"][
                    next(c for c in b["opt_state"]["m"] if c.endswith(
                        next(n.name for n in one.graph.nodes.values()
                             if f"{n.op_type.value}_{n.guid}" == k)))][w])
        assert_ranks_identical(two)
    finally:
        for m in (two, one, back):
            m.close()


# --------------------------------------------------------------- refusals
def test_moe_on_two_ranks_raises(mesh):
    jm = jbuild_moe_mlp(JFFConfig(batch_size=8, workers_per_node=1), in_dim=8, num_classes=4,
                        num_experts=4, num_select=2, expert_hidden=8)
    with pytest.raises(NotImplementedError, match="expert parallelism"):
        port_of(jm, FFConfig(batch_size=8, workers_per_node=2), mesh, SGDOptimizer(lr=0.1),
                LossType.SPARSE_CATEGORICAL_CROSSENTROPY)


def test_transport_refusals():
    with pytest.raises(ValueError, match="pass backend='gloo'"):
        data_parallel_mesh(2, ["cuda:0", "cuda:0"])
    with pytest.raises(ValueError, match="pass backend='gloo'"):
        data_parallel_mesh(2, ["cuda:0", "cuda:0"], backend="nccl")
    with pytest.raises(ValueError, match="CPU ranks use backend='gloo'"):
        data_parallel_mesh(2, ["cpu", "cpu"], backend="nccl")
    # no CPU rank unless listed: the default devices are the GPUs
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="^mesh needs 2 devices, have 0$"):
            data_parallel_mesh(2)
    m = data_parallel_mesh(2, ["cuda:0", "cuda:1"])
    assert m.backend == "nccl" and not m.started
    assert build_mesh({"data": 1}, ["cpu"]) == {"data": 1}


def _tiny(config, **kw):
    m = FFModel(config, **kw)
    x = m.create_tensor((8, 16))
    t = m.dense(x, 16, ActiMode.RELU, name="fc1")
    m.dense(t, 16, name="fc2")
    return m


def test_seq_axis_raises_after_the_device_count_check(mesh):
    """A strategy with an axis the port does not train: on one device the
    JAX package's count error comes first, word for word; on two ranks a
    ``seq`` axis raises, naming ROADMAP queue 1 item 5b."""
    m = _tiny(FFConfig(batch_size=8), device="cpu")
    with pytest.raises(ValueError, match="^mesh needs 2 devices, have 1$"):
        m.compile(optimizer=SGDOptimizer(lr=0.1), loss_type=LossType.MEAN_SQUARED_ERROR,
                  strategy=megatron_strategy(m.graph, dp=1, tp=2))
    m = _tiny(FFConfig(batch_size=8), mesh=mesh)
    with pytest.raises(NotImplementedError, match="'seq' axis.*item 5b"):
        m.compile(optimizer=SGDOptimizer(lr=0.1), loss_type=LossType.MEAN_SQUARED_ERROR,
                  strategy=context_parallel_strategy(m.graph, dp=1, cp=2))
    # workers_per_node=2 on one listed device: the count error
    m = _tiny(FFConfig(batch_size=8, workers_per_node=2), device="cpu")
    with pytest.raises(ValueError, match="^mesh needs 2 devices, have 1$"):
        m.compile(optimizer=SGDOptimizer(lr=0.1), loss_type=LossType.MEAN_SQUARED_ERROR)


def test_a_killed_worker_makes_train_batch_raise_within_the_timeout():
    own = data_parallel_mesh(2, ["cpu", "cpu"], timeout_s=10)
    m = _tiny(FFConfig(batch_size=8), mesh=own)
    try:
        m.compile(optimizer=SGDOptimizer(lr=0.1), loss_type=LossType.MEAN_SQUARED_ERROR)
        rs = np.random.RandomState(0)
        x, y = rs.randn(8, 16).astype(np.float32), rs.randn(8, 16).astype(np.float32)
        m.executor.train_batch([x], y)
        proc = own.group()._procs[0]
        proc.kill()
        proc.join(10)
        t0 = time.monotonic()
        with pytest.raises(RuntimeError):
            m.executor.train_batch([x], y)
        assert time.monotonic() - t0 < 10 + 15
    finally:
        m.close()
        own.close()
