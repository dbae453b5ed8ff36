"""The executor's window path and the full FFConfig through the port
against the JAX package on the CPU.

A 2-layer narrow BERT with its CLS head and dropout 0.1 (the JAX graph
read into the port from its JSON, so each dropout node folds the same
guid into the step key, and the JAX model's weights carried over by
layer name) trains through ``fit(trace_window=4)`` over two epochs of
six batches: each epoch one traced window of four steps and two tail
steps, on the JAX package's key chain. Then ``train_batch_repeated``,
``eval_window`` and ``evaluate(trace_window=)``, each on both sides. The
learning rate changes between two windows (``set_learning_rate``) with
SGD and with Adam on the small CNN of ``tests/torch_port_cnn.py``
(BatchNorm state, dropout, no zero-gradient biases for Adam to scale).

Gates, those of ``tests/test_torch_port_training.py`` (float32, another
summation order only): every step's loss rtol 1e-5, every parameter
and running statistic atol 1e-5, the metrics' sums (correct, count)
exactly. On the CPU a window runs the eager step once a step; the
captured CUDA graph is held against the eager step on the card
(``tests/test_torch_port_cuda.py``, ``chip_smoke.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.config import FFConfig as JFFConfig
from flexflow_tpu.core.types import LossType as JLossType
from flexflow_tpu.core.types import MetricsType as JMetricsType
from flexflow_tpu.model import FFModel as JFFModel
from flexflow_tpu.models.transformer import TransformerConfig as JTransformerConfig
from flexflow_tpu.models.transformer import build_transformer as jbuild_transformer
from flexflow_tpu.runtime.optimizers import AdamOptimizer as JAdamOptimizer
from flexflow_tpu.runtime.optimizers import SGDOptimizer as JSGDOptimizer
from flexflow_tpu_torch.config import FFConfig, FFIterationConfig
from flexflow_tpu_torch.core.types import LossType, MetricsType
from flexflow_tpu_torch.generation import prng
from flexflow_tpu_torch.model import FFModel
from flexflow_tpu_torch.runtime import AdamOptimizer, SGDOptimizer, faults
from flexflow_tpu_torch.runtime.step_graph import leaf_ids

from torch_port_cnn import assert_weights_match, cnn_data, port_from_jax, small_cnn

pytestmark = pytest.mark.torch_port

KW = dict(num_layers=2, hidden_size=32, num_heads=2, ff_size=64, seq_length=8, dropout=0.1,
          vocab_size=40, num_classes=2)
BATCH, LR, STEPS, WINDOW = 4, 0.05, 6, 4
METRICS = [MetricsType.ACCURACY, MetricsType.SPARSE_CATEGORICAL_CROSSENTROPY]


def _data(seed: int, n: int):
    rs = np.random.RandomState(seed)
    x = rs.randint(0, KW["vocab_size"], (n, KW["seq_length"])).astype(np.int32)
    return x, rs.randint(0, KW["num_classes"], (n, 1)).astype(np.int32)


def _port_model():
    return FFModel(FFConfig(batch_size=BATCH), device="cpu")


def _recorded(jm):
    """The JAX executor's per-step losses, recorded as its fit calls
    train_window and train_batch."""
    ex, losses = jm.executor, []
    win, one = ex.train_window, ex.train_batch

    def train_window(*a):
        mets = win(*a)
        losses.extend(np.asarray(mets["loss"]).tolist())
        return mets

    def train_batch(*a):
        mets = one(*a)
        losses.append(float(mets["loss"]))
        return mets

    ex.train_window, ex.train_batch = train_window, train_batch
    return losses


@pytest.fixture(scope="module")
def pair():
    """(JAX model, port model) of the dropout BERT from one set of weights,
    trained alike by each test in turn."""
    jm = jbuild_transformer(JFFConfig(batch_size=BATCH, workers_per_node=1),
                            JTransformerConfig(**KW))
    jm.compile(optimizer=JSGDOptimizer(lr=LR), loss_type=JLossType.SPARSE_CATEGORICAL_CROSSENTROPY,
               metrics=[JMetricsType(m.value) for m in METRICS])
    tm = port_from_jax(jm, FFConfig(batch_size=BATCH), SGDOptimizer(lr=LR),
                       LossType.SPARSE_CATEGORICAL_CROSSENTROPY, METRICS)
    return jm, tm


def test_fit_windows_and_tail_steps_match_jax(pair):
    """Two epochs of six batches at trace_window 4: each epoch one window
    of four steps and two tail steps, every step's loss and then every
    parameter against JAX's."""
    jm, tm = pair
    x, y = _data(1, STEPS * BATCH)
    jlosses = _recorded(jm)
    jperf = jm.fit(jnp.asarray(x), jnp.asarray(y), epochs=2, verbose=False,
                   trace_window=WINDOW)
    tperf = tm.fit(x, y, epochs=2, verbose=False, trace_window=WINDOW)
    assert len(tm.step_losses) == len(jlosses) == 2 * STEPS
    np.testing.assert_allclose(tm.step_losses, jlosses, rtol=1e-5)
    assert tperf.train_all == jperf.train_all == 2 * STEPS * BATCH
    assert tperf.train_correct == jperf.train_correct
    np.testing.assert_allclose(tperf.sparse_cce_loss, jperf.sparse_cce_loss, rtol=1e-5)
    assert_weights_match(jm, tm, atol=1e-5)


def test_train_window_returns_every_step_and_counts_them(pair):
    """``train_window`` itself, keys split from one key: the metrics of
    each step stacked [steps], the optimizer's step count advanced by
    the window's length."""
    jm, tm = pair
    x, y = _data(2, 3 * BATCH)
    xs, ys = x.reshape(3, BATCH, -1), y.reshape(3, BATCH, 1)
    step0 = tm.executor.opt_state["step"]
    jmets = jm.executor.train_window([jnp.asarray(xs)], jnp.asarray(ys), jax.random.key(5))
    tmets = tm.executor.train_window([xs], ys, prng.key(5))
    assert set(tmets) == set(jmets)
    assert all(v.shape[0] == 3 for v in tmets.values())
    np.testing.assert_allclose(tmets["loss"].numpy(), np.asarray(jmets["loss"]), rtol=1e-5)
    np.testing.assert_array_equal(tmets["correct"].numpy(), np.asarray(jmets["correct"]))
    assert tm.executor.opt_state["step"] == step0 + 3 == int(jm.executor.opt_state["step"])
    assert_weights_match(jm, tm, atol=1e-5)


def test_train_batch_repeated_matches_jax(pair):
    """Three steps on one batch with the keys fold_in(rng, i): the last
    step's metrics and every parameter."""
    jm, tm = pair
    x, y = _data(3, BATCH)
    jmets = jm.executor.train_batch_repeated([jnp.asarray(x)], jnp.asarray(y),
                                             jax.random.key(9), 3)
    tmets = tm.executor.train_batch_repeated([x], y, prng.key(9), 3)
    np.testing.assert_allclose(float(tmets["loss"]), float(jmets["loss"]), rtol=1e-5)
    assert int(tmets["correct"]) == int(jmets["correct"])
    assert_weights_match(jm, tm, atol=1e-5)


def test_eval_window_and_evaluate_match_jax(pair):
    """``eval_window`` over three stacked batches (rng defaulting to
    key(0)), then ``evaluate`` at trace_window 2 over five batches (two
    windows and a tail step)."""
    jm, tm = pair
    x, y = _data(4, 5 * BATCH)
    xs, ys = x[:3 * BATCH].reshape(3, BATCH, -1), y[:3 * BATCH].reshape(3, BATCH, 1)
    jmets = jm.executor.eval_window([jnp.asarray(xs)], jnp.asarray(ys))
    tmets = tm.executor.eval_window([xs], ys)
    for k in ("loss", "sparse_cce_loss"):
        np.testing.assert_allclose(tmets[k].numpy(), np.asarray(jmets[k]), rtol=1e-5)
    np.testing.assert_array_equal(tmets["correct"].numpy(), np.asarray(jmets["correct"]))
    jperf = jm.evaluate(jnp.asarray(x), jnp.asarray(y), trace_window=2)
    tperf = tm.evaluate(x, y, trace_window=2)
    assert tperf.train_all == jperf.train_all == 5 * BATCH
    assert tperf.train_correct == jperf.train_correct
    np.testing.assert_allclose(tperf.sparse_cce_loss, jperf.sparse_cce_loss, rtol=1e-5)


OPTIMIZERS = {
    "sgd": (lambda: JSGDOptimizer(lr=0.05, momentum=0.9),
            lambda: SGDOptimizer(lr=0.05, momentum=0.9), 0.01),
    "adam": (lambda: JAdamOptimizer(alpha=0.01), lambda: AdamOptimizer(alpha=0.01), 0.002),
}


@pytest.mark.parametrize("opt", list(OPTIMIZERS))
def test_set_learning_rate_between_windows_matches_jax(opt):
    """Two windows of two steps on the small CNN (BatchNorm, dropout 0.2)
    with the learning rate changed between them on both sides: losses
    and every parameter and running statistic. The port keeps its rate
    in one float32 device scalar, written in place."""
    jopt, topt, lr2 = OPTIMIZERS[opt]
    jm = small_cnn(JFFModel(JFFConfig(batch_size=BATCH, workers_per_node=1), seed=3), BATCH,
                   dropout=0.2)
    jm.compile(optimizer=jopt(), loss_type=JLossType.SPARSE_CATEGORICAL_CROSSENTROPY,
               metrics=[JMetricsType.ACCURACY])
    tm = port_from_jax(jm, FFConfig(batch_size=BATCH), topt(),
                       LossType.SPARSE_CATEGORICAL_CROSSENTROPY, [MetricsType.ACCURACY])
    lr = tm.executor.opt_state["lr"]
    assert lr.dtype == torch.float32 and lr.dim() == 0
    x, y = cnn_data(31, 4 * BATCH)
    xs, ys = x.reshape(2, 2, BATCH, *x.shape[1:]), y.reshape(2, 2, BATCH)
    jl, tl = [], []
    for w in range(2):
        if w == 1:
            jm.executor.set_learning_rate(lr2)
            tm.executor.set_learning_rate(lr2)
        jl += np.asarray(jm.executor.train_window([jnp.asarray(xs[w])], jnp.asarray(ys[w]),
                                                  jax.random.key(40 + w))["loss"]).tolist()
        tl += tm.executor.train_window([xs[w]], ys[w], prng.key(40 + w))["loss"].tolist()
    assert tm.executor.opt_state["lr"] is lr
    assert float(lr) == float(np.float32(lr2)) == float(jm.executor.opt_state["lr"])
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert_weights_match(jm, tm, atol=1e-5)


def test_window_methods_fire_no_fault_site():
    """A rule on ``executor.train_batch`` fails ``train_batch`` but not the
    window methods (JAX's window methods fire no site either)."""
    tm = small_cnn(_port_model(), BATCH)
    tm.compile(optimizer=SGDOptimizer(lr=0.01), loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY)
    x, y = cnn_data(5, 2 * BATCH)
    plan = faults.FaultPlan().on(faults.EXECUTOR_TRAIN_BATCH, "error")
    with plan.active():
        with pytest.raises(Exception):
            tm.executor.train_batch([x[:BATCH]], y[:BATCH])
        mets = tm.executor.train_window([x.reshape(2, BATCH, *x.shape[1:])], y.reshape(2, BATCH),
                                        prng.key(1))
        last = tm.executor.train_batch_repeated([x[:BATCH]], y[:BATCH], prng.key(2), 2)
    assert mets["loss"].shape == (2,) and np.isfinite(float(last["loss"]))


def test_step_graph_cache_follows_the_executors_tensors():
    """The window path's graph cache (nothing is captured on the CPU):
    one graph a geometry and step kind, the same object again for the
    same geometry, and every graph dropped when a tensor of the params,
    the state or the optimizer state was replaced, or the executor
    initialized again; ``set_learning_rate`` writes in place and keeps
    them."""
    tm = small_cnn(_port_model(), BATCH)
    tm.compile(optimizer=AdamOptimizer(alpha=0.01),
               loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY)
    ex = tm.executor
    x, y = (torch.from_numpy(a) for a in cnn_data(6, BATCH))
    g = ex._step_graph("train", ex._train_body, [x], y)
    assert ex._step_graph("train", ex._train_body, [x], y) is g
    e = ex._step_graph("eval", ex._eval_body, [x], y)
    assert e is not g and ex._step_graph("train", ex._train_body, [x[:2]], y[:2]) is not g
    before = leaf_ids(ex.params, ex.state, ex.opt_state)
    ex.set_learning_rate(0.5)
    assert leaf_ids(ex.params, ex.state, ex.opt_state) == before
    assert ex._step_graph("train", ex._train_body, [x], y) is g
    key = next(iter(ex.state))
    name = next(iter(ex.state[key]))
    ex.state[key][name] = ex.state[key][name].clone()
    assert ex._step_graph("train", ex._train_body, [x], y) is not g
    ex.initialize(torch.Generator().manual_seed(0))
    assert ex._graphs == {} and ex.graph_captures == 0


ARGVS = [
    [],
    ["-e", "3", "-b", "16", "--lr", "0.1", "--wd", "0", "-p", "5", "-d", "data/x"],
    ["--trace-window", "8", "--remat-blocks", "--grad-accum-steps", "4", "--fusion",
     "--only-data-parallel", "--alpha", "1.2", "--machine-model-version", "1",
     "--topo-file", "t.json", "--iteration", "3", "--export", "s.json", "--unknown", "7"],
    ["--ll:gpu", "1", "--nodes", "1", "--search-num-workers", "2", "--memory-search",
     "--substitution-json", "sub.json", "--pipeline-microbatches", "4", "--overlap",
     "--taskgraph", "tg.dot", "--compgraph", "cg.dot", "--include-costs-dot-graph"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=["defaults", "training", "window", "machine"])
def test_from_args_gives_jax_field_values(argv):
    """Every field of the JAX package's FFConfig, parsed from the same argv."""
    want = JFFConfig.from_args(argv)
    got = FFConfig.from_args(argv)
    for f in dataclasses.fields(JFFConfig):
        assert getattr(got, f.name) == getattr(want, f.name), f.name


UNPORTED = {
    "search": (["--budget", "10"], "search_budget"),
    "pipeline": (["--pipeline-stages", "2"], "pipeline_stages"),
    "nodes": (["--nodes", "2"], "num_nodes"),
    "devices": (["--ll:gpu", "4"], "workers_per_node"),
    "zero": (["--zero-optimizer"], "zero_optimizer"),
}


# flags of UNPORTED that the port has since come to take: the search runs
# on one GPU (tests/test_torch_port_strategy.py); several devices and
# ZeRO-1 train data-parallel (tests/test_torch_port_dp.py)
NOW_TAKEN = {"search", "devices", "zero"}


@pytest.mark.parametrize("case", list(UNPORTED))
def test_unported_flags_raise(case):
    """A flag the port cannot run raises, from the CLI and from the
    constructor; the JAX package takes it. A flag of NOW_TAKEN gives the
    JAX package's value both ways instead."""
    argv, field = UNPORTED[case]
    value = getattr(JFFConfig.from_args(argv), field)
    assert value != getattr(JFFConfig(), field)
    if case in NOW_TAKEN:
        assert getattr(FFConfig.from_args(argv), field) == value
        assert getattr(FFConfig(**{field: value}), field) == value
        return
    with pytest.raises(NotImplementedError):
        FFConfig.from_args(argv)
    with pytest.raises(NotImplementedError):
        FFConfig(**{field: value})
    it = FFIterationConfig(seq_length=7)
    it.reset()
    assert it.seq_length == -1
