"""The port's training path (FFModel -> compile -> fit) against the JAX
package on the CPU.

The same BERT-style encoder (2 layers, hidden 128, 2 heads of 64) is
built in both packages; the JAX model's initial weights are carried into
the port by layer name (``runtime/convert.py``), and the same numpy
batches go through both. Tolerances: forward output atol/rtol 1e-5
(fp32 with another summation order), losses rtol 1e-5, parameters after
three SGD steps atol 1e-5 (the update moves weights by ~lr * grad, so
this also holds the gradients to the reference's).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.config import FFConfig as JFFConfig
from flexflow_tpu.core.types import LossType as JLossType
from flexflow_tpu.core.types import MetricsType as JMetricsType
from flexflow_tpu.models.transformer import TransformerConfig as JTransformerConfig
from flexflow_tpu.models.transformer import build_transformer as jbuild_transformer
from flexflow_tpu.runtime.optimizers import SGDOptimizer as JSGDOptimizer
from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.core.types import LossType, MetricsType, OpType
from flexflow_tpu_torch.model import FFModel
from flexflow_tpu_torch.models import TransformerConfig, build_transformer
from flexflow_tpu_torch.ops.kernels import flash_attention as tfa
from flexflow_tpu_torch.runtime import PerfMetrics, SGDOptimizer, params_from_numpy

pytestmark = pytest.mark.torch_port

CFG_KW = dict(num_layers=2, hidden_size=128, num_heads=2, ff_size=256, seq_length=32)
BATCH = 4
LR = 0.01


def _data(seed, steps):
    rs = np.random.RandomState(seed)
    shape = (steps * BATCH, CFG_KW["seq_length"], CFG_KW["hidden_size"])
    return rs.randn(*shape).astype(np.float32), rs.randn(*shape).astype(np.float32)


def _named(model) -> dict:
    """The JAX executor's parameters as {layer_name: {weight: ndarray}}."""
    names = {f"{n.op_type.value}_{n.guid}": n.name for n in model.graph.nodes.values()}
    return {names[k]: {w: np.asarray(a) for w, a in ws.items()}
            for k, ws in model.executor.params.items()}


@pytest.fixture(scope="module", params=[False, True], ids=["bidirectional", "causal"])
def pair(request):
    """(JAX model, port model) compiled for SGD + MSE from one set of
    weights; the JAX model runs on one CPU device."""
    causal = request.param
    jm = jbuild_transformer(JFFConfig(batch_size=BATCH, workers_per_node=1),
                            JTransformerConfig(**CFG_KW, causal=causal))
    jm.compile(optimizer=JSGDOptimizer(lr=LR), loss_type=JLossType.MEAN_SQUARED_ERROR,
               metrics=[JMetricsType.MEAN_SQUARED_ERROR])
    tm = build_transformer(FFConfig(batch_size=BATCH), TransformerConfig(**CFG_KW, causal=causal),
                           device="cpu")
    tm.compile(optimizer=SGDOptimizer(lr=LR), loss_type=LossType.MEAN_SQUARED_ERROR,
               metrics=[MetricsType.MEAN_SQUARED_ERROR])
    tm.set_weights(params_from_numpy(_named(jm)))
    return jm, tm


def test_forward_output_matches_jax(pair):
    jm, tm = pair
    x, _ = _data(1, 1)
    want = np.asarray(jm.predict(jnp.asarray(x)))
    got = tm.predict(x).numpy()
    assert got.shape == want.shape == x.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_three_sgd_steps_match_jax(pair):
    """Losses of each step and every parameter after three steps."""
    jm, tm = pair
    x, y = _data(2, 3)
    for step in range(3):
        sl = slice(step * BATCH, (step + 1) * BATCH)
        jmets = jm.executor.train_batch([jnp.asarray(x[sl])], jnp.asarray(y[sl]), jax.random.key(step))
        tmets = tm.executor.train_batch([x[sl]], y[sl])
        np.testing.assert_allclose(float(tmets["loss"]), float(jmets["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(tmets["mse_loss"]), float(jmets["mse_loss"]), rtol=1e-5)
    want = _named(jm)
    for layer, ws in want.items():
        for name, arr in ws.items():
            np.testing.assert_allclose(tm.get_weight(layer, name), arr, atol=1e-5, rtol=0,
                                       err_msg=f"{layer}.{name}")


def test_fit_returns_perf_metrics_and_prints_throughput(capsys):
    model = build_transformer(FFConfig(batch_size=BATCH, printing_interval=1, trace_window=2),
                              TransformerConfig(**CFG_KW), device="cpu")
    model.compile(optimizer=SGDOptimizer(lr=LR), loss_type=LossType.MEAN_SQUARED_ERROR,
                  metrics=[MetricsType.MEAN_SQUARED_ERROR])
    x, y = _data(3, 3)
    tfa.reset_launch_counts()
    perf = model.fit(x, y, epochs=2)
    out = capsys.readouterr().out
    assert isinstance(perf, PerfMetrics) and perf.train_all == 2 * 3 * BATCH
    assert perf.mse_loss > 0 and len(model.step_losses) == 6
    assert all(np.isfinite(model.step_losses))
    assert "ELAPSED TIME = " in out and "THROUGHPUT = " in out and "samples/s" in out
    assert out.count("loss ") == 6  # every step printed, at interval 1
    assert sum(tfa.LAUNCHES.values()) == 0  # CPU tensors: the plain versions
    ev = model.evaluate(x, y)
    assert ev.train_all == 3 * BATCH and ev.mse_loss > 0


def test_trace_window_does_not_change_the_arithmetic():
    x, y = _data(4, 4)
    losses = []
    for tw in (1, 3):
        model = build_transformer(FFConfig(batch_size=BATCH, trace_window=tw, seed=5),
                                  TransformerConfig(**CFG_KW), device="cpu")
        model.compile(optimizer=SGDOptimizer(lr=LR), loss_type=LossType.MEAN_SQUARED_ERROR)
        model.fit(x, y, verbose=False)
        losses.append(model.step_losses)
    assert losses[0] == losses[1]


def test_weights_by_layer_name_and_key():
    model = build_transformer(FFConfig(batch_size=BATCH), TransformerConfig(**CFG_KW), device="cpu")
    model.compile(optimizer=SGDOptimizer(lr=LR), loss_type=LossType.MEAN_SQUARED_ERROR)
    ex = model.executor
    key = ex.node_key("l0_attn")
    node = next(n for n in model.graph.nodes.values() if n.name == "l0_attn")
    assert node.op_type == OpType.MULTIHEAD_ATTENTION and key == f"multihead_attention_{node.guid}"
    assert set(ex.params[key]) == {"wq", "wk", "wv", "wo"}
    assert ex.params[key]["wq"].shape == (128, 2, 64)
    w = model.get_weight("l0_ff1", "kernel")
    model.set_weight("l0_ff1", "kernel", w * 2)
    np.testing.assert_array_equal(model.get_weight("l0_ff1", "kernel"), w * 2)
    with pytest.raises(ValueError):
        model.set_weight("l0_ff1", "kernel", w[:1])
    with pytest.raises(KeyError):
        model.get_weight("nope", "kernel")


def test_entry_point_defaults_to_cuda_and_raises_without_it():
    """FFModel() without a device means CUDA; without a GPU that raises,
    never a silent run on the CPU. Unported configurations raise too."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FFModel(FFConfig())
    with pytest.raises(RuntimeError):
        build_transformer(FFConfig(batch_size=2), TransformerConfig(**CFG_KW))
    assert FFModel(FFConfig(), device="cpu").device.type == "cpu"
    for kw in ({"search_budget": 10}, {"pipeline_stages": 2}, {"num_nodes": 2},
               {"workers_per_node": 4}):
        with pytest.raises(NotImplementedError):
            FFConfig(**kw)
    assert FFConfig().num_devices == 1


# ---------------------------------------------------------------------------
# losses, metrics and optimizers against the JAX runtime
# ---------------------------------------------------------------------------


def _probs(rs, b, c):
    e = np.exp(rs.randn(b, c))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("loss", list(LossType), ids=lambda t: t.value)
def test_losses_match_jax(loss):
    from flexflow_tpu.runtime.losses import get_loss_fn as jget_loss_fn
    from flexflow_tpu_torch.runtime.losses import get_loss_fn

    rs = np.random.RandomState(6)
    preds = _probs(rs, 8, 5)
    if loss == LossType.SPARSE_CATEGORICAL_CROSSENTROPY:
        labels = rs.randint(0, 5, (8, 1)).astype(np.int32)
    elif loss == LossType.CATEGORICAL_CROSSENTROPY:
        labels = np.eye(5, dtype=np.float32)[rs.randint(0, 5, 8)]
    else:
        labels = rs.randn(8, 5).astype(np.float32)
    want = float(jget_loss_fn(JLossType(loss.value))(jnp.asarray(preds), jnp.asarray(labels)))
    got = float(get_loss_fn(loss)(torch.from_numpy(preds), torch.from_numpy(labels)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_metrics_match_jax():
    from flexflow_tpu.runtime.metrics import compute_metrics as jcompute_metrics
    from flexflow_tpu_torch.runtime.metrics import compute_metrics

    rs = np.random.RandomState(7)
    preds = _probs(rs, 16, 6)
    for labels in (np.eye(6, dtype=np.float32)[rs.randint(0, 6, 16)],
                   rs.randint(0, 6, (16, 1)).astype(np.int32)):
        types = [MetricsType.ACCURACY, MetricsType.MEAN_SQUARED_ERROR,
                 MetricsType.ROOT_MEAN_SQUARED_ERROR, MetricsType.MEAN_ABSOLUTE_ERROR,
                 MetricsType.CATEGORICAL_CROSSENTROPY if labels.shape[-1] == 6
                 else MetricsType.SPARSE_CATEGORICAL_CROSSENTROPY]
        want = jcompute_metrics([JMetricsType(t.value) for t in types], jnp.asarray(preds),
                                jnp.asarray(labels))
        got = compute_metrics(types, torch.from_numpy(preds), torch.from_numpy(labels))
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)
    perf = PerfMetrics()
    perf.update({k: float(v) for k, v in got.items()})
    assert perf.train_all == 16 and 0 <= perf.accuracy <= 1


@pytest.mark.parametrize("kind", ["sgd", "momentum", "nesterov_wd", "adam"])
def test_optimizers_match_jax_over_three_updates(kind):
    """In-place updates of the port against the JAX optimizers' pure
    ones on the same parameters and gradients (rtol 1e-6)."""
    from flexflow_tpu.runtime import optimizers as jopt
    from flexflow_tpu_torch.runtime import optimizers as topt

    kw = {"sgd": ("SGDOptimizer", dict(lr=0.1)),
          "momentum": ("SGDOptimizer", dict(lr=0.1, momentum=0.9)),
          "nesterov_wd": ("SGDOptimizer", dict(lr=0.1, momentum=0.9, nesterov=True, weight_decay=0.01)),
          "adam": ("AdamOptimizer", dict(alpha=0.01, weight_decay=0.001))}[kind]
    rs = np.random.RandomState(8)
    params = {"linear_1": {"kernel": rs.randn(4, 3).astype(np.float32),
                           "bias": rs.randn(3).astype(np.float32)}}
    jo, to = getattr(jopt, kw[0])(**kw[1]), getattr(topt, kw[0])(**kw[1])
    jp = jax.tree.map(jnp.asarray, params)
    tp = {k: {n: torch.from_numpy(a.copy()) for n, a in g.items()} for k, g in params.items()}
    js, ts = jo.init_state(jp), to.init_state(tp)
    for _ in range(3):
        grads = jax.tree.map(lambda a: rs.randn(*a.shape).astype(np.float32), params)
        jp, js = jo.apply(jp, jax.tree.map(jnp.asarray, grads), js)
        to.apply(tp, {k: {n: torch.from_numpy(a) for n, a in g.items()} for k, g in grads.items()}, ts)
    for k, g in tp.items():
        for n, t in g.items():
            np.testing.assert_allclose(t.numpy(), np.asarray(jp[k][n]), rtol=1e-6, atol=1e-7)
    assert ts["step"] == 3
