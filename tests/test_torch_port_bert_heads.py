"""The BERT models with their heads and dropout, and the seq2seq
transformer, through the port against the JAX package on the CPU.

Each JAX model's graph is read into the port from its JSON
(``FFModel.from_graph``: the same guids, so each dropout node folds the
same guid into the step key) and its initial weights are carried over
by layer name (``params_from_numpy``). Gates (float32): the output
probabilities atol 1e-5; the loss of each of three training steps with
dropout 0.1, on the same step keys, rtol 1e-5; every parameter after
three steps of ``fit`` (each package drawing its own key chain, one step
a window and two) atol 1e-5. The tests of one model train one pair of
models in turn (a JAX model compiles its programs once).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flexflow_tpu.config import FFConfig as JFFConfig
from flexflow_tpu.core.types import LossType as JLossType
from flexflow_tpu.core.types import MetricsType as JMetricsType
from flexflow_tpu.models.transformer import TransformerConfig as JTransformerConfig
from flexflow_tpu.models.transformer import build_transformer as jbuild_transformer
from flexflow_tpu.models.transformer import build_transformer_seq2seq as jbuild_seq2seq
from flexflow_tpu.runtime.optimizers import SGDOptimizer as JSGDOptimizer
from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.core.graph import PCGraph
from flexflow_tpu_torch.core.types import LossType, MetricsType, OpType
from flexflow_tpu_torch.generation import prng
from flexflow_tpu_torch.model import FFModel
from flexflow_tpu_torch.models import TransformerConfig, build_transformer
from flexflow_tpu_torch.models import build_transformer_seq2seq
from flexflow_tpu_torch.runtime import SGDOptimizer, params_from_numpy

pytestmark = pytest.mark.torch_port

KW = dict(num_layers=2, hidden_size=32, num_heads=2, ff_size=64, seq_length=8, dropout=0.1)
VOCAB, SRC, BATCH, LR, STEPS = 40, 12, 4, 0.05, 3
KINDS = {
    "bert_cls": dict(vocab_size=VOCAB, num_classes=2),
    "bert_mlm": dict(vocab_size=VOCAB),
    "seq2seq": dict(vocab_size=VOCAB),
}


def _named(model) -> dict:
    names = {f"{n.op_type.value}_{n.guid}": n.name for n in model.graph.nodes.values()}
    return {names[k]: {w: np.asarray(a) for w, a in ws.items()}
            for k, ws in model.executor.params.items()}


def _jax_model(kind):
    jc = JFFConfig(batch_size=BATCH, workers_per_node=1)
    cfg = JTransformerConfig(**KW, **KINDS[kind])
    if kind == "seq2seq":
        jm = jbuild_seq2seq(jc, cfg, num_decoder_layers=1, src_seq_length=SRC)
    else:
        jm = jbuild_transformer(jc, cfg)
    jm.compile(optimizer=JSGDOptimizer(lr=LR), loss_type=JLossType.SPARSE_CATEGORICAL_CROSSENTROPY,
               metrics=[JMetricsType.ACCURACY])
    return jm


def _port_model(jm):
    """The JAX model's graph (from its JSON) and initial weights in the port."""
    tm = FFModel.from_graph(PCGraph.from_json(jm.graph.to_json()), FFConfig(batch_size=BATCH),
                            device="cpu")
    tm.compile(optimizer=SGDOptimizer(lr=LR), loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
               metrics=[MetricsType.ACCURACY],
               outputs=tm.output_tensors([(t.node.guid, t.idx) for t in jm._outputs]))
    tm.set_weights(params_from_numpy(_named(jm)))
    return tm


def _data(kind, seed, n):
    rs = np.random.RandomState(seed)
    s, e = KW["seq_length"], KW["hidden_size"]
    if kind == "seq2seq":
        xs = [rs.randn(n, SRC, e).astype(np.float32), rs.randn(n, s, e).astype(np.float32)]
        return xs, rs.randint(0, VOCAB, (n, s)).astype(np.int32)
    x = rs.randint(0, VOCAB, (n, s)).astype(np.int32)
    if kind == "bert_cls":
        return [x], rs.randint(0, 2, (n, 1)).astype(np.int32)
    return [x], rs.randint(0, VOCAB, (n, s)).astype(np.int32)


@pytest.fixture(scope="module", params=list(KINDS))
def pair(request):
    jm = _jax_model(request.param)
    return request.param, jm, _port_model(jm)


def _assert_params_equal(jm, tm, atol=1e-5):
    for layer, ws in _named(jm).items():
        for name, arr in ws.items():
            np.testing.assert_allclose(tm.get_weight(layer, name), arr, atol=atol, rtol=0,
                                       err_msg=f"{layer}.{name}")


def test_the_graph_holds_the_heads_and_dropout(pair):
    kind, jm, tm = pair
    ops = [n.op_type for n in tm.graph.nodes.values()]
    assert ops.count(OpType.DROPOUT) == KW["num_layers"] + (1 if kind == "seq2seq" else 0)
    assert ops.count(OpType.SOFTMAX) == 1
    assert all(n.params.dropout == 0.1 for n in tm.graph.nodes.values()
               if n.op_type == OpType.MULTIHEAD_ATTENTION)
    if kind == "bert_cls":
        assert {OpType.EMBEDDING, OpType.SPLIT, OpType.RESHAPE} <= set(ops)
    if kind == "seq2seq":  # cross-attention: 8 queries over the 12 source keys
        cross = next(n for n in tm.graph.nodes.values() if n.name == "d0_cross_attn")
        srcs = [tm.graph.nodes[e.src].name for e in tm.graph.in_edges(cross)]
        assert srcs == ["d0_ln2", "enc_final_ln", "enc_final_ln"]


def test_output_probabilities_match_jax(pair):
    kind, jm, tm = pair
    xs, _ = _data(kind, 1, BATCH)
    want = np.asarray(jm.predict([jnp.asarray(x) for x in xs]))
    got = tm.predict(xs).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)


def test_train_steps_with_dropout_match_jax(pair):
    """Three steps from the same weights on the same step keys: each
    step's loss and accuracy, then every parameter. Dropout is on, so
    the masks must be JAX's bit for bit for the losses to agree."""
    kind, jm, tm = pair
    _assert_params_equal(jm, tm)
    xs, y = _data(kind, 2, STEPS * BATCH)
    jk, tk = jax.random.key(17), prng.key(17)
    for step in range(STEPS):
        jk, jsub = jax.random.split(jk)
        tk, tsub = prng.split(tk)
        sl = slice(step * BATCH, (step + 1) * BATCH)
        jmets = jm.executor.train_batch([jnp.asarray(x[sl]) for x in xs], jnp.asarray(y[sl]), jsub)
        tmets = tm.executor.train_batch([x[sl] for x in xs], y[sl], rng=tsub)
        np.testing.assert_allclose(float(tmets["loss"]), float(jmets["loss"]), rtol=1e-5)
        assert int(tmets["correct"]) == int(jmets["correct"])
    _assert_params_equal(jm, tm)


@pytest.mark.parametrize("trace_window", [1, 2])
def test_fit_key_chain_matches_jax(pair, trace_window):
    """``fit`` on each side, each drawing its own step keys from
    ``key(seed + 1)``: at trace_window 2 the JAX package runs one traced
    window of two steps (keys split from the window's key) and one tail
    step, and the port derives the same keys."""
    kind, jm, tm = pair
    _assert_params_equal(jm, tm)  # (the earlier tests trained both alike)
    xs, y = _data(kind, 3, STEPS * BATCH)
    jm.fit([jnp.asarray(x) for x in xs] if len(xs) > 1 else jnp.asarray(xs[0]), jnp.asarray(y),
           verbose=False, trace_window=trace_window)
    tm.fit(xs, y, verbose=False, trace_window=trace_window)
    assert len(tm.step_losses) == STEPS and all(np.isfinite(tm.step_losses))
    _assert_params_equal(jm, tm)


def test_port_builders_train_and_infer():
    """The port's own builders (new guids): a CLS model and a seq2seq
    model fit, predict probabilities, and a model compiled for inference
    holds no optimizer state."""
    cls = build_transformer(FFConfig(batch_size=BATCH), TransformerConfig(**KW, **KINDS["bert_cls"]),
                            device="cpu")
    cls.compile(optimizer=SGDOptimizer(lr=LR), loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
                metrics=[MetricsType.ACCURACY])
    xs, y = _data("bert_cls", 4, 2 * BATCH)
    perf = cls.fit(xs, y, verbose=False)
    assert perf.train_all == 2 * BATCH and all(np.isfinite(cls.step_losses))
    assert cls.predict(xs[0][:BATCH]).shape == (BATCH, 2)
    s2s = build_transformer_seq2seq(FFConfig(batch_size=BATCH),
                                    TransformerConfig(**KW, **KINDS["seq2seq"]),
                                    num_decoder_layers=1, src_seq_length=SRC, device="cpu")
    from flexflow_tpu_torch.core.types import CompMode

    s2s.compile(comp_mode=CompMode.INFERENCE)
    assert s2s.executor.opt_state is None and s2s.strategy.axis_sizes == {"data": 1}
    xs, _ = _data("seq2seq", 5, BATCH)
    probs = s2s.predict(xs)
    assert probs.shape == (BATCH, KW["seq_length"], VOCAB) and not probs.requires_grad
