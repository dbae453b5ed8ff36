"""The trainer of a real job through the port against the JAX package on
the CPU: rematerialized blocks, gradient accumulation, the repeated-block
discovery they stand on, and the DataLoader.

Gates (float32): losses rtol 1e-5, every parameter and BatchNorm
running statistic atol 1e-5 after three steps (another summation order
in fp32 only), the metrics' sums (correct, mse_loss) exactly or rtol
1e-5, ``rmse_loss`` rtol 1e-5. The port's remat run equals its plain
run bit for bit: the recomputed forward draws the same dropout masks and
the block's state leaves it once. Accumulation runs on the small CNN of
``tests/torch_port_cnn.py`` with dropout before its classifier, at
batch 8, so each microbatch's BatchNorm statistics, its dropout mask
(``split(key, accum)[i]``) and the chained running statistics all have
to be JAX's for the gates to hold.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.config import FFConfig as JFFConfig
from flexflow_tpu.core.types import LossType as JLossType
from flexflow_tpu.core.types import MetricsType as JMetricsType
from flexflow_tpu.model import FFModel as JFFModel
from flexflow_tpu.model import Tensor as JTensor
from flexflow_tpu.models.transformer import TransformerConfig as JTransformerConfig
from flexflow_tpu.models.transformer import build_transformer as jbuild_transformer
from flexflow_tpu.models.transformer import build_transformer_seq2seq as jbuild_seq2seq
from flexflow_tpu.models.vision import build_resnet50 as jbuild_resnet50
from flexflow_tpu.parallel.pipeline import detect_repeats as jdetect_repeats
from flexflow_tpu.runtime.dataloader import DataLoader as JDataLoader
from flexflow_tpu.runtime.optimizers import SGDOptimizer as JSGDOptimizer
from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.core.types import LossType, MetricsType
from flexflow_tpu_torch.generation import prng
from flexflow_tpu_torch.model import FFModel
from flexflow_tpu_torch.models import TransformerConfig, build_transformer
from flexflow_tpu_torch.models import build_resnet50, build_transformer_seq2seq
from flexflow_tpu_torch.parallel import detect_repeats
from flexflow_tpu_torch.runtime import DataLoader, SGDOptimizer

from torch_port_cnn import assert_weights_match, cnn_data, port_from_jax, small_cnn

pytestmark = pytest.mark.torch_port

KW = dict(num_layers=2, hidden_size=32, num_heads=2, ff_size=64, seq_length=8)


def _names(split):
    pre, repeats, post = split
    return [n.name for n in pre], [[n.name for n in r] for r in repeats], [n.name for n in post]


GRAPHS = {
    "bert": lambda pkg: (jbuild_transformer(JFFConfig(batch_size=2, workers_per_node=1),
                                            JTransformerConfig(num_layers=3, **{
                                                k: v for k, v in KW.items() if k != "num_layers"}))
                         if pkg == "jax" else
                         build_transformer(FFConfig(batch_size=2), TransformerConfig(num_layers=3, **{
                             k: v for k, v in KW.items() if k != "num_layers"}), device="cpu")),
    "seq2seq": lambda pkg: (jbuild_seq2seq(JFFConfig(batch_size=2, workers_per_node=1),
                                           JTransformerConfig(**KW, vocab_size=20),
                                           num_decoder_layers=3, src_seq_length=6)
                            if pkg == "jax" else
                            build_transformer_seq2seq(FFConfig(batch_size=2),
                                                      TransformerConfig(**KW, vocab_size=20),
                                                      num_decoder_layers=3, src_seq_length=6,
                                                      device="cpu")),
    "resnet50": lambda pkg: (jbuild_resnet50(JFFConfig(batch_size=2, workers_per_node=1),
                                             num_classes=10, image_hw=64)
                             if pkg == "jax" else
                             build_resnet50(FFConfig(batch_size=2), num_classes=10, image_hw=64,
                                            device="cpu")),
}


@pytest.mark.parametrize("graph", list(GRAPHS))
def test_detect_repeats_names_jax_blocks(graph):
    """The same (pre, repeated blocks, post) by layer name as the JAX
    package's, on graphs only (nothing compiles)."""
    want = _names(jdetect_repeats(GRAPHS[graph]("jax").graph))
    got = _names(detect_repeats(GRAPHS[graph]("port").graph))
    assert got == want
    assert len(got[1]) >= 2


BERT_BATCH, BERT_LR, STEPS = 4, 0.05, 3
BERT_KW = dict(**KW, vocab_size=40, num_classes=2, dropout=0.1)


@pytest.fixture(scope="module")
def bert_remat_runs():
    """A 2-layer bert-cls with dropout 0.1, plain and remat, in both
    packages: one graph (so every model draws the same masks) compiled
    four times, three steps on the same step keys from the same weights."""
    rs = np.random.RandomState(7)
    x = rs.randint(0, 40, (STEPS * BERT_BATCH, KW["seq_length"])).astype(np.int32)
    y = rs.randint(0, 2, (STEPS * BERT_BATCH, 1)).astype(np.int32)
    built = jbuild_transformer(JFFConfig(batch_size=BERT_BATCH, workers_per_node=1),
                               JTransformerConfig(**BERT_KW))
    runs = {}
    for remat in (False, True):
        jm = JFFModel(JFFConfig(batch_size=BERT_BATCH, workers_per_node=1, remat_blocks=remat))
        jm.graph, jm._num_inputs = built.graph, built._num_inputs
        jm.compile(optimizer=JSGDOptimizer(lr=BERT_LR),
                   loss_type=JLossType.SPARSE_CATEGORICAL_CROSSENTROPY,
                   metrics=[JMetricsType.ACCURACY],
                   outputs=[JTensor(jm, t.node, t.idx, t.spec) for t in built._outputs])
        tm = port_from_jax(jm, FFConfig(batch_size=BERT_BATCH, remat_blocks=remat),
                           SGDOptimizer(lr=BERT_LR), LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
                           [MetricsType.ACCURACY])
        jl, tl = [], []
        for s in range(STEPS):
            sl = slice(s * BERT_BATCH, (s + 1) * BERT_BATCH)
            jl.append(float(jm.executor.train_batch([jnp.asarray(x[sl])], jnp.asarray(y[sl]),
                                                    jax.random.key(100 + s))["loss"]))
            tl.append(float(tm.executor.train_batch([x[sl]], y[sl],
                                                    rng=prng.key(100 + s))["loss"]))
        runs[remat] = (jm, tm, jl, tl)
    return runs


def test_remat_on_and_off_agree_in_both_packages(bert_remat_runs):
    (jp, tp, jlp, tlp), (jr, tr, jlr, tlr) = bert_remat_runs[False], bert_remat_runs[True]
    assert jr.executor._remat_plan is not None and tr.executor._remat_plan is not None
    assert tp.executor._remat_plan is None
    assert len(tr.executor._remat_plan[1]) == KW["num_layers"]
    # JAX: remat against plain; the port against JAX, both ways
    np.testing.assert_allclose(jlr, jlp, rtol=1e-5)
    np.testing.assert_allclose(tlp, jlp, rtol=1e-5)
    np.testing.assert_allclose(tlr, jlr, rtol=1e-5)
    assert_weights_match(jp, tp, atol=1e-5)
    assert_weights_match(jr, tr, atol=1e-5)
    # the port: remat equals plain bit for bit
    assert tlr == tlp
    assert set(tp.executor.params) == set(tr.executor.params)
    for k, g in tp.executor.params.items():
        assert all(torch.equal(g[n], tr.executor.params[k][n]) for n in g), k


ACC_BATCH, ACC_LR = 8, 0.05
ACC_METRICS = ([JMetricsType.ACCURACY, JMetricsType.MEAN_SQUARED_ERROR,
                JMetricsType.ROOT_MEAN_SQUARED_ERROR],
               [MetricsType.ACCURACY, MetricsType.MEAN_SQUARED_ERROR,
                MetricsType.ROOT_MEAN_SQUARED_ERROR])


def _accum_pair(accum, remat=False):
    jm = small_cnn(JFFModel(JFFConfig(batch_size=ACC_BATCH, workers_per_node=1,
                                      grad_accum_steps=accum, remat_blocks=remat), seed=4),
                   ACC_BATCH, dropout=0.2)
    jm.compile(optimizer=JSGDOptimizer(lr=ACC_LR, momentum=0.9),
               loss_type=JLossType.MEAN_SQUARED_ERROR, metrics=ACC_METRICS[0])
    tm = port_from_jax(jm, FFConfig(batch_size=ACC_BATCH, grad_accum_steps=accum,
                                    remat_blocks=remat),
                       SGDOptimizer(lr=ACC_LR, momentum=0.9), LossType.MEAN_SQUARED_ERROR,
                       ACC_METRICS[1])
    return jm, tm


@pytest.mark.parametrize("accum", [2, 4])
def test_grad_accumulation_matches_jax(accum):
    """Three steps at batch 8: each step's loss and metrics, then every
    parameter and BatchNorm running statistic."""
    jm, tm = _accum_pair(accum)
    x, y = cnn_data(11, STEPS * ACC_BATCH, one_hot=True)
    for s in range(STEPS):
        sl = slice(s * ACC_BATCH, (s + 1) * ACC_BATCH)
        jmets = jm.executor.train_batch([jnp.asarray(x[sl])], jnp.asarray(y[sl]),
                                        jax.random.key(30 + s))
        tmets = tm.executor.train_batch([x[sl]], y[sl], rng=prng.key(30 + s))
        assert set(tmets) == set(jmets)
        np.testing.assert_allclose(float(tmets["loss"]), float(jmets["loss"]), rtol=1e-5)
        assert int(tmets["count"]) == int(jmets["count"]) == ACC_BATCH
        assert int(tmets["correct"]) == int(jmets["correct"])
        for k in ("mse_loss", "rmse_loss"):
            np.testing.assert_allclose(float(tmets[k]), float(jmets[k]), rtol=1e-5, err_msg=k)
    assert_weights_match(jm, tm, atol=1e-5)


def test_grad_accumulation_rejects_a_batch_it_does_not_divide():
    jm, tm = _accum_pair(3)
    x, y = cnn_data(12, ACC_BATCH, one_hot=True)
    with pytest.raises(ValueError) as jerr:
        jm.executor.train_batch([jnp.asarray(x)], jnp.asarray(y), jax.random.key(0))
    with pytest.raises(ValueError) as terr:
        tm.executor.train_batch([x], y)
    assert str(terr.value) == str(jerr.value) == "batch 8 not divisible by grad_accum_steps=3"
    with pytest.raises(ValueError, match="grad_accum_steps must be >= 1"):
        small_cnn(FFModel(FFConfig(batch_size=4, grad_accum_steps=0), device="cpu"), 4).compile(
            optimizer=SGDOptimizer(lr=0.1), loss_type=LossType.MEAN_SQUARED_ERROR)


def test_fit_with_remat_and_accumulation_matches_jax():
    """``FFConfig(remat_blocks=True, grad_accum_steps=2)`` through
    compile -> fit in both packages (each drawing its own key chain):
    the accumulated metrics, then every weight and running statistic."""
    jm, tm = _accum_pair(2, remat=True)
    assert tm.executor._remat_plan is not None
    x, y = cnn_data(13, STEPS * ACC_BATCH, one_hot=True)
    jperf = jm.fit(jnp.asarray(x), jnp.asarray(y), verbose=False)
    tperf = tm.fit(x, y, verbose=False)
    assert tperf.train_all == jperf.train_all == STEPS * ACC_BATCH
    assert tperf.train_correct == jperf.train_correct
    np.testing.assert_allclose([tperf.mse_loss, tperf.rmse_loss],
                               [jperf.mse_loss, jperf.rmse_loss], rtol=1e-5)
    assert_weights_match(jm, tm, atol=1e-5)


def test_dataloader_order_matches_jax_over_two_epochs():
    """Shuffled batches of two inputs and a label, two epochs: the same
    rows in the same order as the JAX DataLoader's, as CPU tensors."""
    rs = np.random.RandomState(3)
    xs = [rs.randn(21, 3).astype(np.float32), rs.randint(0, 9, (21, 2)).astype(np.int32)]
    y = np.arange(21, dtype=np.int32)
    jdl = JDataLoader(xs, y, batch_size=4, shuffle=True, seed=5)
    tdl = DataLoader(xs, y, batch_size=4, shuffle=True, seed=5, device="cpu")
    assert tdl.num_batches == jdl.num_batches == 5
    for _ in range(2):
        jb, tb = list(jdl.epoch()), list(tdl.epoch())
        assert len(tb) == len(jb) == 5
        for (jin, jlab), (tin, tlab) in zip(jb, tb):
            np.testing.assert_array_equal(tlab.numpy(), np.asarray(jlab))
            for a, b in zip(tin, jin):
                assert a.dtype == torch.from_numpy(np.asarray(b)).dtype
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_dataloader_abandoned_epoch_stops_its_thread():
    """A consumer that leaves an epoch early: the prefetch thread ends
    (it never blocks on its full queue), and the next epoch starts anew."""
    import threading

    x = np.arange(64, dtype=np.float32).reshape(32, 2)
    dl = FFModel(FFConfig(batch_size=2), device="cpu").create_data_loader(x, x[:, 0], shuffle=False)
    before = {t for t in threading.enumerate() if t.name == "dataloader-prefetch"}
    it = dl.epoch()
    first = next(it)
    np.testing.assert_array_equal(first[1].numpy(), [0.0, 2.0])
    it.close()
    assert {t for t in threading.enumerate() if t.name == "dataloader-prefetch"} == before
    assert len(list(dl.epoch())) == 16
