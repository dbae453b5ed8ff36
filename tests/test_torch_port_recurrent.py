"""NMT's ops and builder, the reductions, the weight node and the
recommender builders through the port against the JAX package on the
CPU.

Op gates, each case from one numpy seed. float32: the forward and every
gradient within 1e-5 of the largest |JAX value| of that output (another
summation order in fp32 only; about 4e-7 of it measured for RNN and
LSTM over five timesteps). bfloat16: the forward bit for bit with JAX's
(each step's ops rounded where JAX rounds them; measured equal for RNN,
LSTM, batch matmul and the reductions), every gradient within 2^-5
(eight units of bf16 roundoff) of the largest |JAX value|: JAX rounds
the backward op by op in bf16 (tanh's 1 - y^2, the broadcast sums) where
PyTorch rounds a float32 result once, and the recurrence carries that
through every timestep (2.5e-2 of it measured, the RNN's bias after
five steps).

Models (float32, the gates of ``tests/test_torch_port_training.py``):
the port's builders give the JAX builders' graphs (names, op types,
params, output shapes, weight specs), the graph JSON of each package
reads back in the other, and from the JAX model's weights a tiny NMT
(vocab 50, embed 16, hidden 16, length 6, attention on), a tiny DLRM
(SUM embedding bags) and a graph of every new builder each train three
SGD steps: losses rtol 1e-5, every parameter atol 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from flexflow_tpu.config import FFConfig as JFFConfig
from flexflow_tpu.core.types import DataType as JDataType
from flexflow_tpu.core.types import LossType as JLossType
from flexflow_tpu.model import FFModel as JFFModel
from flexflow_tpu.models import nmt as jnmt
from flexflow_tpu.models import recommender as jrec
from flexflow_tpu.ops import batch_matmul as jbmm
from flexflow_tpu.ops import io_ops as jio
from flexflow_tpu.ops import recurrent as jrecurrent
from flexflow_tpu.ops import reduction_ops as jred
from flexflow_tpu.ops.base import LowerCtx as JLowerCtx
from flexflow_tpu.ops.base import get_op_def as jget_op_def
from flexflow_tpu.parallel.propagation import infer_all_specs as jinfer_all_specs
from flexflow_tpu.runtime.optimizers import SGDOptimizer as JSGDOptimizer
from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.core.graph import PCGraph
from flexflow_tpu_torch.core.types import DataType, LossType, OpType
from flexflow_tpu_torch.generation import prng
from flexflow_tpu_torch.model import FFModel
from flexflow_tpu_torch.models import nmt, recommender
from flexflow_tpu_torch.ops import batch_matmul as bmm
from flexflow_tpu_torch.ops import io_ops
from flexflow_tpu_torch.ops import recurrent, reduction_ops as red
from flexflow_tpu_torch.ops.base import LowerCtx, get_op_def
from flexflow_tpu_torch.parallel import infer_all_specs
from flexflow_tpu_torch.runtime import SGDOptimizer
from flexflow_tpu_torch.runtime.convert import to_tensor

from torch_port_cnn import assert_weights_match, port_from_jax

pytestmark = pytest.mark.torch_port

F32_SHARE = 1e-5
BF16_GRAD_SHARE = 2.0 ** -5
_TYPES = {"float32": ("FLOAT", np.float32), "bfloat16": ("BFLOAT16", ml_dtypes.bfloat16)}


def _check_op(op, jp, tp, xs, ws, dtype, seq_length=None, grad_inputs=None, tag=""):
    """The op's lowering in both packages on the same inputs: every
    output, then the gradients of a random cotangent with respect to the
    float inputs (``grad_inputs``: their positions, default all) and
    every weight."""
    jdt = _TYPES[dtype][1]
    cast = (lambda a: a.astype(np.float32).astype(jdt)) if dtype != "float32" else \
        (lambda a: a.astype(np.float32))
    jx = [jnp.asarray(cast(a) if a.dtype.kind == "f" else a) for a in xs]
    jw = {k: jnp.asarray(cast(v)) for k, v in ws.items()}
    gi = list(range(len(xs))) if grad_inputs is None else grad_inputs
    rs = np.random.RandomState(11)

    def jf(gx, w):
        full = list(jx)
        for i, a in zip(gi, gx):
            full[i] = a
        return jget_op_def(_jop(op)).lower(
            jp, full, {**jw, **w}, JLowerCtx(training=True, backend="cpu", seq_length=seq_length))

    jy, vjp = jax.vjp(jf, [jx[i] for i in gi], jw)
    cts = [rs.randn(*y.shape).astype(np.float32) for y in jy]
    jg = vjp([jnp.asarray(cast(c)) for c in cts])
    tx = [to_tensor(np.asarray(a)) for a in jx]
    for i in gi:
        tx[i].requires_grad_(True)
    tw = {k: to_tensor(np.asarray(v)).requires_grad_(True) for k, v in jw.items()}
    ty = get_op_def(getattr(OpType, op)).lower(tp, tx, tw, LowerCtx(seq_length=seq_length))
    assert len(ty) == len(jy)
    tg = torch.autograd.grad(ty, [tx[i] for i in gi] + list(tw.values()),
                             [to_tensor(np.asarray(jnp.asarray(cast(c)))) for c in cts])
    pairs = [(f"y{i}", a, b) for i, (a, b) in enumerate(zip(jy, ty))]
    pairs += [(f"d_input{i}", a, b) for i, a, b in zip(gi, jg[0], tg)]
    pairs += [(f"d_{k}", jg[1][k], b) for k, b in zip(tw, tg[len(gi):])]
    for name, want, got in pairs:
        assert tuple(got.shape) == tuple(want.shape), (tag, name)
        want = np.asarray(want, np.float32)
        got = got.detach().float().numpy()
        if dtype == "bfloat16" and name.startswith("y"):
            np.testing.assert_array_equal(got, want, err_msg=f"{tag} {name}")
            continue
        share = F32_SHARE if dtype == "float32" else BF16_GRAD_SHARE
        err = np.abs(got - want).max()
        assert err <= share * np.abs(want).max(), f"{tag} {dtype} {name}: max err {err}"


def _jop(op):
    from flexflow_tpu.core.types import OpType as JOpType

    return getattr(JOpType, op)


RECURRENT = [("RNN", 0), ("RNN", 1), ("LSTM", 0), ("LSTM", 1), ("LSTM", 2)]


@pytest.mark.parametrize("dtype", list(_TYPES))
@pytest.mark.parametrize("op,initial", RECURRENT, ids=[f"{o.lower()}_init{i}" for o, i in RECURRENT])
def test_recurrent_forward_and_gradient_match_jax(op, initial, dtype):
    """RNN (tanh) and LSTM over [3, 5, 4] with hidden 6, without and with
    the initial states (h0; h0 and c0)."""
    rs = np.random.RandomState(3 + initial)
    b, t, d, h = 3, 5, 4, 6
    g = 4 * h if op == "LSTM" else h
    xs = [rs.randn(b, t, d)] + [0.5 * rs.randn(b, h) for _ in range(initial)]
    ws = {"wx": 0.5 * rs.randn(d, g), "wh": 0.5 * rs.randn(h, g), "bias": 0.1 * rs.randn(g)}
    name = _TYPES[dtype][0]
    jp = jrecurrent.RecurrentParams(h, getattr(JDataType, name))
    tp = recurrent.RecurrentParams(h, getattr(DataType, name))
    _check_op(op, jp, tp, xs, ws, dtype, tag=f"{op} init{initial}")


def test_lstm_initial_c_without_initial_h_is_rejected():
    msgs = []
    for m in (JFFModel(JFFConfig(batch_size=2, workers_per_node=1)),
              FFModel(FFConfig(batch_size=2), device="cpu")):
        x = m.create_tensor((2, 5, 4), name="x")
        c = m.create_tensor((2, 6), name="c")
        with pytest.raises(ValueError) as e:
            m.lstm(x, 6, initial_c=c, name="lstm")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("dtype", list(_TYPES))
@pytest.mark.parametrize("seq", [None, 3], ids=["full", "seq3"])
def test_batch_matmul_matches_jax(seq, dtype):
    """[2, 3, 5, 4] @ [2, 3, 4, 6]; with ``seq_length`` 3 the first 3 rows
    of A (dim 2) and columns of B (dim 3) are kept."""
    rs = np.random.RandomState(21)
    xs = [rs.randn(2, 3, 5, 4), rs.randn(2, 3, 4, 6)]
    _check_op("BATCH_MATMUL", jbmm.BatchMatmulParams(2, 3), bmm.BatchMatmulParams(2, 3), xs, {},
              dtype, seq_length=seq, tag="batch_matmul")


REDUCTIONS = [
    ("gather_axis1", "GATHER", lambda m: m.GatherParams(1)),
    ("reduce_sum_02", "REDUCE_SUM", lambda m: m.ReduceSumParams((0, 2), False)),
    ("reduce_sum_keep", "REDUCE_SUM", lambda m: m.ReduceSumParams((-1,), True)),
    ("mean_1", "MEAN", lambda m: m.MeanParams((1,), False)),
    ("mean_keep", "MEAN", lambda m: m.MeanParams((0, 2), True)),
]


@pytest.mark.parametrize("dtype", list(_TYPES))
@pytest.mark.parametrize("case,op,make", REDUCTIONS, ids=[c[0] for c in REDUCTIONS])
def test_reduction_ops_match_jax(case, op, make, dtype):
    """Gather (``take_along_axis``, a negative index among them),
    ReduceSum and Mean with and without keepdims, forward and gradient."""
    rs = np.random.RandomState(sum(map(ord, case)))
    xs = [rs.randn(4, 5, 3)]
    grad = None
    if op == "GATHER":
        idx = rs.randint(-5, 5, (4, 2, 3)).astype(np.int32)
        xs.append(idx)
        grad = [0]
    _check_op(op, make(jred), make(red), xs, {}, dtype, grad_inputs=grad, tag=case)


def test_weight_and_noop_ops():
    """WEIGHT lowers to its weight (a trainable one, with its
    initializer's spec), NOOP passes its inputs through, in both."""
    for mod, defs in ((jio, jget_op_def), (io_ops, get_op_def)):
        p = mod.WeightParams((3, 4), initializer="orthogonal")
        ws = defs(_jop("WEIGHT") if mod is jio else OpType.WEIGHT).weight_specs(p, [])
        assert [(w.name, tuple(w.spec.shape), w.initializer) for w in ws] == \
            [("weight", (3, 4), "orthogonal")]
    w = torch.randn(3, 4)
    assert get_op_def(OpType.WEIGHT).lower(io_ops.WeightParams((3, 4)), [], {"weight": w},
                                           LowerCtx())[0] is w
    a, b = torch.randn(2), torch.randn(3)
    assert get_op_def(OpType.NOOP).lower(io_ops.NoOpParams(), [a, b], {}, LowerCtx()) == [a, b]
    from flexflow_tpu_torch.runtime import initializers
    from flexflow_tpu_torch.core.tensor import TensorSpec

    q = initializers.get_initializer("orthogonal")(torch.Generator().manual_seed(0),
                                                   TensorSpec((4, 8)))
    torch.testing.assert_close(q @ q.T, torch.eye(4), atol=1e-5, rtol=0)


# ----------------------------------------------------------------- models
def _graph_rows(model, infer, get):
    specs = infer(model.graph)
    rows = []
    for n in model.graph.topo_order():
        params = {k: (v.value if hasattr(v, "value") else v)
                  for k, v in dataclasses.asdict(n.params).items()}
        ins = [specs[e.src][e.src_idx] for e in model.graph.in_edges(n)]
        rows.append((n.name, n.op_type.value, params, [tuple(s.shape) for s in specs[n.guid]],
                     [(w.name, tuple(w.spec.shape), w.trainable, w.initializer)
                      for w in get(n.op_type).weight_specs(n.params, ins)]))
    return rows


def _every_new_builder(m, batch: int):
    """``m`` with a graph of the new builders: create_weight, gather,
    reduce_sum, mean, batch_matmul, residual and rnn."""
    x = m.create_tensor((batch, 5, 4), name="x")
    idx = m.create_tensor((batch, 2, 4), DataType.INT32 if isinstance(m, FFModel)
                          else JDataType.INT32, name="idx")
    w = m.create_weight((batch, 4, 4), name="w")
    t = m.batch_matmul(x, w, name="bmm")
    t = m.residual(x, t, name="res")
    seq, hT = m.rnn(t, 6, name="rnn")
    g = m.gather(t, idx, axis=1, name="gather")
    s = m.reduce_sum(g, (1,), keepdims=False, name="rsum")
    u = m.mean(seq, (1,), keepdims=False, name="mean")
    m.concat([s, u, hT], axis=1, name="cat")  # [batch, 16]
    return m


NMT_KW = dict(src_vocab=50, tgt_vocab=50, embed_dim=16, hidden_size=16, num_layers=2,
              src_len=6, tgt_len=6)
REC_KW = {
    "mlp_unify": dict(in_dim=12, hidden=(16, 16, 8)),
    "dlrm": dict(embedding_sizes=(50,) * 3, embedding_dim=8, embedding_bag_size=2,
                 dense_dim=8, bottom_mlp=(16, 8), top_mlp=(16, 1)),
    "xdl": dict(embedding_sizes=(50,) * 3, embedding_dim=4, dense_dim=4, mlp=(16, 8, 1)),
    "candle_uno": dict(input_dims=(6, 10, 4), feature_layers=(8, 8), top_layers=(8, 1)),
}
BUILT = {
    "nmt": (lambda c: jnmt.build_nmt(c, **NMT_KW), lambda c: nmt.build_nmt(c, device="cpu",
                                                                         **NMT_KW)),
    **{k: (lambda c, k=k: getattr(jrec, f"build_{k}")(c, **REC_KW[k]),
           lambda c, k=k: getattr(recommender, f"build_{k}")(c, device="cpu", **REC_KW[k]))
       for k in REC_KW},
    "builders": (lambda c: _every_new_builder(JFFModel(c), c.batch_size),
                 lambda c: _every_new_builder(FFModel(c, device="cpu"), c.batch_size)),
}


@pytest.mark.parametrize("name", list(BUILT))
def test_builders_give_jax_graphs_and_json_reads_both_ways(name):
    """The graphs only (no compile): names, op types, params, output
    shapes and weight specs in the same order; each package's JSON read
    by the other writes the same JSON back."""
    jm = BUILT[name][0](JFFConfig(batch_size=4, workers_per_node=1))
    tm = BUILT[name][1](FFConfig(batch_size=4))
    assert _graph_rows(tm, infer_all_specs, get_op_def) == \
        _graph_rows(jm, jinfer_all_specs, jget_op_def)
    from flexflow_tpu.core.graph import PCGraph as JPCGraph

    assert PCGraph.from_json(jm.graph.to_json()).to_json() == jm.graph.to_json()
    assert JPCGraph.from_json(tm.graph.to_json()).to_json() == tm.graph.to_json()


def _nmt_batches(rs, n):
    return ([rs.randint(0, 50, (n, 6)).astype(np.int32), rs.randint(0, 50, (n, 6)).astype(np.int32)],
            rs.randint(0, 50, (n, 6)).astype(np.int32))


def _dlrm_batches(rs, n):
    xs = [rs.randint(0, 50, (n, 2)).astype(np.int32) for _ in range(3)]
    return xs + [rs.randn(n, 8).astype(np.float32)], rs.rand(n, 1).astype(np.float32)


def _builders_batches(rs, n):
    return ([rs.randn(n, 5, 4).astype(np.float32), rs.randint(-5, 5, (n, 2, 4)).astype(np.int32)],
            rs.randn(n, 16).astype(np.float32))


TRAINED = {
    "nmt": ("nmt", JLossType.SPARSE_CATEGORICAL_CROSSENTROPY, _nmt_batches, 0.5),
    "dlrm": ("dlrm", JLossType.MEAN_SQUARED_ERROR, _dlrm_batches, 0.1),
    "builders": ("builders", JLossType.MEAN_SQUARED_ERROR, _builders_batches, 0.05),
}


@pytest.mark.parametrize("name", list(TRAINED))
def test_three_sgd_steps_match_jax(name):
    """From the JAX model's weights (its graph read from JSON), three SGD
    steps on the same batches and keys: each loss, then every parameter."""
    built, jloss, batches, lr = TRAINED[name]
    batch = 4
    jm = BUILT[built][0](JFFConfig(batch_size=batch, workers_per_node=1))
    jm.compile(optimizer=JSGDOptimizer(lr=lr), loss_type=jloss)
    tm = port_from_jax(jm, FFConfig(batch_size=batch), SGDOptimizer(lr=lr),
                       LossType(jloss.value), [])
    xs, y = batches(np.random.RandomState(8), 3 * batch)
    for s in range(3):
        sl = slice(s * batch, (s + 1) * batch)
        jl = float(jm.executor.train_batch([jnp.asarray(x[sl]) for x in xs], jnp.asarray(y[sl]),
                                           jax.random.key(s))["loss"])
        tl = float(tm.executor.train_batch([x[sl] for x in xs], y[sl], rng=prng.key(s))["loss"])
        np.testing.assert_allclose(tl, jl, rtol=1e-5, err_msg=f"{name} step {s}")
    assert_weights_match(jm, tm, atol=1e-5)
