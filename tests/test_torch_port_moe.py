"""The mixture-of-experts slice of the port against the JAX package on
the CPU.

Each MoE op (TopK with ties, GroupBy stacked and listed with dropped
slots, Experts, Aggregate stacked and listed with its balance loss,
AggregateSpec with its hand-written gate rule and an expert chosen twice
by one token, Cache) takes the same numpy-seeded inputs in both packages,
forward and backward (the JAX side through ``jax.vjp``), in float32 and
bfloat16. Then ``build_moe_mlp`` from the JAX model's graph and weights:
routing first (top-k indices, and with them each slot's position and the
dropped slots), then three steps (loss rtol 1e-5, every parameter atol
1e-6), ``fit(trace_window=4)`` against JAX's window fit, the batched
layer against the per-expert one, ``recompile_on_condition`` and the
graph JSON both ways.

Tolerances: the routing ops copy and sum values, so TopK, GroupBy, Cache
and the AggregateSpec rows and expert gradients are bit for bit (their
sums run over the k = 2 slots, in one order in both packages). Float32
products and sums in another order: rtol 1e-5, atol 1e-6 (atol 2e-6 for
the Aggregate gate gradient, a sum over D of products). bfloat16: within
one bfloat16 ulp (2^-7 relative) of the largest |value| of the tensor,
the products being rounded once to bfloat16 from float32 sums taken in
another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.config import FFConfig as JFFConfig
from flexflow_tpu.core.graph import PCGraph as JPCGraph
from flexflow_tpu.core.types import LossType as JLossType
from flexflow_tpu.core.types import MetricsType as JMetricsType
from flexflow_tpu.model import FFModel as JFFModel
from flexflow_tpu.models.moe import build_moe_mlp as jbuild_moe_mlp
from flexflow_tpu.ops import moe_ops as jmoe
from flexflow_tpu.ops.base import LowerCtx as JLowerCtx
from flexflow_tpu.runtime.optimizers import SGDOptimizer as JSGDOptimizer
from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.core.graph import PCGraph
from flexflow_tpu_torch.core.types import LossType, MetricsType, OpType
from flexflow_tpu_torch.model import FFModel
from flexflow_tpu_torch.models import build_moe_mlp
from flexflow_tpu_torch.ops import moe_ops as tmoe
from flexflow_tpu_torch.ops.base import LowerCtx
from flexflow_tpu_torch.runtime import SGDOptimizer
from flexflow_tpu_torch.runtime.convert import params_from_numpy

from torch_port_cnn import assert_weights_match, named, port_from_jax

pytestmark = pytest.mark.torch_port

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
MOE = dict(in_dim=24, num_classes=4, num_experts=4, num_select=2, expert_hidden=16, alpha=1.0,
           lambda_bal=0.04)
BATCH, LR = 16, 0.05


def _jctx():
    return JLowerCtx(training=True, rng=jax.random.key(0), backend="cpu")


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32)) if t.dtype != jnp.int32 else np.asarray(t)


def _assert_close(name, got, want, dtype, rtol=1e-5, atol=1e-6):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    if dtype == "bfloat16":
        atol, rtol = 2.0 ** -7 * max(1e-30, float(np.abs(want).max())), 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=name)


def _pair(arr, dtype):
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(arr).astype(jdt), torch.from_numpy(np.asarray(arr)).to(tdt)


def _run(op, jparams, tparams, jins, tins, cts, grad_of, jweights=None, tweights=None):
    """Forward and backward of one op in both packages: the outputs, and
    the gradients of sum(out_i * ct_i) with respect to the inputs named
    by ``grad_of`` (indices) and to the weights."""
    jweights, tweights = jweights or {}, tweights or {}
    jdef, tdef = jmoe.__dict__[op], tmoe.__dict__[op]

    def jf(diff, w):
        ins = list(jins)
        for i, v in zip(grad_of, diff):
            ins[i] = v
        return jdef.lower(jparams, ins, w, _jctx())

    jouts, vjp = jax.vjp(jax.jit(jf), [jins[i] for i in grad_of], jweights)
    jgrads = vjp([jnp.asarray(c).astype(o.dtype) for c, o in zip(cts, jouts)])
    tins = list(tins)
    for i in grad_of:
        tins[i] = tins[i].clone().requires_grad_(True)
    tw = {k: v.clone().requires_grad_(True) for k, v in tweights.items()}
    touts = tdef.lower(tparams, tins, tw, LowerCtx())
    loss = sum((o.float() * torch.from_numpy(np.asarray(c, np.float32))).sum()
               for o, c in zip(touts, cts))
    loss.backward()
    tgrads = [tins[i].grad for i in grad_of], {k: v.grad for k, v in tw.items()}
    return jouts, touts, jgrads, tgrads


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_topk_resolves_ties_lowest_index_first(dtype):
    """The k-th value repeated in each row: jax.lax.top_k's order (equal
    values lowest index first) in the values, the indices and the values'
    gradient, bit for bit."""
    rs = np.random.RandomState(1)
    x = rs.randint(0, 4, (6, 9)).astype(np.float32) / 4  # many ties
    x[0] = 0.5
    jx, tx = _pair(x, dtype)
    ct = rs.randn(6, 3).astype(np.float32)
    jo, to, jg, tg = _run("TopKOp", jmoe.TopKParams(3), tmoe.TopKParams(3), [jx], [tx],
                          [ct, np.zeros((6, 3), np.float32)], [0])
    np.testing.assert_array_equal(np.asarray(jo[1]), to[1].numpy())
    assert to[1].dtype == torch.int32
    np.testing.assert_array_equal(_np(jo[0]), _np(to[0]))
    np.testing.assert_array_equal(_np(jg[0][0]), _np(tg[0][0]))
    assert list(to[1][0].numpy()) == [0, 1, 2]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("stacked", [True, False], ids=["stacked", "listed"])
def test_group_by_drops_slots_as_jax(stacked, dtype):
    """alpha 0.5 (capacity 4 of 8 slots an expert on average): the buffers
    and the data's gradient bit for bit, slots dropped."""
    rs = np.random.RandomState(2)
    b, d, n, k, alpha = 16, 6, 4, 2, 0.5
    data = rs.randn(b, d).astype(np.float32)
    assign = rs.randint(0, n, (b, k)).astype(np.int32)
    cap = jmoe.expert_capacity(b, k, n, alpha)
    assert cap == tmoe.expert_capacity(b, k, n, alpha) == 4
    flat, pos = tmoe._dispatch_positions(torch.from_numpy(assign), n)
    assert int((pos >= cap).sum()) > 0, "no slot dropped: the case tests nothing"
    jd, td = _pair(data, dtype)
    ja, ta = jnp.asarray(assign), torch.from_numpy(assign)
    outs = n if not stacked else 1
    shape = (cap, d) if not stacked else (n, cap, d)
    cts = [rs.randn(*shape).astype(np.float32) for _ in range(outs)]
    jo, to, jg, tg = _run("GroupByOp", jmoe.GroupByParams(n, alpha, stacked),
                          tmoe.GroupByParams(n, alpha, stacked), [jd, ja], [td, ta], cts, [0])
    assert len(jo) == len(to) == outs
    for a, c in zip(jo, to):
        np.testing.assert_array_equal(_np(a), _np(c))
    np.testing.assert_array_equal(_np(jg[0][0]), _np(tg[0][0]))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_experts_match_jax(dtype):
    rs = np.random.RandomState(3)
    n, cap, d, h, o = 4, 5, 6, 8, 6
    x = rs.randn(n, cap, d).astype(np.float32)
    ws = {"w1": rs.randn(n, d, h) * 0.3, "b1": rs.randn(n, h) * 0.1, "w2": rs.randn(n, h, o) * 0.3,
          "b2": rs.randn(n, o) * 0.1}
    ws = {k: v.astype(np.float32) for k, v in ws.items()}
    jdt = {"float32": "FLOAT", "bfloat16": "BFLOAT16"}[dtype]
    from flexflow_tpu.core.types import ActiMode as JActi
    from flexflow_tpu.core.types import DataType as JDataType
    from flexflow_tpu_torch.core.types import ActiMode, DataType

    jp = jmoe.ExpertsParams(n, h, o, JActi.RELU, getattr(JDataType, jdt))
    tp = tmoe.ExpertsParams(n, h, o, ActiMode.RELU, getattr(DataType, jdt))
    jx, tx = _pair(x, dtype)
    jw = {k: _pair(v, dtype)[0] for k, v in ws.items()}
    tw = {k: _pair(v, dtype)[1] for k, v in ws.items()}
    ct = rs.randn(n, cap, o).astype(np.float32)
    jo, to, jg, tg = _run("ExpertsOp", jp, tp, [jx], [tx], [ct], [0], jw, tw)
    assert to[0].dtype == DTYPES[dtype][1]
    _assert_close("out", to[0], jo[0], dtype)
    _assert_close("dx", tg[0][0], jg[0][0], dtype)
    for k in ws:
        _assert_close(k, tg[1][k], jg[1][k], dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("stacked", [True, False], ids=["stacked", "listed"])
def test_aggregate_and_balance_loss_match_jax(stacked, dtype):
    """Capacity 3 (slots dropped): the output, the gate and expert
    gradients, and the lambda_bal balance loss in float32."""
    rs = np.random.RandomState(4)
    n, cap, d, b, k = 4, 3, 5, 8, 2
    gate = rs.rand(b, k).astype(np.float32)
    assign = rs.randint(0, n, (b, k)).astype(np.int32)
    experts = rs.randn(n, cap, d).astype(np.float32)
    jg_, tg_ = _pair(gate, dtype)
    ja, ta = jnp.asarray(assign), torch.from_numpy(assign)
    je, te = _pair(experts, dtype)
    jins = [jg_, ja] + ([je] if stacked else [je[e] for e in range(n)])
    tins = [tg_, ta] + ([te] if stacked else [te[e] for e in range(n)])
    grad_of = list(range(len(jins)))
    grad_of.remove(1)
    ct = rs.randn(b, d).astype(np.float32)
    jo, to, jg, tg = _run("AggregateOp", jmoe.AggregateParams(n, 0.04),
                          tmoe.AggregateParams(n, 0.04), jins, tins, [ct], grad_of)
    _assert_close("out", to[0], jo[0], dtype)
    _assert_close("gate grad", tg[0][0], jg[0][0], dtype, atol=2e-6)
    for i, (a, c) in enumerate(zip(jg[0][1:], tg[0][1:])):
        _assert_close(f"expert grad {i}", c, a, dtype)
    jctx, tctx = _jctx(), LowerCtx()
    jmoe.AggregateOp.lower(jmoe.AggregateParams(n, 0.04), jins, {}, jctx)
    tmoe.AggregateOp.lower(tmoe.AggregateParams(n, 0.04), tins, {}, tctx)
    assert len(tctx.aux_losses) == len(jctx.aux_losses) == 1
    assert tctx.aux_losses[0].dtype == torch.float32
    np.testing.assert_allclose(float(tctx.aux_losses[0]), float(jctx.aux_losses[0]), rtol=1e-6)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("lambda_bal", [0.0, 0.01])
def test_aggregate_spec_follows_the_hand_written_gate_rule(lambda_bal, dtype):
    """Token 0 picks one expert in both slots (the rule's scatter adds
    twice): rows and the expert gradient bit for bit, the gate gradient
    (JAX's custom_vjp) at the float32 gate."""
    rs = np.random.RandomState(5)
    n, cap, d, b, k = 4, 6, 5, 6, 2
    gate = rs.rand(b, k).astype(np.float32)
    assign = rs.randint(0, n, (b, k)).astype(np.int32)
    assign[0, 1] = assign[0, 0]
    stacked = rs.randn(n, cap, d).astype(np.float32)
    jg_, tg_ = _pair(gate, dtype)
    je, te = _pair(stacked, dtype)
    ja, ta = jnp.asarray(assign), torch.from_numpy(assign)
    ct = rs.randn(b * k, d).astype(np.float32)
    jo, to, jg, tg = _run("AggregateSpecOp", jmoe.AggregateSpecParams(n, lambda_bal),
                          tmoe.AggregateSpecParams(n, lambda_bal), [jg_, ja, je], [tg_, ta, te],
                          [ct], [0, 2])
    np.testing.assert_array_equal(_np(jo[0]), _np(to[0]))
    np.testing.assert_array_equal(_np(jg[0][1]), _np(tg[0][1]))
    assert tg[0][0].dtype == DTYPES[dtype][1]
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == "float32" else {}
    _assert_close("gate grad", tg[0][0], jg[0][0], dtype, **tol)
    assert np.any(_np(tg[0][0]) != 0)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_cache_is_identity(dtype):
    rs = np.random.RandomState(6)
    x = rs.randn(4, 5).astype(np.float32)
    jx, tx = _pair(x, dtype)
    ct = rs.randn(4, 5).astype(np.float32)
    jo, to, jg, tg = _run("CacheOp", jmoe.CacheParams(4), tmoe.CacheParams(4), [jx], [tx], [ct],
                          [0])
    np.testing.assert_array_equal(_np(jo[0]), _np(to[0]))
    np.testing.assert_array_equal(_np(jg[0][0]), _np(tg[0][0]))


# ------------------------------------------------------------- the model
def _topk_node(graph):
    return next(n for n in graph.topo_order() if n.op_type.value == "topk")


def routing(jm, tm, x):
    """(JAX, port) top-k values and indices of one batch from each
    model's current weights (each executor's own forward, its outputs
    swapped for the top-k node's and the gate's), and the smallest margin
    between the k-th and the (k+1)-th gate value (JAX's)."""
    guid = _topk_node(jm.graph).guid
    gate = next(n for n in jm.graph.topo_order() if n.name == "moe_gate_sm").guid
    jex, tex = jm.executor, tm.executor
    saved = jex.outputs, tex.outputs
    jex.outputs = tex.outputs = [(guid, 0), (guid, 1), (gate, 0)]
    try:
        jv, ji, jgate = jax.jit(lambda p, s, xx: jex._forward_impl(
            p, s, [xx], jax.random.key(0), training=False)[0])(jex.params, jex.state,
                                                                jnp.asarray(x))
        with torch.no_grad():
            tv, ti, _ = tex._forward_impl(tex.params, tex.state, [torch.from_numpy(x)],
                                          training=False)[0]
    finally:
        jex.outputs, tex.outputs = saved
    gates = np.sort(np.asarray(jgate), axis=-1)[:, ::-1]
    k = MOE["num_select"]
    margin = float((gates[:, k - 1] - gates[:, k]).min())
    return (np.asarray(jv), np.asarray(ji)), (tv.numpy(), ti.numpy()), margin


def _dropped(indices, n, cap):
    flat, pos = tmoe._dispatch_positions(torch.from_numpy(np.array(indices)), n)
    return (pos >= cap).numpy()


@pytest.fixture(scope="module")
def moe_pair():
    """(JAX model, port model) of build_moe_mlp from one set of weights
    (the port built from the JAX graph's JSON), trained alike by each
    test in turn."""
    jm = jbuild_moe_mlp(JFFConfig(batch_size=BATCH, workers_per_node=1), **MOE)
    jm.compile(optimizer=JSGDOptimizer(lr=LR), loss_type=JLossType.SPARSE_CATEGORICAL_CROSSENTROPY,
               metrics=[JMetricsType.ACCURACY])
    tm = port_from_jax(jm, FFConfig(batch_size=BATCH), SGDOptimizer(lr=LR),
                       LossType.SPARSE_CATEGORICAL_CROSSENTROPY, [MetricsType.ACCURACY])
    return jm, tm


def _batches(seed, n):
    rs = np.random.RandomState(seed)
    return (rs.randn(n * BATCH, MOE["in_dim"]).astype(np.float32),
            rs.randint(0, MOE["num_classes"], (n * BATCH,)).astype(np.int32))


def test_experts_weights_cross_as_3d_and_2d(moe_pair):
    """params_from_numpy carries the experts' [n, D, H] / [n, H, O] and
    [n, H] / [n, O] weights as they are."""
    jm, tm = moe_pair
    ws = named(jm, jm.executor.params)["moe_experts"]
    got = params_from_numpy({"moe_experts": ws})["moe_experts"]
    for k, v in ws.items():
        assert tuple(got[k].shape) == v.shape and got[k].dtype == torch.float32
        np.testing.assert_array_equal(tm.get_weight("moe_experts", k), v)
    assert ws["w1"].ndim == 3 and ws["b1"].ndim == 2


def test_three_steps_route_and_train_as_jax(moe_pair):
    """Before each of three SGD steps the routing is equal (indices, so the
    positions and the dropped slots too; at least one slot dropped over
    the three batches); each step's loss (the balance loss included)
    within rtol 1e-5; every parameter within 1e-6 after."""
    jm, tm = moe_pair
    x, y = _batches(7, 3)
    cap = jmoe.expert_capacity(BATCH, MOE["num_select"], MOE["num_experts"], MOE["alpha"])
    dropped = 0
    for s in range(3):
        xb, yb = x[s * BATCH:(s + 1) * BATCH], y[s * BATCH:(s + 1) * BATCH]
        (jv, ji), (tv, ti), margin = routing(jm, tm, xb)
        assert margin > 0
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-7)
        drop = _dropped(ji, MOE["num_experts"], cap)
        dropped += int(drop.sum())
        lj = float(jm.executor.train_batch([jnp.asarray(xb)], jnp.asarray(yb),
                                           jax.random.key(s))["loss"])
        from flexflow_tpu_torch.generation import prng

        lt = float(tm.executor.train_batch([xb], yb, rng=prng.key(s))["loss"])
        np.testing.assert_allclose(lt, lj, rtol=1e-5)
    assert dropped > 0
    assert_weights_match(jm, tm, atol=1e-6)


def _recorded(jm):
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


def test_fit_window_matches_jax(moe_pair):
    """fit(trace_window=4) over six batches (one window of four, two tail
    steps) against the JAX package's window fit: each loss rtol 1e-5, the
    accuracy counts equal, every parameter within 1e-6."""
    jm, tm = moe_pair
    x, y = _batches(8, 6)
    jlosses = _recorded(jm)
    try:
        jperf = jm.fit(jnp.asarray(x), jnp.asarray(y), epochs=1, verbose=False, trace_window=4)
    finally:
        del jm.executor.train_window, jm.executor.train_batch
    tperf = tm.fit(x, y, epochs=1, verbose=False, trace_window=4)
    np.testing.assert_allclose(tm.step_losses, jlosses, rtol=1e-5)
    assert tperf.train_correct == jperf.train_correct and tperf.train_all == jperf.train_all
    assert_weights_match(jm, tm, atol=1e-6)


def _per_expert(model_cls, config, device=None):
    m = model_cls(config) if device is None else model_cls(config, device=device)
    x = m.create_tensor((BATCH, MOE["in_dim"]), name="input")
    t = m.moe(x, MOE["num_experts"], MOE["num_select"], MOE["expert_hidden"], alpha=2.0,
              lambda_bal=0.0, batched=False, name="moe")
    t = m.dense(t, MOE["num_classes"], name="head")
    m.softmax(t, name="softmax")
    return m


def test_batched_moe_matches_per_expert_moe_in_the_port():
    """The batched Experts op against n separate Dense pairs holding the
    same weights (the JAX package's test_moe_ep.py case, in the port):
    outputs within rtol 1e-5, atol 1e-6."""
    kw = {**MOE, "alpha": 2.0, "lambda_bal": 0.0}
    mb = build_moe_mlp(FFConfig(batch_size=BATCH), device="cpu", **kw)
    mb.compile(optimizer=SGDOptimizer(lr=LR), loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY)
    mp = _per_expert(FFModel, FFConfig(batch_size=BATCH), device="cpu")
    mp.compile(optimizer=SGDOptimizer(lr=LR), loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY)
    for layer in ("moe_gate", "head"):
        for w in ("kernel", "bias"):
            mp.set_weight(layer, w, mb.get_weight(layer, w))
    for e in range(MOE["num_experts"]):
        mp.set_weight(f"moe_exp{e}", "kernel", mb.get_weight("moe_experts", "w1")[e])
        mp.set_weight(f"moe_exp{e}", "bias", mb.get_weight("moe_experts", "b1")[e])
        mp.set_weight(f"moe_exp{e}_out", "kernel", mb.get_weight("moe_experts", "w2")[e])
        mp.set_weight(f"moe_exp{e}_out", "bias", mb.get_weight("moe_experts", "b2")[e])
    x = np.random.RandomState(2).randn(BATCH, MOE["in_dim"]).astype(np.float32)
    np.testing.assert_allclose(mp.predict(x).numpy(), mb.predict(x).numpy(), rtol=1e-5, atol=1e-6)


def test_recompile_on_condition_matches_jax():
    """moe.cc's cache flow: build_moe_mlp(use_cache=True), one step, then
    a trigger on cache_score. Below the threshold nothing happens; above
    it alter runs, the model compiles anew (recompilations 1 on both
    sides), every weight equals its value before, by name, bit for bit,
    and the next two steps' losses agree with JAX's (rtol 1e-5)."""
    jm = jbuild_moe_mlp(JFFConfig(batch_size=BATCH, workers_per_node=1), use_cache=True, **MOE)
    jm.compile(optimizer=JSGDOptimizer(lr=LR), loss_type=JLossType.SPARSE_CATEGORICAL_CROSSENTROPY)
    tm = port_from_jax(jm, FFConfig(batch_size=BATCH), SGDOptimizer(lr=LR),
                       LossType.SPARSE_CATEGORICAL_CROSSENTROPY, [])
    assert any(n.op_type == OpType.CACHE for n in tm.graph.nodes.values())
    x, y = _batches(9, 3)
    jm.executor.train_batch([jnp.asarray(x[:BATCH])], jnp.asarray(y[:BATCH]), jax.random.key(0))
    tm.executor.train_batch([x[:BATCH]], y[:BATCH])
    before = {k: {w: a.copy() for w, a in ws.items()}
              for k, ws in named(jm, jm.executor.params).items()}
    tbefore = {layer: {w: tm.get_weight(layer, w) for w in ws} for layer, ws in before.items()}
    states, old_tex = [], tm.executor
    for m in (jm, tm):
        calls = []
        st = m.recompile_on_condition(lambda s: s.cache_score > 0.5, lambda s: calls.append(1))
        st.cache_score = 0.1
        assert not st.trigger_and_alter() and not calls and st.recompilations == 0
        st.cache_score = 0.9
        assert st.trigger_and_alter() and calls == [1] and st.recompilations == 1
        states.append(st)
    assert tm.executor is not old_tex and not old_tex._graphs
    for layer, ws in before.items():
        for w, a in ws.items():
            np.testing.assert_array_equal(tm.get_weight(layer, w), tbefore[layer][w])
            np.testing.assert_array_equal(np.asarray(named(jm, jm.executor.params)[layer][w]), a)
    for s in (1, 2):
        xb, yb = x[s * BATCH:(s + 1) * BATCH], y[s * BATCH:(s + 1) * BATCH]
        lj = float(jm.executor.train_batch([jnp.asarray(xb)], jnp.asarray(yb),
                                           jax.random.key(0))["loss"])
        lt = float(tm.executor.train_batch([xb], yb)["loss"])
        np.testing.assert_allclose(lt, lj, rtol=1e-5)


@pytest.mark.parametrize("variant", ["batched", "per_expert", "cache_spec"])
def test_moe_graph_json_both_ways(variant):
    """A graph of the MoE ops written by each package reads back in the
    other and writes the same JSON text."""

    def build(model_cls, cfg, **kw):
        if variant == "batched":
            return (jbuild_moe_mlp if model_cls is JFFModel else build_moe_mlp)(cfg, **MOE, **kw)
        if variant == "per_expert":
            return _per_expert(model_cls, cfg, **kw)
        m = model_cls(cfg, **kw)
        x = m.create_tensor((BATCH, 8), name="input")
        t = m.cache(x, num_batches=2, trigger_threshold=0.5, name="cache")
        g = m.softmax(m.dense(t, 4, name="gate"), name="gate_sm")
        v, i = m.top_k(g, 2, name="topk")
        grouped = m.group_by(t, i, 4, 1.5, name="groupby")
        return m, m.aggregate_spec(v, i, grouped, 4, 0.01, name="spec")

    jm = build(JFFModel, JFFConfig(batch_size=BATCH, workers_per_node=1))
    tm = build(FFModel, FFConfig(batch_size=BATCH), device="cpu")
    jm, tm = (jm[0], tm[0]) if isinstance(jm, tuple) else (jm, tm)
    jtext = jm.graph.to_json()
    assert PCGraph.from_json(jtext).to_json() == jtext
    ttext = tm.graph.to_json()
    assert JPCGraph.from_json(ttext).to_json() == ttext
    # the same calls record the same nodes and edges, guids aside
    strip = lambda g: [(n.op_type.value, n.name, repr(n.params)) for n in g.topo_order()]
    assert [(o, nm) for o, nm, _ in strip(tm.graph)] == [(o, nm) for o, nm, _ in strip(jm.graph)]
