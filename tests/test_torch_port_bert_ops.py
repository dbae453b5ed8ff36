"""The BERT heads' operators of the port (``ops/softmax.py``,
``ops/embedding.py``, ``ops/shape_ops.py``, the attention dropout tail)
against the JAX package's ops on the CPU: the same numpy inputs through
each op's ``lower``, forward and gradients (``jax.vjp`` against
autograd, with the same cotangent).

Gates:

* float32: atol 1e-5 (XLA's exp and PyTorch's differ in the last bits).
* Copies and selections (the shape ops, a lookup without aggregation,
  dropout with its mask) are exact in every dtype: bit for bit.
* Softmax in bf16 and fp16: the forward equals JAX's bit for bit (the
  port rounds where JAX's eager ops round; its float32 row sum runs in
  another order and rounded once to the type gave the same bits here).
  Its gradient equals, bit for bit, JAX's own linearized ops with the
  row sum ``sum(g * s^-2 * u)`` accumulated in float32. ``jax.vjp``
  sums that row in the 2-byte type in XLA's order instead; a sum of n
  terms rounded at each of its n - 1 additions is off by at most
  (n - 1) u sum|terms| (u the type's unit roundoff, any order), and the
  gradient multiplies it by ``u_elem = exp(x - max)`` <= 1 after two
  more roundings, so the port is held to ``jax.vjp`` within
  2 ulp + (n - 1) u sum|terms| u_elem.
* Embedding SUM / AVG and the table's gradient in bf16 (sums of k
  terms: JAX's forward accumulates in float32 and rounds once, its
  scatter-add transpose rounds at each addition in its own order): one
  ulp + (k - 1) u sum|terms|, k the most terms any output sums.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.core.types import AggrMode as JAggrMode
from flexflow_tpu.core.types import DataType as JDataType
from flexflow_tpu.ops import attention as jattn
from flexflow_tpu.ops import embedding as jemb
from flexflow_tpu.ops import shape_ops as jshape
from flexflow_tpu.ops import softmax as jsoftmax
from flexflow_tpu.ops.base import LowerCtx as JLowerCtx
from flexflow_tpu_torch.core.types import AggrMode, DataType
from flexflow_tpu_torch.generation import prng
from flexflow_tpu_torch.ops import attention as tattn
from flexflow_tpu_torch.ops import embedding as temb
from flexflow_tpu_torch.ops import shape_ops as tshape
from flexflow_tpu_torch.ops import softmax as tsoftmax
from flexflow_tpu_torch.ops.base import LowerCtx
from flexflow_tpu_torch.runtime.convert import to_tensor

pytestmark = pytest.mark.torch_port

# name -> (jnp dtype, stored mantissa bits, least normal exponent)
TYPES = {"float32": (jnp.float32, 23, -126), "bfloat16": (jnp.bfloat16, 7, -126),
         "float16": (jnp.float16, 10, -14)}
GUID = 4321


def _u(dt: str) -> float:
    return 2.0 ** -(TYPES[dt][1] + 1)


def _ulp(x: np.ndarray, dt: str) -> np.ndarray:
    _, mant, emin = TYPES[dt]
    e = np.floor(np.log2(np.maximum(np.abs(x).astype(np.float64), 2.0 ** -150)))
    return 2.0 ** (np.maximum(e, emin) - mant)


def _j(a: np.ndarray, dt: str):
    return jnp.asarray(a, TYPES[dt][0])


def _t(a, grad: bool = False) -> torch.Tensor:
    t = to_tensor(np.array(a)).clone()
    return t.requires_grad_(True) if grad else t


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _exact(name, got, want):
    g, w = _f32(got), _f32(want)
    assert g.shape == w.shape, f"{name}: shape {g.shape} != {w.shape}"
    np.testing.assert_array_equal(g, w, err_msg=name)


def _cotangent(seed, shape) -> np.ndarray:
    return np.asarray(np.random.RandomState(seed).randn(*shape), np.float32)


def _vjp_both(jfn, tfn, jins, cot_seed=0):
    """(JAX output, JAX input cotangents, port output, port input grads)
    of one op with the same random cotangent."""
    jout, vjp = jax.vjp(jfn, *jins)
    jct = jnp.asarray(_cotangent(cot_seed, jout.shape), jout.dtype)
    jgrads = vjp(jct)
    tins = [_t(np.asarray(a), grad=True) for a in jins]
    tout = tfn(*tins)
    tout.backward(_t(np.asarray(jct)))
    return jout, jgrads, tout, [t.grad for t in tins]


# ------------------------------------------------------------------ softmax
@pytest.mark.parametrize("dt", list(TYPES))
@pytest.mark.parametrize("n", [7, 50, 513])
def test_softmax_matches_jax(dt, n):
    rs = np.random.RandomState(n)
    x = _j(rs.randn(3, 5, n) * 3, dt)
    jp, tp = jsoftmax.SoftmaxParams(-1), tsoftmax.SoftmaxParams(-1)
    jout, (jgx,), tout, (tgx,) = _vjp_both(
        lambda a: jsoftmax.SoftmaxOp.lower(jp, [a], {}, JLowerCtx())[0],
        lambda a: tsoftmax.SoftmaxOp.lower(tp, [a], {}, LowerCtx())[0], [x], cot_seed=n)
    assert tout.dtype == tgx.dtype == getattr(torch, dt)
    if dt == "float32":
        np.testing.assert_allclose(_f32(tout), _f32(jout), atol=1e-5, rtol=0)
        np.testing.assert_allclose(_f32(tgx), _f32(jgx), atol=1e-5, rtol=0)
        return
    _exact("softmax forward", tout, jout)
    # JAX's linearized ops (u = exp(x - max), s = sum(u), y = u / s),
    # with the row sum of the quotient's cotangent accumulated in float32
    g = jnp.asarray(_cotangent(n, x.shape), x.dtype)
    u = jnp.exp(x - x.max(-1, keepdims=True))
    s = jnp.sum(u, -1, keepdims=True)
    terms = g * s ** -2 * u
    back = jnp.sum(terms.astype(jnp.float32), -1, keepdims=True).astype(x.dtype)
    _exact("softmax gradient vs JAX's ops with a float32 row sum", tgx, (g / s - back) * u)
    want = _f32(jgx)
    gate = 2 * _ulp(want, dt) + (n - 1) * _u(dt) * np.abs(_f32(terms)).sum(
        -1, keepdims=True) * _f32(u)
    bad = np.abs(_f32(tgx) - want) > gate
    assert not bad.any(), f"{int(bad.sum())} of {bad.size} gradients beyond the gate"


# ------------------------------------------------------------------ dropout
@pytest.mark.parametrize("dt", list(TYPES))
def test_dropout_mask_bits_and_values_equal_jax(dt):
    rs = np.random.RandomState(1)
    x = _j(rs.randn(4, 6, 40), dt)
    rate, seed = 0.1, 11
    key = jax.random.fold_in(jax.random.key(seed), 3)  # a step key, as fit() splits one
    tkey = prng.fold_in(prng.key(seed), 3)
    mask = np.asarray(jax.random.bernoulli(jax.random.fold_in(key, GUID), 1 - rate, x.shape))
    tmask = prng.bernoulli(prng.fold_in(tkey, GUID), 1 - rate, x.shape).numpy()
    np.testing.assert_array_equal(tmask, mask)
    assert 0.8 < mask.mean() < 0.97
    jp, tp = jsoftmax.DropoutParams(rate), tsoftmax.DropoutParams(rate)
    jout, (jgx,), tout, (tgx,) = _vjp_both(
        lambda a: jsoftmax.DropoutOp.lower(jp, [a], {}, JLowerCtx(rng=key, node_guid=GUID))[0],
        lambda a: tsoftmax.DropoutOp.lower(tp, [a], {}, LowerCtx(rng=tkey, node_guid=GUID))[0],
        [x])
    assert tout.dtype == getattr(torch, dt)
    _exact("dropout forward", tout, jout)
    _exact("dropout gradient", tgx, jgx)
    np.testing.assert_array_equal(_f32(tout) != 0, mask & (_f32(x) != 0))
    # the identity outside training and at rate 0
    tx = _t(np.asarray(x))
    assert tsoftmax.DropoutOp.lower(tp, [tx], {}, LowerCtx(training=False, rng=tkey))[0] is tx
    zero = tsoftmax.DropoutParams(0.0)
    assert tsoftmax.DropoutOp.lower(zero, [tx], {}, LowerCtx(rng=tkey))[0] is tx
    with pytest.raises(ValueError, match="RNG"):
        tsoftmax.DropoutOp.lower(tp, [tx], {}, LowerCtx())


def test_split_and_bernoulli_chain_equal_jax():
    """``rng, sub = split(rng)`` chained, ``split(sub, k)``, then a mask
    over a multi-dim shape (the flat counter layout)."""
    j, t = jax.random.key(5), prng.key(5)
    for _ in range(3):
        j, jsub = jax.random.split(j)
        t, tsub = prng.split(t)
    jkeys = jax.random.split(jsub, 4)
    tkeys = prng.split(tsub, 4)
    for jk, tk in zip(jkeys, tkeys):
        np.testing.assert_array_equal(np.asarray(jax.random.key_data(jk)),
                                      [int(tk[0]), int(tk[1])])
    m = jax.random.bernoulli(jax.random.fold_in(jkeys[2], 77), 0.9, (2, 3, 4))
    tm = prng.bernoulli(prng.fold_in(tkeys[2], 77), 0.9, (2, 3, 4))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(m))


def test_attention_dropout_tail_matches_jax():
    """MultiHeadAttention's output dropout after ``wo`` and the bias, at
    the node's guid, float32."""
    rs = np.random.RandomState(2)
    b, s, e, h = 2, 8, 16, 2
    jp = jattn.MultiHeadAttentionParams(e, h, dropout=0.25, use_bias=True)
    tp = tattn.MultiHeadAttentionParams(e, h, dropout=0.25, use_bias=True)
    ws = {"wq": (e, h, e // h), "wk": (e, h, e // h), "wv": (e, h, e // h), "wo": (h, e // h, e),
          "bq": (h, e // h), "bk": (h, e // h), "bv": (h, e // h), "bo": (e,)}
    w = {k: (rs.randn(*shape) * 0.3).astype(np.float32) for k, shape in ws.items()}
    x = rs.randn(b, s, e).astype(np.float32)
    key = jax.random.key(9)
    jout = jattn.MultiHeadAttentionOp.lower(
        jp, [jnp.asarray(x)] * 3, {k: jnp.asarray(v) for k, v in w.items()},
        JLowerCtx(rng=key, node_guid=GUID, backend="cpu"))[0]
    tout = tattn.MultiHeadAttentionOp.lower(
        tp, [torch.from_numpy(x)] * 3, {k: torch.from_numpy(v) for k, v in w.items()},
        LowerCtx(rng=prng.key(9), node_guid=GUID))[0]
    np.testing.assert_array_equal(_f32(tout) == 0, _f32(jout) == 0)
    assert 0 < (_f32(tout) == 0).mean() < 0.5
    np.testing.assert_allclose(_f32(tout), _f32(jout), atol=1e-5, rtol=0)
    # inference: no mask
    nodrop = tattn.MultiHeadAttentionOp.lower(
        tp, [torch.from_numpy(x)] * 3, {k: torch.from_numpy(v) for k, v in w.items()},
        LowerCtx(training=False))[0]
    assert not (_f32(nodrop) == 0).any()


# ---------------------------------------------------------------- embedding
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("idx_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("aggr", ["none", "sum", "avg"])
def test_embedding_matches_jax(aggr, idx_dtype, dt):
    rs = np.random.RandomState(3)
    n, d = 12, 8
    idx = rs.randint(0, n, (4, 6)).astype(idx_dtype)  # repeats across rows and bags
    table = _j(rs.randn(n, d), dt)
    jp = jemb.EmbeddingParams(n, d, JAggrMode(aggr), JDataType(dt))
    tp = temb.EmbeddingParams(n, d, AggrMode(aggr), DataType(dt))
    jout, (jgt,), tout, (tgt,) = _vjp_both(
        lambda w: jemb.EmbeddingOp.lower(jp, [jnp.asarray(idx)], {"embedding": w}, JLowerCtx())[0],
        lambda w: temb.EmbeddingOp.lower(tp, [torch.from_numpy(idx)], {"embedding": w},
                                         LowerCtx())[0],
        [table])
    assert tout.dtype == tgt.dtype == getattr(torch, dt)
    if dt == "float32":
        np.testing.assert_allclose(_f32(tout), _f32(jout), atol=1e-5, rtol=0)
        np.testing.assert_allclose(_f32(tgt), _f32(jgt), atol=1e-5, rtol=0)
        return
    if aggr == "none":
        _exact("lookup", tout, jout)
    else:
        # k = 6 float32-accumulated terms, rounded once on both sides
        w = _f32(jout)
        terms = np.abs(_f32(table)[idx]).sum(-2)
        assert (np.abs(_f32(tout) - w) <= _ulp(w, dt) + 5 * _u(dt) * terms).all()
    # the table's gradient: every row sums the cotangents of its uses
    want = _f32(jgt)
    k = max(int((idx == r).sum()) for r in range(n))
    cot = np.abs(_f32(jnp.asarray(_cotangent(0, jout.shape), jout.dtype)))
    uses = np.zeros((n, d), np.float32)
    flat_cot = cot if aggr == "none" else np.repeat(cot[:, None, :], idx.shape[-1], 1)
    np.add.at(uses, idx.reshape(-1), flat_cot.reshape(-1, d) / (6 if aggr == "avg" else 1))
    gate = _ulp(want, dt) + max(k - 1, 0) * _u(dt) * uses * 2
    bad = np.abs(_f32(tgt) - want) > gate
    assert not bad.any(), f"{int(bad.sum())} table gradients beyond the gate"


def test_embedding_out_of_range_and_negative_indices_match_jax():
    table = np.arange(12, dtype=np.float32).reshape(4, 3)
    idx = np.array([[0, -1, 3, 4, -5, 2]], np.int32)
    jp = jemb.EmbeddingParams(4, 3)
    tp = temb.EmbeddingParams(4, 3)
    want = np.asarray(jemb.EmbeddingOp.lower(jp, [jnp.asarray(idx)],
                                             {"embedding": jnp.asarray(table)}, JLowerCtx())[0])
    got = temb.EmbeddingOp.lower(tp, [torch.from_numpy(idx)],
                                 {"embedding": torch.from_numpy(table)}, LowerCtx())[0].numpy()
    np.testing.assert_array_equal(got, want)  # NaN rows where JAX fills them
    assert np.isnan(got[0, 3]).all() and np.isnan(got[0, 4]).all()


# ---------------------------------------------------------------- shape ops
SHAPE_CASES = {
    "reshape": (lambda m: m.ReshapeParams((4, -1)), "ReshapeOp", 1),
    "transpose": (lambda m: m.TransposeParams((2, 0, 1)), "TransposeOp", 1),
    "reverse": (lambda m: m.ReverseParams(1), "ReverseOp", 1),
    "flat": (lambda m: m.FlatParams(), "FlatOp", 1),
    "concat": (lambda m: m.ConcatParams(1, 2), "ConcatOp", 2),
    "split": (lambda m: m.SplitParams((1, 2, 3), 1), "SplitOp", 1),
    "cast_down": (lambda m: m.CastParams(m.DataType("bfloat16")), "CastOp", 1),
    "cast_up": (lambda m: m.CastParams(m.DataType("float32")), "CastOp", 1),
}


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(SHAPE_CASES))
def test_shape_op_matches_jax(case, dt):
    make, cls, n_in = SHAPE_CASES[case]
    jp, tp = make(jshape), make(tshape)
    jop, top = getattr(jshape, cls), getattr(tshape, cls)
    rs = np.random.RandomState(4)
    ins = [_j(rs.randn(4, 6, 5), dt) for _ in range(n_in)]
    if case == "split":  # several outputs: the gradient of their weighted sum
        ws = [rs.randn(4, sz, 5).astype(np.float32) for sz in (1, 2, 3)]

        def jfn(a):
            return sum((o.astype(jnp.float32) * w).sum()
                       for o, w in zip(jop.lower(jp, [a], {}, JLowerCtx()), ws))

        def tfn(a):
            return sum((o.float() * torch.from_numpy(w)).sum()
                       for o, w in zip(top.lower(tp, [a], {}, LowerCtx()), ws))

        jouts = jop.lower(jp, ins, {}, JLowerCtx())
        touts = top.lower(tp, [_t(np.asarray(a)) for a in ins], {}, LowerCtx())
        assert len(touts) == len(jouts) == 3
        for i, (t, j) in enumerate(zip(touts, jouts)):
            _exact(f"split output {i}", t, j)
    else:
        def jfn(*a):
            return jop.lower(jp, list(a), {}, JLowerCtx())[0]

        def tfn(*a):
            return top.lower(tp, list(a), {}, LowerCtx())[0]

    jout, jgrads, tout, tgrads = _vjp_both(jfn, tfn, ins)
    assert str(tout.dtype)[6:] == str(jout.dtype)
    if case != "split":  # (its outputs are compared above)
        _exact(f"{case} forward", tout, jout)
    for i, (tg, jg) in enumerate(zip(tgrads, jgrads)):
        assert str(tg.dtype)[6:] == str(jg.dtype)
        if case == "split":  # float32 sums of the weighted outputs
            np.testing.assert_allclose(_f32(tg), _f32(jg), atol=1e-5, rtol=0)
        else:
            _exact(f"{case} gradient {i}", tg, jg)
