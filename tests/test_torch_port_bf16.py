"""bfloat16 training through the port against the JAX package on the CPU.

The JAX package keeps a bf16 model bf16 throughout: every parameter
leaf and the output are bf16, with no float32 master weights
(``tests/test_models.py::test_bf16_model_has_no_f32_param_leak``), and
its Pallas flash kernels read bf16, compute in float32 and write bf16.
The port's counterparts are held against it here.

Tolerances, from bf16's unit roundoff u = 2^-8 (8 significant bits,
round to nearest):

* The plain bf16 flash functions against the Pallas kernels in interpret
  mode: the same float32 arithmetic in another summation order, rounded
  once to bf16, so each output is within one bf16 unit in the last
  place (ulp) of JAX's, plus atol 1e-6 for outputs near zero; the
  float32 logsumexp within 1e-5.
* The 2-layer bf16 model (hidden 128, 2 heads, seq 32, batch 4): the two
  frameworks round at other places. JAX on the CPU runs
  ``reference_attention``, which rounds the probabilities to bf16 before
  P V, where the port's flash arithmetic keeps them in float32, and XLA
  may keep a fused chain's intermediates in float32 where PyTorch rounds
  each op. Each such rounding moves a value by at most u relative, and a
  few of them compound through the layers, so the forward output is held
  to 4 u of its largest magnitude (about 1.6%), the losses to rtol u.
  After three SGD steps (lr 0.01) each parameter is within 2 ulp (of the
  larger of the two values: each update is rounded once to bf16, and the
  two sides' float32 results may straddle a rounding boundary) plus 1/8
  of the tensor's largest movement over the three steps (a bias
  gradient sums B * S = 128 bf16 terms of either sign, whose rounding
  error relative to the sum grows like u * sqrt(128), about 4%).
* The optimizers' bf16 updates equal JAX's ``apply`` bit for bit.

The float32 gates of ``test_torch_port_training.py`` stay as they are.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.config import FFConfig as JFFConfig
from flexflow_tpu.core.types import DataType as JDataType
from flexflow_tpu.core.types import LossType as JLossType
from flexflow_tpu.models.transformer import TransformerConfig as JTransformerConfig
from flexflow_tpu.models.transformer import build_transformer as jbuild_transformer
from flexflow_tpu.ops.kernels import flash_attention as jfa
from flexflow_tpu.runtime import optimizers as jopt
from flexflow_tpu.runtime.optimizers import SGDOptimizer as JSGDOptimizer
from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.core.types import DataType, LossType
from flexflow_tpu_torch.models import TransformerConfig, build_transformer
from flexflow_tpu_torch.ops.kernels import flash_attention as tfa
from flexflow_tpu_torch.runtime import SGDOptimizer, params_from_numpy
from flexflow_tpu_torch.runtime import optimizers as topt
from flexflow_tpu_torch.runtime.convert import to_tensor

pytestmark = pytest.mark.torch_port

U = 2.0 ** -8  # bf16 unit roundoff
CFG_KW = dict(num_layers=2, hidden_size=128, num_heads=2, ff_size=256, seq_length=32)
BATCH = 4
LR = 0.01


def _ulp(x: np.ndarray) -> np.ndarray:
    """The spacing of bf16 values at |x| (8 significant bits)."""
    a = np.maximum(np.abs(x.astype(np.float32)), 1e-30)
    return 2.0 ** (np.floor(np.log2(a)) - 7)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _within_ulp(name, got, want, atol=1e-6):
    g, w = _f32(got), _f32(want)
    bad = np.abs(g - w) > _ulp(w) + atol
    assert not bad.any(), f"{name}: {int(bad.sum())} of {bad.size} beyond 1 ulp + {atol}"


def _named(model) -> dict:
    names = {f"{n.op_type.value}_{n.guid}": n.name for n in model.graph.nodes.values()}
    return {names[k]: {w: np.asarray(a) for w, a in ws.items()}
            for k, ws in model.executor.params.items()}


# ------------------------------------------------------------- conversion
def test_params_from_numpy_keeps_bf16_bits():
    rs = np.random.RandomState(0)
    arr = np.asarray(jnp.asarray(rs.randn(3, 5).astype(np.float32) * 1e3, jnp.bfloat16))
    assert arr.dtype.name == "bfloat16"
    t = params_from_numpy({"l": {"w": arr, "f": rs.randn(2).astype(np.float64)}})["l"]
    assert t["w"].dtype == torch.bfloat16 and t["f"].dtype == torch.float32
    assert np.array_equal(t["w"].view(torch.int16).numpy().view(np.uint16), arr.view(np.uint16))
    assert np.array_equal(t["w"].float().numpy(), arr.astype(np.float32))
    back = to_tensor(arr)  # the inputs' path keeps them bf16 too
    assert back.dtype == torch.bfloat16 and torch.equal(back, t["w"])
    assert to_tensor(np.ones(2, np.float32)).dtype == torch.float32


# ----------------------------------------------------------- model dtypes
def _bf16_cfg(**kw):
    return dict(num_layers=2, hidden_size=32, num_heads=2, ff_size=64, seq_length=8, **kw)


def test_bf16_model_has_no_f32_param_leak():
    """The JAX pin's counterpart: every layer of a bf16 transformer is
    bf16, every weight stays bf16 through a train step, and predict
    gives bf16."""
    m = build_transformer(FFConfig(batch_size=4),
                          TransformerConfig(**_bf16_cfg(dtype=DataType.BFLOAT16)), device="cpu")
    for n in m.graph.topo_order():
        d = getattr(n.params, "dtype", None)
        assert d in (None, DataType.BFLOAT16), (n, d)
    m.compile(optimizer=SGDOptimizer(lr=0.01), loss_type=LossType.MEAN_SQUARED_ERROR)
    leaves = [p for g in m.executor.params.values() for p in g.values()]
    assert leaves and all(p.dtype == torch.bfloat16 for p in leaves)
    x = torch.from_numpy(np.random.RandomState(0).randn(4, 8, 32).astype(np.float32)).bfloat16()
    assert m.executor.predict([x])[0].dtype == torch.bfloat16
    m.fit(x, x, verbose=False)
    assert all(p.dtype == torch.bfloat16 for g in m.executor.params.values() for p in g.values())
    w = m.get_weight("l0_ff1", "kernel")
    assert w.dtype == np.float32  # numpy has no bf16: widened exactly
    assert np.array_equal(w, m.executor.params[m.executor.node_key("l0_ff1")]["kernel"]
                          .detach().float().numpy())


# ------------------------------------------------------------ optimizers
@pytest.mark.parametrize("kind", ["sgd", "adam"])
def test_bf16_optimizer_update_is_jaxs_bit_for_bit(kind):
    jo, to = {"sgd": (jopt.SGDOptimizer(lr=0.01, weight_decay=0.001),
                      topt.SGDOptimizer(lr=0.01, weight_decay=0.001)),
              "adam": (jopt.AdamOptimizer(alpha=0.01, weight_decay=0.001),
                       topt.AdamOptimizer(alpha=0.01, weight_decay=0.001))}[kind]
    rs = np.random.RandomState(3)
    p = np.asarray(jnp.asarray(rs.randn(64, 48).astype(np.float32), jnp.bfloat16))
    jp = {"linear_1": {"kernel": jnp.asarray(p)}}
    tp = params_from_numpy({"linear_1": {"kernel": p}})
    js, ts = jo.init_state(jp), to.init_state(tp)
    for _ in range(3):
        g = np.asarray(jnp.asarray(rs.randn(64, 48).astype(np.float32), jnp.bfloat16))
        jp, js = jo.apply(jp, {"linear_1": {"kernel": jnp.asarray(g)}}, js)
        to.apply(tp, params_from_numpy({"linear_1": {"kernel": g}}), ts)
        got, want = tp["linear_1"]["kernel"], np.asarray(jp["linear_1"]["kernel"])
        assert got.dtype == torch.bfloat16
        assert np.array_equal(got.view(torch.int16).numpy().view(np.uint16), want.view(np.uint16))


# ------------------------------------------------------- flash at bf16
def _bf16_qkv(seed, b=2, s=64, h=2, d=64):
    rs = np.random.RandomState(seed)
    return [np.asarray(jnp.asarray(rs.randn(b, s, h, d).astype(np.float32), jnp.bfloat16))
            for _ in range(4)]


@pytest.mark.parametrize("causal", [False, True])
def test_plain_bf16_flash_functions_match_jax_kernels(causal):
    """reference_flash_forward / _backward on bf16 inputs against the
    Pallas forward, dQ and dK/dV kernels in interpret mode at bf16."""
    q, k, v, do = _bf16_qkv(5 + causal)
    scale = 64 ** -0.5
    tq, tk, tv, tdo = (params_from_numpy({"x": {"a": a}})["x"]["a"] for a in (q, k, v, do))
    o, lse = tfa.reference_flash_forward(tq, tk, tv, causal, scale)
    sw = lambda a: jnp.swapaxes(jnp.asarray(a), 1, 2)  # noqa: E731  [B,S,H,D] <-> [B,H,S,D]
    jo, jlse = jfa._flash_fwd(sw(q), sw(k), sw(v), scale, causal, 64, 64, True)
    assert o.dtype == torch.bfloat16 and jo.dtype == jnp.bfloat16
    _within_ulp("o", o, sw(jo))
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[..., 0].transpose(0, 2, 1),
                               atol=1e-5, rtol=1e-5)
    # the backward kernels from JAX's own residuals, so both sides see the
    # same o, lse and delta
    jdq, jdk, jdv = jfa._flash_bwd((sw(q), sw(k), sw(v), jo, jlse), sw(do), scale, causal,
                                   64, 64, True)
    to_ = params_from_numpy({"x": {"a": np.asarray(sw(jo))}})["x"]["a"]
    tlse = torch.from_numpy(np.asarray(jlse)[..., 0].transpose(0, 2, 1).copy())
    delta = tfa.flash_delta(tdo, to_)
    dq = tfa.reference_flash_backward_dq(tq, tk, tv, tdo, tlse, delta, causal, scale)
    dk, dv = tfa.reference_flash_backward_dkv(tq, tk, tv, tdo, tlse, delta, causal, scale)
    for name, got, want in (("dq", dq, jdq), ("dk", dk, jdk), ("dv", dv, jdv)):
        assert got.dtype == torch.bfloat16
        _within_ulp(name, got, sw(want))
    # and the autograd path gives the same gradients as the plain functions
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    tfa.flash_attention(*leaves, causal=causal, scale=scale).backward(tdo)
    pdq, pdk, pdv = tfa.reference_flash_backward(tq, tk, tv, tdo, lse, tfa.flash_delta(tdo, o),
                                                 causal, scale)
    for got, want in zip((t.grad for t in leaves), (pdq, pdk, pdv)):
        assert torch.equal(got, want)


# ---------------------------------------------------- the bf16 model vs JAX
@pytest.fixture(scope="module", params=[False, True], ids=["bidirectional", "causal"])
def pair(request):
    """(JAX model, port model), bf16, compiled for SGD + MSE from the JAX
    model's bf16 weights (carried over bit for bit)."""
    kw = dict(CFG_KW, causal=request.param)
    jm = jbuild_transformer(JFFConfig(batch_size=BATCH, workers_per_node=1),
                            JTransformerConfig(**kw, dtype=JDataType.BFLOAT16))
    jm.compile(optimizer=JSGDOptimizer(lr=LR), loss_type=JLossType.MEAN_SQUARED_ERROR)
    tm = build_transformer(FFConfig(batch_size=BATCH),
                           TransformerConfig(**kw, dtype=DataType.BFLOAT16), device="cpu")
    tm.compile(optimizer=SGDOptimizer(lr=LR), loss_type=LossType.MEAN_SQUARED_ERROR)
    tm.set_weights(params_from_numpy(_named(jm)))
    return jm, tm


def _data(seed, steps):
    rs = np.random.RandomState(seed)
    shape = (steps * BATCH, CFG_KW["seq_length"], CFG_KW["hidden_size"])
    return rs.randn(*shape).astype(np.float32), rs.randn(*shape).astype(np.float32)


@pytest.mark.parametrize("inputs", ["float32", "bfloat16"])
def test_bf16_model_forward_matches_jax(pair, inputs):
    """A bf16 model on float32 inputs promotes as JAX's does (the residual
    stream stays float32, the layers' outputs are bf16); on bf16 inputs
    it is bf16 throughout."""
    jm, tm = pair
    x, _ = _data(1, 1)
    if inputs == "bfloat16":
        x = np.asarray(jnp.asarray(x, jnp.bfloat16))
    want = jm.predict(jnp.asarray(x))
    got = tm.predict(x)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    g, w = _f32(got), _f32(want)
    assert g.shape == w.shape == x.shape
    np.testing.assert_allclose(g, w, atol=4 * U * np.abs(w).max(), rtol=0)


def test_bf16_three_sgd_steps_match_jax(pair):
    jm, tm = pair
    p0 = {layer: {n: a.astype(np.float32) for n, a in ws.items()}
          for layer, ws in _named(jm).items()}
    x, y = _data(2, 3)
    for step in range(3):
        sl = slice(step * BATCH, (step + 1) * BATCH)
        xb, yb = (np.asarray(jnp.asarray(a[sl], jnp.bfloat16)) for a in (x, y))
        jl = jm.executor.train_batch([jnp.asarray(xb)], jnp.asarray(yb), jax.random.key(step))
        tl = tm.executor.train_batch([xb], yb)
        np.testing.assert_allclose(float(tl["loss"]), float(jl["loss"]), rtol=U)
    for layer, ws in _named(jm).items():
        for name, arr in ws.items():
            got, want = tm.get_weight(layer, name), arr.astype(np.float32)
            assert tm.executor.params[tm.executor.node_key(layer)][name].dtype == torch.bfloat16
            moved = np.abs(want - p0[layer][name]).max()
            tol = 2 * _ulp(np.maximum(np.abs(got), np.abs(want))) + moved / 8
            bad = np.abs(got - want) > tol
            assert not bad.any(), f"{layer}.{name}: {int(bad.sum())} beyond the bf16 gate"
