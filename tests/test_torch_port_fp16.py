"""float16 training through the port against the JAX package on the CPU.

``DataType.HALF`` keeps a model fp16 throughout in the JAX package, as
``DataType.BFLOAT16`` keeps it bf16: every parameter leaf and the output
are fp16, with no float32 master weights and no loss scaling, and its
Pallas flash kernels read fp16, compute in float32 and write fp16. The
port adds neither master weights nor loss scaling; its counterparts are
held against the JAX package here.

Tolerances, from fp16's unit roundoff u = 2^-11 (11 significant bits,
round to nearest):

* The plain fp16 flash functions against the Pallas kernels in
  interpret mode: the same float32 arithmetic in another summation
  order, rounded once to fp16, so each output is within one fp16 unit in
  the last place (ulp) of JAX's, plus atol 1e-6 for outputs near zero;
  the float32 logsumexp within 1e-5.
* The 2-layer fp16 model (hidden 128, 2 heads, seq 32, batch 4, the bf16
  file's cell): the dense layers and their GELU round where JAX's do
  (``jax.nn.gelu``'s own fp16 ops), bit for bit, but JAX on the CPU runs
  ``reference_attention``, which rounds the probabilities to fp16 before
  P V, where the port's flash arithmetic (the TPU kernel's) keeps them in
  float32. That moves an attention output by up to u relative, and a
  value whose two float32 results straddle an fp16 rounding boundary
  then rounds one ulp apart (2 u relative), also at the output's largest
  magnitude: half an fp16 ulp of the output's magnitude does not hold
  here (measured: one ulp, 0.0039 at a largest |output| of 4.3). The
  forward output is held to 4 u of its largest magnitude (the bf16
  file's rule, with fp16's u), the losses to rtol 1e-4 (measured within
  1.2e-5). After three SGD steps (lr 0.01) each parameter is within 2
  ulp (of the larger of the two values: each update is rounded once to
  fp16, and the two sides' float32 results may straddle a rounding
  boundary; ulps no finer than at fp16's smallest normal, 2^-14, below
  which fp16 is spaced 2^-24) plus 1/8 of the tensor's largest movement
  over the three steps (a bias gradient sums B * S = 128 fp16 terms of
  either sign, rounded in other places on the two sides).
* The optimizers' fp16 updates equal JAX's ``apply`` bit for bit, and
  fp16 arrays come across the converter bit for bit.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_port_fp16.py
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.config import FFConfig as JFFConfig
from flexflow_tpu.core.types import ActiMode as JActiMode
from flexflow_tpu.core.types import DataType as JDataType
from flexflow_tpu.core.types import LossType as JLossType
from flexflow_tpu.models.transformer import TransformerConfig as JTransformerConfig
from flexflow_tpu.models.transformer import build_transformer as jbuild_transformer
from flexflow_tpu.ops.elementwise import apply_activation as japply_activation
from flexflow_tpu.ops.kernels import flash_attention as jfa
from flexflow_tpu.runtime import optimizers as jopt
from flexflow_tpu.runtime.optimizers import SGDOptimizer as JSGDOptimizer
from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.core.types import ActiMode, DataType, LossType
from flexflow_tpu_torch.models import TransformerConfig, build_transformer
from flexflow_tpu_torch.ops.elementwise import apply_activation
from flexflow_tpu_torch.ops.kernels import flash_attention as tfa
from flexflow_tpu_torch.runtime import SGDOptimizer, params_from_numpy
from flexflow_tpu_torch.runtime import optimizers as topt
from flexflow_tpu_torch.runtime.convert import to_tensor

pytestmark = pytest.mark.torch_port

U = 2.0 ** -11  # fp16 unit roundoff
CFG_KW = dict(num_layers=2, hidden_size=128, num_heads=2, ff_size=256, seq_length=32)
BATCH = 4
LR = 0.01
LOSS_RTOL = 1e-4


def _ulp(x: np.ndarray) -> np.ndarray:
    """The spacing of fp16 values at |x| (11 significant bits; 2^-24
    below the smallest normal, 2^-14)."""
    a = np.maximum(np.abs(x.astype(np.float32)), 2.0 ** -14)
    return 2.0 ** (np.floor(np.log2(a)) - 10)


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
def test_params_from_numpy_keeps_fp16_bits():
    rs = np.random.RandomState(0)
    arr = (rs.randn(3, 5) * 1e3).astype(np.float16)
    t = params_from_numpy({"l": {"w": arr, "f": rs.randn(2).astype(np.float64)}})["l"]
    assert t["w"].dtype == torch.float16 and t["f"].dtype == torch.float32
    assert np.array_equal(t["w"].numpy().view(np.uint16), arr.view(np.uint16))
    back = to_tensor(arr)  # the inputs' path keeps them fp16 too
    assert back.dtype == torch.float16 and torch.equal(back, t["w"])


# ----------------------------------------------------------- model dtypes
def test_fp16_model_has_no_f32_param_leak():
    """Every layer of an fp16 transformer is fp16, every weight stays
    fp16 through a train step (no master weights), predict gives fp16,
    and get_weight returns the fp16 values."""
    cfg = TransformerConfig(num_layers=2, hidden_size=32, num_heads=2, ff_size=64, seq_length=8,
                            dtype=DataType.HALF)
    m = build_transformer(FFConfig(batch_size=4), cfg, device="cpu")
    for n in m.graph.topo_order():
        d = getattr(n.params, "dtype", None)
        assert d in (None, DataType.HALF), (n, d)
    m.compile(optimizer=SGDOptimizer(lr=0.01), loss_type=LossType.MEAN_SQUARED_ERROR)
    leaves = [p for g in m.executor.params.values() for p in g.values()]
    assert leaves and all(p.dtype == torch.float16 for p in leaves)
    x = np.random.RandomState(0).randn(4, 8, 32).astype(np.float16)
    assert m.executor.predict([x])[0].dtype == torch.float16
    m.fit(x, x, verbose=False)
    assert all(p.dtype == torch.float16 for g in m.executor.params.values() for p in g.values())
    w = m.get_weight("l0_ff1", "kernel")
    assert w.dtype == np.float16
    assert np.array_equal(w, m.executor.params[m.executor.node_key("l0_ff1")]["kernel"]
                          .detach().numpy())


def test_fp16_gelu_rounds_as_jax_does():
    """jax.nn.gelu(approximate=False) on fp16 rounds each of its ops to
    fp16; the port's fp16 GELU runs the same ops: equal bit for bit."""
    x = (np.random.RandomState(7).randn(64, 96) * 3).astype(np.float16)
    want = np.asarray(jax.jit(lambda a: japply_activation(JActiMode.GELU, a))(jnp.asarray(x)))
    got = apply_activation(ActiMode.GELU, torch.from_numpy(x)).numpy()
    assert got.dtype == want.dtype == np.float16
    assert np.array_equal(got.view(np.uint16), want.view(np.uint16))


# ------------------------------------------------------------ optimizers
@pytest.mark.parametrize("kind", ["sgd", "adam"])
def test_fp16_optimizer_update_is_jaxs_bit_for_bit(kind):
    jo, to = {"sgd": (jopt.SGDOptimizer(lr=0.01, weight_decay=0.001),
                      topt.SGDOptimizer(lr=0.01, weight_decay=0.001)),
              "adam": (jopt.AdamOptimizer(alpha=0.01, weight_decay=0.001),
                       topt.AdamOptimizer(alpha=0.01, weight_decay=0.001))}[kind]
    rs = np.random.RandomState(3)
    p = rs.randn(64, 48).astype(np.float16)
    jp = {"linear_1": {"kernel": jnp.asarray(p)}}
    tp = params_from_numpy({"linear_1": {"kernel": p}})
    js, ts = jo.init_state(jp), to.init_state(tp)
    for _ in range(3):
        g = rs.randn(64, 48).astype(np.float16)
        jp, js = jo.apply(jp, {"linear_1": {"kernel": jnp.asarray(g)}}, js)
        to.apply(tp, params_from_numpy({"linear_1": {"kernel": g}}), ts)
        got, want = tp["linear_1"]["kernel"], np.asarray(jp["linear_1"]["kernel"])
        assert got.dtype == torch.float16
        assert np.array_equal(got.numpy().view(np.uint16), want.view(np.uint16))


# ------------------------------------------------------- flash at fp16
@pytest.mark.parametrize("causal", [False, True])
def test_plain_fp16_flash_functions_match_jax_kernels(causal):
    """reference_flash_forward / _backward on fp16 inputs against the
    Pallas forward, dQ and dK/dV kernels in interpret mode at fp16."""
    rs = np.random.RandomState(5 + causal)
    q, k, v, do = (rs.randn(2, 64, 2, 64).astype(np.float16) for _ in range(4))
    scale = 64 ** -0.5
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = tfa.reference_flash_forward(tq, tk, tv, causal, scale)
    sw = lambda a: jnp.swapaxes(jnp.asarray(a), 1, 2)  # noqa: E731  [B,S,H,D] <-> [B,H,S,D]
    jo, jlse = jfa._flash_fwd(sw(q), sw(k), sw(v), scale, causal, 64, 64, True)
    assert o.dtype == torch.float16 and jo.dtype == jnp.float16
    _within_ulp("o", o, sw(jo))
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[..., 0].transpose(0, 2, 1),
                               atol=1e-5, rtol=1e-5)
    # the backward kernels from JAX's own residuals, so both sides see the
    # same o, lse and delta
    jdq, jdk, jdv = jfa._flash_bwd((sw(q), sw(k), sw(v), jo, jlse), sw(do), scale, causal,
                                   64, 64, True)
    to_ = torch.from_numpy(np.array(sw(jo)))
    tlse = torch.from_numpy(np.asarray(jlse)[..., 0].transpose(0, 2, 1).copy())
    delta = tfa.flash_delta(tdo, to_)
    dq = tfa.reference_flash_backward_dq(tq, tk, tv, tdo, tlse, delta, causal, scale)
    dk, dv = tfa.reference_flash_backward_dkv(tq, tk, tv, tdo, tlse, delta, causal, scale)
    for name, got, want in (("dq", dq, jdq), ("dk", dk, jdk), ("dv", dv, jdv)):
        assert got.dtype == torch.float16
        _within_ulp(name, got, sw(want))
    # and the autograd path gives the same gradients as the plain functions
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    tfa.flash_attention(*leaves, causal=causal, scale=scale).backward(tdo)
    pdq, pdk, pdv = tfa.reference_flash_backward(tq, tk, tv, tdo, lse, tfa.flash_delta(tdo, o),
                                                 causal, scale)
    for got, want in zip((t.grad for t in leaves), (pdq, pdk, pdv)):
        assert torch.equal(got, want)


# ---------------------------------------------------- the fp16 model vs JAX
@pytest.fixture(scope="module", params=[False, True], ids=["bidirectional", "causal"])
def pair(request):
    """(JAX model, port model), fp16, compiled for SGD + MSE from the JAX
    model's fp16 weights (carried over bit for bit)."""
    kw = dict(CFG_KW, causal=request.param)
    jm = jbuild_transformer(JFFConfig(batch_size=BATCH, workers_per_node=1),
                            JTransformerConfig(**kw, dtype=JDataType.HALF))
    jm.compile(optimizer=JSGDOptimizer(lr=LR), loss_type=JLossType.MEAN_SQUARED_ERROR)
    tm = build_transformer(FFConfig(batch_size=BATCH),
                           TransformerConfig(**kw, dtype=DataType.HALF), device="cpu")
    tm.compile(optimizer=SGDOptimizer(lr=LR), loss_type=LossType.MEAN_SQUARED_ERROR)
    tm.set_weights(params_from_numpy(_named(jm)))
    return jm, tm


def _data(seed, steps):
    rs = np.random.RandomState(seed)
    shape = (steps * BATCH, CFG_KW["seq_length"], CFG_KW["hidden_size"])
    return rs.randn(*shape).astype(np.float16), rs.randn(*shape).astype(np.float16)


def test_fp16_model_forward_matches_jax(pair):
    jm, tm = pair
    x, _ = _data(1, 1)
    want = jm.predict(jnp.asarray(x))
    got = tm.predict(x)
    assert got.dtype == torch.float16 and want.dtype == jnp.float16
    g, w = _f32(got), _f32(want)
    assert g.shape == w.shape == x.shape
    np.testing.assert_allclose(g, w, atol=4 * U * np.abs(w).max(), rtol=0)


def test_fp16_three_sgd_steps_match_jax(pair):
    jm, tm = pair
    p0 = {layer: {n: a.astype(np.float32) for n, a in ws.items()}
          for layer, ws in _named(jm).items()}
    x, y = _data(2, 3)
    for step in range(3):
        sl = slice(step * BATCH, (step + 1) * BATCH)
        jl = jm.executor.train_batch([jnp.asarray(x[sl])], jnp.asarray(y[sl]),
                                     jax.random.key(step))
        tl = tm.executor.train_batch([x[sl]], y[sl])
        np.testing.assert_allclose(float(tl["loss"]), float(jl["loss"]), rtol=LOSS_RTOL)
    for layer, ws in _named(jm).items():
        for name, arr in ws.items():
            got, want = tm.get_weight(layer, name).astype(np.float32), arr.astype(np.float32)
            assert tm.executor.params[tm.executor.node_key(layer)][name].dtype == torch.float16
            moved = np.abs(want - p0[layer][name]).max()
            tol = 2 * _ulp(np.maximum(np.abs(got), np.abs(want))) + moved / 8
            bad = np.abs(got - want) > tol
            assert not bad.any(), f"{layer}.{name}: {int(bad.sum())} beyond the fp16 gate"
