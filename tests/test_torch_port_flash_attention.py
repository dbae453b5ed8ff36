"""The port's flash attention against the JAX package on the CPU.

On CPU tensors the port runs the plain versions of its three CUDA
kernels: the tiled online-softmax forward and the P/dP/dS backward. They
are held against JAX's Pallas ``flash_attention`` in interpret mode (the
JAX package's own CPU path) and ``reference_attention``, at the JAX
tests' tolerances: outputs atol/rtol 2e-5, gradients 5e-5
(``tests/test_attention_kernels.py``). The CUDA kernels themselves are
held against the plain versions on the card (``chip_smoke.py`` and
``tests/test_torch_port_cuda.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.ops.attention import reference_attention as jreference_attention
from flexflow_tpu.ops.kernels import flash_attention as jfa
from flexflow_tpu_torch.ops.attention import attention_core
from flexflow_tpu_torch.ops.kernels import flash_attention as tfa

pytestmark = pytest.mark.torch_port


def _qkv(b=2, sq=64, h=2, d=64, sk=None, seed=0):
    rs = np.random.RandomState(seed)
    sk = sq if sk is None else sk
    return (rs.randn(b, sq, h, d).astype(np.float32),
            rs.randn(b, sk, h, d).astype(np.float32),
            rs.randn(b, sk, h, d).astype(np.float32))


def _t(*arrays, grad=False):
    return [torch.from_numpy(a.copy()).requires_grad_(grad) for a in arrays]


@pytest.mark.parametrize("causal", [False, True])
def test_plain_forward_matches_jax_flash_and_reference(causal):
    q, k, v = _qkv(sq=128)
    got = tfa.flash_attention(*_t(q, k, v), causal=causal).numpy()
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    for want in (jfa.flash_attention(jq, jk, jv, causal=causal, interpret=True),
                 jreference_attention(jq, jk, jv, causal=causal)):
        np.testing.assert_allclose(got, np.asarray(want), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_logsumexp_matches_jax_kernel(causal):
    q, k, v = _qkv(sq=128, d=64)
    scale = 64 ** -0.5
    _, lse = tfa.reference_flash_forward(*_t(q, k, v), causal, scale)
    sw = lambda a: jnp.swapaxes(jnp.asarray(a), 1, 2)  # noqa: E731  [B,S,H,D] -> [B,H,S,D]
    _, jlse = jfa._flash_fwd(sw(q), sw(k), sw(v), scale, causal, 64, 64, True)
    want = np.asarray(jlse)[..., 0].transpose(0, 2, 1)  # [B,H,S,1] -> [B,S,H]
    np.testing.assert_allclose(lse.numpy(), want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_gradients_through_autograd_function_match_jax(causal):
    q, k, v = _qkv(b=1, sq=128, h=2)
    jloss = lambda fn: lambda q, k, v: jnp.sum(jnp.sin(fn(q, k, v, causal=causal)))  # noqa: E731
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want_flash = jax.grad(jloss(jfa.flash_attention), argnums=(0, 1, 2))(jq, jk, jv)
    want_ref = jax.grad(jloss(jreference_attention), argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv = _t(q, k, v, grad=True)
    torch.sin(tfa.flash_attention(tq, tk, tv, causal=causal)).sum().backward()
    for got, a, b in zip((tq.grad, tk.grad, tv.grad), want_flash, want_ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(a), atol=5e-5, rtol=5e-5)
        np.testing.assert_allclose(got.numpy(), np.asarray(b), atol=5e-5, rtol=5e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_backward_matches_jax_backward_kernels(causal):
    """dQ, dK, dV of the plain backward against the JAX backward
    kernels (interpret mode) on the same residuals and output gradient."""
    q, k, v = _qkv(b=1, sq=64, h=2, seed=3)
    do = np.random.RandomState(4).randn(*q.shape).astype(np.float32)
    scale = 64 ** -0.5
    tq, tk, tv, tdo = _t(q, k, v, do)
    o, lse = tfa.reference_flash_forward(tq, tk, tv, causal, scale)
    got = tfa.reference_flash_backward(tq, tk, tv, tdo, lse, tfa.flash_delta(tdo, o), causal, scale)
    sw = lambda a: jnp.swapaxes(jnp.asarray(np.asarray(a)), 1, 2)  # noqa: E731
    jo, jlse = jfa._flash_fwd(sw(q), sw(k), sw(v), scale, causal, 32, 32, True)
    want = jfa._flash_bwd((sw(q), sw(k), sw(v), jo, jlse), sw(do), scale, causal, 32, 32, True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.swapaxes(np.asarray(w), 1, 2), atol=5e-5, rtol=5e-5)


@pytest.mark.parametrize("sq,sk,d,causal", [(100, 100, 32, False), (100, 100, 48, True),
                                            (40, 70, 64, False)])
def test_ragged_and_rectangular_shapes(sq, sk, d, causal):
    """Sequence lengths no block divides (the TPU kernel refuses them;
    the port's kernels mask the tail) and Sq != Sk without a mask."""
    q, k, v = _qkv(b=2, sq=sq, h=3, d=d, sk=sk, seed=5)
    tq, tk, tv = _t(q, k, v, grad=True)
    out = tfa.flash_attention(tq, tk, tv, causal=causal)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(jreference_attention(jq, jk, jv, causal=causal)),
                               atol=2e-5, rtol=2e-5)
    torch.sin(out).sum().backward()
    want = jax.grad(lambda q, k, v: jnp.sum(jnp.sin(jreference_attention(q, k, v, causal=causal))),
                    argnums=(0, 1, 2))(jq, jk, jv)
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=5e-5, rtol=5e-5)


def test_causal_needs_square_scores_and_backends_are_checked():
    q, k, v = _t(*_qkv(sq=16, sk=24))
    for fn in (tfa.flash_attention, attention_core):
        with pytest.raises(ValueError, match="Sq == Sk"):
            fn(q, k, v, causal=True)
    with pytest.raises(ValueError, match="Sq == Sk"):
        tfa.reference_flash_forward(q, k, v, True, 0.125)
    tfa.flash_attention(q, k, v, causal=False)  # rectangular without a mask is fine
    with pytest.raises(ValueError, match="backend"):
        attention_core(q, k, v, backend="tpu")
    with pytest.raises(ValueError):
        tfa.flash_attention(q, k[:, :, :1], v, causal=False)  # head mismatch


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    q, k, v = _t(*_qkv(sq=32), grad=True)
    tfa.reset_launch_counts()
    out = attention_core(q, k, v)
    out.sum().backward()
    plain = attention_core(q.detach(), k.detach(), v.detach(), backend="plain")
    assert torch.equal(out.detach(), plain)
    assert set(tfa.LAUNCHES) == {f"{k}{form}" for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
                                 for form in ("", "_bf16", "_f16")}
    assert not any(tfa.LAUNCHES.values())


def test_kernel_input_checks():
    """What the CUDA wrappers refuse before a pointer is passed (checked
    on CPU tensors; the launch itself needs the card)."""
    q, k, v = _t(*_qkv(sq=16))
    tfa._check_kernel_inputs(False, q, k, v)
    with pytest.raises(TypeError):
        tfa._check_kernel_inputs(False, q.double(), k, v)
    with pytest.raises(ValueError, match="contiguous"):
        tfa._check_kernel_inputs(False, q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    assert tfa._check_kernel_inputs(False, q.bfloat16(), k.bfloat16(), v.bfloat16()) == (
        "bf16", "_bf16")
    assert tfa._check_kernel_inputs(False, q.half(), k.half(), v.half()) == ("f16", "_f16")
    with pytest.raises(TypeError):  # fp16 and bf16 do not mix
        tfa._check_kernel_inputs(False, q.half(), k.bfloat16(), v.half())
    with pytest.raises(TypeError):  # one dtype for q, k and v
        tfa._check_kernel_inputs(False, q.bfloat16(), k, v)
    with pytest.raises(TypeError):  # lse and delta stay float32
        tfa._check_kernel_inputs(False, *(t.bfloat16() for t in (q, k, v, q, q[..., 0], q[..., 0])))
    with pytest.raises(ValueError, match="one head dim"):  # flash_attention pads Dv != Dk
        tfa._check_kernel_inputs(False, q, k, v[..., :8].contiguous())
    tfa._check_kernel_inputs(False, *(torch.zeros(1, 4, 1, 512),) * 3)
    wide = torch.zeros(1, 4, 1, 600)
    with pytest.raises(ValueError, match="head_dim"):
        tfa._check_kernel_inputs(False, wide, wide, wide)
    with pytest.raises(ValueError, match="Sq == Sk"):
        tfa._check_kernel_inputs(True, q, k[:, :8].contiguous(), v[:, :8].contiguous())
