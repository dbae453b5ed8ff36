"""The 3xTF32 split of the flash kernels' tensor-core products, emulated
in numpy on the CPU (no GPU needed).

The forward, dQ and dK/dV kernels of
``flexflow_tpu_torch/ops/kernels/csrc/flash_attention.cu`` take every
fp32 product on the tensor cores as three TF32 products: each operand x
is split into big = rna(x) and small = rna(x - big), and a b is
accumulated in fp32 as big_a small_b + small_a big_b + big_a big_b, one
8-wide reduction step at a time. Here ``tf32_rna`` rounds as
``cvt.rna.tf32.f32`` does, and the kernels' arithmetic runs at the
training tile shape (S=128, D=64) on seeded inputs: three products keep
O, lse, dQ, dK and dV within the card's kernel-vs-plain gate (atol 1e-4
+ rtol 1e-4) of the plain fp32 versions; one product does not, which is
why the kernels spend three.

    python -m pytest tests/test_torch_port_tf32_split.py
"""
import numpy as np
import pytest
import torch

from flexflow_tpu_torch.ops.kernels import flash_attention as tfa

pytestmark = pytest.mark.torch_port

ATOL = RTOL = 1e-4  # chip_smoke.py's gate, kernel vs plain version
# keys per staged tile, as flash_attention.cu's constants of the same names
kFwdKeyTile = 32  # the forward kernel's online-softmax step
kDqKeyTile = 32  # the dQ kernel's accumulation step


def tf32_rna(x: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32 on float32 values: keep 10 mantissa bits, rounded
    to nearest with ties away from zero (add half a unit, drop 13 bits)."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x: np.ndarray):
    big = tf32_rna(x)
    return big, tf32_rna(x - big)


def mma(a, b, acc=None, products=3):
    """acc + a @ b as the kernels' mma chain computes it: over the
    reduction axis in steps of 8, each TF32 product exact (float64) and
    added to the fp32 accumulator; ``products`` 3 is the 3xTF32 split
    (big small + small big + big big, in that order), 1 is big big."""
    out = np.zeros(a.shape[:-1] + b.shape[-1:], np.float32) if acc is None else acc
    ab, asm = split(a)
    bb, bsm = split(b)
    terms = [(ab, bsm), (asm, bb), (ab, bb)] if products == 3 else [(ab, bb)]
    for k0 in range(0, a.shape[-1], 8):
        for x, y in terms:
            step = x[..., k0:k0 + 8].astype(np.float64) @ y[..., k0:k0 + 8, :].astype(np.float64)
            out = (out.astype(np.float64) + step).astype(np.float32)
    return out


def _inputs(causal: bool, b=2, s=128, h=4, d=64, seed=0):
    rs = np.random.RandomState(seed + int(causal))
    q, k, v, do = (rs.randn(b, s, h, d).astype(np.float32) for _ in range(4))
    scale = d ** -0.5
    t = [torch.from_numpy(x) for x in (q, k, v, do)]
    o, lse = tfa.reference_flash_forward(t[0], t[1], t[2], causal, scale)
    delta = tfa.flash_delta(t[3], o)
    return (q, k, v, do), scale, (o.numpy(), lse.numpy(), delta.numpy())


def _heads(x):
    return np.ascontiguousarray(x.transpose(0, 2, 1, 3))  # [B,S,H,D] -> [B,H,S,D]


def emulated_forward(q, k, v, causal, scale, products):
    """The forward kernel's arithmetic: (scale Q) K^T and P V through
    ``mma``, the online softmax over key tiles in fp32."""
    qs, kh, vh = _heads(q * np.float32(scale)), _heads(k), _heads(v)
    b, h, s, d = qs.shape
    m = np.full((b, h, s, 1), -1e30, np.float32)
    l = np.zeros((b, h, s, 1), np.float32)
    acc = np.zeros((b, h, s, d), np.float32)
    rows = np.arange(s)[:, None]
    for k0 in range(0, kh.shape[2], kFwdKeyTile):
        kt, vt = kh[:, :, k0:k0 + kFwdKeyTile], vh[:, :, k0:k0 + kFwdKeyTile]
        sc = mma(qs, kt.transpose(0, 1, 3, 2).copy(), products=products)
        valid = np.broadcast_to(rows >= k0 + np.arange(kt.shape[2])[None, :] if causal else True,
                                sc.shape)
        m_new = np.maximum(m, np.where(valid, sc, np.float32(-1e30)).max(-1, keepdims=True))
        p = np.where(valid, np.exp(sc - m_new), np.float32(0)).astype(np.float32)
        corr = np.exp(m - m_new).astype(np.float32)
        l = l * corr + p.sum(-1, keepdims=True, dtype=np.float32)
        acc = mma(p, vt, acc * corr, products=products)
        m = m_new
    o = acc / np.maximum(l, np.float32(1e-30))
    lse = (m + np.log(np.maximum(l, np.float32(1e-30))))[..., 0]
    return o.transpose(0, 2, 1, 3), lse.transpose(0, 2, 1)


def emulated_dkv(q, k, v, do, lse, delta, causal, scale, products):
    """The dK/dV kernel's arithmetic, KV-stationary and transposed: S^T =
    K Q^T, dP^T = V dO^T, dV = P^T dO and dK = scale dS^T Q through ``mma``."""
    qh, kh, vh, doh = _heads(q), _heads(k), _heads(v), _heads(do)
    lse_c = lse.transpose(0, 2, 1)[:, :, None, :]  # [B,H,1,Sq]: one per query column
    delta_c = delta.transpose(0, 2, 1)[:, :, None, :]
    st = mma(kh, qh.transpose(0, 1, 3, 2).copy(), products=products) * np.float32(scale)
    p = np.exp(st - lse_c).astype(np.float32)
    if causal:
        keys, queries = np.arange(kh.shape[2])[:, None], np.arange(qh.shape[2])[None, :]
        p = np.where(queries >= keys, p, np.float32(0))
    dpt = mma(vh, doh.transpose(0, 1, 3, 2).copy(), products=products)
    dst = (p * (dpt - delta_c)).astype(np.float32)
    dv = mma(p, doh, products=products)
    dk = mma(dst, qh, products=products) * np.float32(scale)
    return dk.transpose(0, 2, 1, 3), dv.transpose(0, 2, 1, 3)


def emulated_dq(q, k, v, do, lse, delta, causal, scale, products):
    """The dQ kernel's arithmetic, Q-stationary: per key tile of the
    kernel's width, S = (scale Q) K^T and dP = dO V^T through ``mma``,
    dS = P (dP - delta) with P = exp(S - lse), and dQ += dS K into one
    fp32 accumulator; scaled once at the end."""
    qs, kh, vh, doh = _heads(q * np.float32(scale)), _heads(k), _heads(v), _heads(do)
    lse_r = lse.transpose(0, 2, 1)[..., None]  # [B,H,Sq,1]: one per query row
    delta_r = delta.transpose(0, 2, 1)[..., None]
    rows = np.arange(qs.shape[2])[:, None]
    acc = np.zeros(qs.shape, np.float32)
    for k0 in range(0, kh.shape[2], kDqKeyTile):
        kt, vt = kh[:, :, k0:k0 + kDqKeyTile], vh[:, :, k0:k0 + kDqKeyTile]
        s = mma(qs, kt.transpose(0, 1, 3, 2).copy(), products=products)
        dp = mma(doh, vt.transpose(0, 1, 3, 2).copy(), products=products)
        p = np.exp(s - lse_r).astype(np.float32)
        if causal:
            p = np.where(rows >= k0 + np.arange(kt.shape[2])[None, :], p, np.float32(0))
        acc = mma((p * (dp - delta_r)).astype(np.float32), kt, acc, products=products)
    return (acc * np.float32(scale)).transpose(0, 2, 1, 3)


def _outside(got, want):
    """Elements outside atol + rtol * |want|, as a fraction."""
    return float(np.mean(np.abs(got - want) > ATOL + RTOL * np.abs(want)))


def test_tf32_rounding_is_cvt_rna_and_the_split_keeps_fp32():
    one_ulp = np.float32(2.0 ** -10)  # a TF32 unit at 1.0
    x = np.array([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 2.0 ** -12, 1 + 3 * 2.0 ** -12],
                 np.float32)
    np.testing.assert_array_equal(tf32_rna(x), [1 + one_ulp, -(1 + one_ulp), 1, 1 + one_ulp])
    rs = np.random.RandomState(7)
    x = (rs.randn(4096) * np.exp(rs.uniform(-20, 20, 4096))).astype(np.float32)
    big, small = split(x)
    assert not (big.view(np.uint32) & 0x1FFF).any() and not (small.view(np.uint32) & 0x1FFF).any()
    rest = np.abs(x.astype(np.float64) - big.astype(np.float64) - small.astype(np.float64))
    assert (rest <= 2.0 ** -22 * np.abs(x.astype(np.float64))).all()
    assert (np.abs(x - big) > 2.0 ** -14 * np.abs(x)).mean() > 0.5  # one product alone loses bits


@pytest.mark.parametrize("causal", [False, True])
def test_three_tf32_products_keep_the_forward_in_the_gate(causal):
    (q, k, v, _), scale, (o, lse, _) = _inputs(causal)
    got_o, got_lse = emulated_forward(q, k, v, causal, scale, products=3)
    np.testing.assert_allclose(got_o, o, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got_lse, lse, atol=ATOL, rtol=RTOL)
    assert np.abs(got_o - o).max() < 1e-5  # fp32-level, far inside the gate


@pytest.mark.parametrize("causal", [False, True])
def test_three_tf32_products_keep_dk_and_dv_in_the_gate(causal):
    (q, k, v, do), scale, (_, lse, delta) = _inputs(causal)
    dk, dv = emulated_dkv(q, k, v, do, lse, delta, causal, scale, products=3)
    t = [torch.from_numpy(x) for x in (q, k, v, do, lse, delta)]
    want_dk, want_dv = tfa.reference_flash_backward_dkv(*t, causal, scale)
    np.testing.assert_allclose(dk, want_dk.numpy(), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(dv, want_dv.numpy(), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("causal", [False, True])
def test_three_tf32_products_keep_dq_in_the_gate(causal):
    (q, k, v, do), scale, (_, lse, delta) = _inputs(causal)
    dq = emulated_dq(q, k, v, do, lse, delta, causal, scale, products=3)
    t = [torch.from_numpy(x) for x in (q, k, v, do, lse, delta)]
    want = tfa.reference_flash_backward_dq(*t, causal, scale).numpy()
    np.testing.assert_allclose(dq, want, atol=ATOL, rtol=RTOL)
    assert np.abs(dq - want).max() < 1e-5  # fp32-level, far inside the gate


@pytest.mark.parametrize("causal", [False, True])
def test_one_tf32_product_leaves_the_gate_for_dq(causal):
    """dQ with one TF32 product per fp32 product: some elements fall
    outside the gate at the same inputs."""
    (q, k, v, do), scale, (_, lse, delta) = _inputs(causal)
    t = [torch.from_numpy(x) for x in (q, k, v, do, lse, delta)]
    want = tfa.reference_flash_backward_dq(*t, causal, scale).numpy()
    assert _outside(emulated_dq(q, k, v, do, lse, delta, causal, scale, products=1), want) > 0.01


@pytest.mark.parametrize("causal", [False, True])
def test_one_tf32_product_leaves_the_gate(causal):
    """One TF32 product per fp32 product (about 3 decimal digits) puts
    some elements of O outside the gate at the same inputs."""
    (q, k, v, _), scale, (o, _, _) = _inputs(causal)
    got_o, _ = emulated_forward(q, k, v, causal, scale, products=1)
    assert _outside(got_o, o) > 0.01
    assert _outside(emulated_forward(q, k, v, causal, scale, products=3)[0], o) == 0.0
