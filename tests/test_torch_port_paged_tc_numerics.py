"""The paged kernel's tensor-core body, its arithmetic emulated on the CPU.

``paged_append_tc_kernel`` in
``flexflow_tpu_torch/ops/kernels/csrc/paged_attention.cu`` takes a wide
window (W >= 9, D <= 128) on the tensor cores: S = (scale Q) K^T and
O += P V as ``mma.sync.m16n8k8`` TF32 products with fp32 accumulation,
the online softmax over tiles of 64 key positions in fp32. Each fp32
operand x is split into big = rna(x) and small = rna(x - big) (TF32
values, rounded as ``cvt.rna.tf32.f32`` rounds); a bf16 or fp16 K or V
element is a TF32 value exactly and is not split. So an fp32 cache takes
three products per fp32 product (big small + small big + big big), a
2-byte cache two (small big + big big: q or P split, K or V exact).

Here that arithmetic runs in numpy at a W = 256 window over 512 cache
positions with 2 heads (block size 16, a permuted table, padding queries)
for each cache dtype, and is held against the port's plain version
(``reference_paged_append_attention``, which the CUDA kernels are held
against on the card) at the card's gate, atol 1e-4 + rtol 1e-4; the plain
version in turn agrees with the JAX package's. One plain TF32 product
does not stay within that gate, which is why the body spends two or
three.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_port_paged_tc_numerics.py
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.ops.kernels import decode_attention as jda
from flexflow_tpu_torch.ops.kernels import decode_attention as tda

pytestmark = pytest.mark.torch_port

ATOL = RTOL = 1e-4  # chip_smoke.py's gate, kernel vs plain version
kTcKeys = 64  # key positions per staged tile (paged_attention.cu's constant)
SOURCE = Path(tda.__file__).parent / "csrc" / "paged_attention.cu"
NEG_INF = np.float32(-1e30)
CACHE_DTYPES = [torch.float32, torch.bfloat16, torch.float16]


def tf32_rna(x: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32 by the bits: keep 10 mantissa bits, rounded to
    nearest with ties away from zero (add half a unit, drop 13 bits)."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x: np.ndarray):
    big = tf32_rna(x)
    return big, tf32_rna(x - big)


def mma(a, b, acc, exact_b: bool, products: int):
    """acc + a @ b as the body's mma chain computes it: over the reduction
    axis in steps of 8, each TF32 product exact (float64) and added to the
    fp32 accumulator. ``products`` 3 or 2 take big small (unless b is
    exact), small big and big big, in that order; 1 is big big alone."""
    ab, asm = split(a)
    bb, bsm = (b, np.zeros_like(b)) if exact_b else split(b)
    terms = {3: [(ab, bsm), (asm, bb), (ab, bb)], 2: [(asm, bb), (ab, bb)], 1: [(ab, bb)]}
    for k0 in range(0, a.shape[-1], 8):
        for x, y in terms[products]:
            step = x[..., k0:k0 + 8].astype(np.float64) @ y[..., k0:k0 + 8, :].astype(np.float64)
            acc = (acc.astype(np.float64) + step).astype(np.float32)
    return acc


def emulated_body(q, k, v, qpos, scale, exact_kv: bool, products: int):
    """The tensor-core body over gathered K/V (q [W,H,D], k and v [S,H,D]
    fp32 holding the cache's values, qpos [W]): per head, tiles of
    kTcKeys positions, the online softmax on the scores in fp32, padding
    queries (qpos < 0) exact zeros."""
    w, h, d = q.shape
    out = np.zeros((w, h, d), np.float32)
    live = int(qpos.max()) + 1
    for hh in range(h):
        qs = (q[:, hh] * np.float32(scale)).astype(np.float32)
        m = np.full((w, 1), NEG_INF, np.float32)
        l = np.zeros((w, 1), np.float32)
        acc = np.zeros((w, d), np.float32)
        for k0 in range(0, live, kTcKeys):
            kt = k[k0:min(k0 + kTcKeys, live), hh]
            vt = v[k0:min(k0 + kTcKeys, live), hh]
            s = mma(qs, kt.T.copy(), np.zeros((w, kt.shape[0]), np.float32), exact_kv, products)
            valid = (k0 + np.arange(kt.shape[0]))[None, :] <= qpos[:, None]
            m_new = np.maximum(m, np.where(valid, s, NEG_INF).max(-1, keepdims=True))
            p = np.where(valid, np.exp(np.where(valid, s - m_new, 0)), 0).astype(np.float32)
            corr = np.exp(m - m_new).astype(np.float32)
            l = l * corr + p.sum(-1, keepdims=True, dtype=np.float32)
            acc = mma(p, vt, acc * corr, exact_kv, products)
            m = m_new
        out[:, hh] = np.where(qpos[:, None] >= 0, acc / np.maximum(l, np.float32(1e-30)), 0)
    return out


def _inputs(kv_dtype, w=256, positions=512, h=2, d=64, bs=16, seed=0):
    """A window of ``w`` queries at positions 256..511 of a 512-position
    table (32 columns of 16, permuted blocks, block 0 scratch), every
    ninth query padding; K and V rounded to ``kv_dtype``."""
    rs = np.random.RandomState(seed)
    mb = positions // bs
    tables = (rs.permutation(mb) + 1).astype(np.int32)[None, :]
    k = torch.from_numpy(rs.randn(mb + 1, bs, h, d).astype(np.float32)).to(kv_dtype)
    v = torch.from_numpy(rs.randn(mb + 1, bs, h, d).astype(np.float32)).to(kv_dtype)
    q = torch.from_numpy(rs.randn(1, w, h, d).astype(np.float32))
    qpos = (positions - w + np.arange(w)).astype(np.int32)
    qpos[::9] = -1
    return q, k, v, torch.from_numpy(tables), torch.from_numpy(qpos[None, :])


def _emulate(args, products):
    q, k, v, tables, qpos = args
    gather = lambda c: c[tables[0].long()].reshape(-1, *c.shape[2:]).float().numpy()  # noqa: E731
    return emulated_body(q[0].numpy(), gather(k), gather(v), qpos[0].numpy(),
                         q.shape[-1] ** -0.5, k.dtype != torch.float32, products)


def _plain(args):
    return tda.reference_paged_append_attention(*args)[0].numpy()


def _outside(got, want):
    """Elements outside atol + rtol * |want|, as a fraction."""
    return float(np.mean(np.abs(got - want) > ATOL + RTOL * np.abs(want)))


@pytest.mark.parametrize("kv_dtype", CACHE_DTYPES)
def test_two_byte_cache_elements_are_exact_tf32_operands(kv_dtype):
    """A bf16 or fp16 value widened to fp32 keeps at most 10 mantissa
    bits: TF32's rounding leaves it as it is, so the body need not split
    K or V of a 2-byte cache. An fp32 value needs the split."""
    _, k, _, _, _ = _inputs(kv_dtype)
    x = k.float().numpy()
    exact = np.array_equal(tf32_rna(x), x)
    assert exact == (kv_dtype != torch.float32)


@pytest.mark.parametrize("kv_dtype", CACHE_DTYPES)
def test_plain_version_agrees_with_the_jax_reference(kv_dtype):
    """The port's plain version, the oracle the kernel is held against on
    the card, against JAX's reference_paged_append_attention on the same
    cache values (each widens K and V to fp32)."""
    q, k, v, tables, qpos = _inputs(kv_dtype)
    want = jda.reference_paged_append_attention(
        jnp.asarray(q.numpy()), jnp.asarray(k.float().numpy()), jnp.asarray(v.float().numpy()),
        jnp.asarray(tables.numpy()), jnp.asarray(qpos.numpy()))
    np.testing.assert_allclose(_plain((q, k, v, tables, qpos)), np.asarray(want)[0],
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("kv_dtype", CACHE_DTYPES)
def test_the_body_keeps_the_gate(kv_dtype):
    """Three products over an fp32 cache, two over a 2-byte one: every
    element within atol 1e-4 + rtol 1e-4 of the plain version (and far
    inside it), padding queries exact zeros."""
    args = _inputs(kv_dtype)
    products = 3 if kv_dtype == torch.float32 else 2
    got, want = _emulate(args, products), _plain(args)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    assert np.abs(got - want).max() < 1e-5
    assert (got[args[4][0].numpy() < 0] == 0).all()


@pytest.mark.parametrize("kv_dtype", CACHE_DTYPES)
def test_one_tf32_product_leaves_the_gate(kv_dtype):
    """One TF32 product per fp32 product (q and P rounded to TF32, about 3
    decimal digits) puts some outputs outside the gate at the same
    inputs, for every cache dtype: the averaging over hundreds of
    positions hides most of the rounding, not all of it."""
    args = _inputs(kv_dtype)
    got, want = _emulate(args, products=1), _plain(args)
    assert _outside(got, want) > 0
    assert np.abs(got - want).max() > ATOL


def test_an_fp32_cache_needs_the_third_product():
    """Over an fp32 cache, leaving out big_q small_k (two products, as a
    2-byte cache takes) also leaves the gate: K's own rounding to TF32
    counts there."""
    args = _inputs(torch.float32)
    assert _outside(_emulate(args, products=2), _plain(args)) > 0


def test_python_constants_match_the_cuda_source():
    """The wrapper's account of which body runs (kernel_body) and this
    emulation's tile read the constants of the CUDA source they mirror."""
    text = SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))

    assert const("kTcMinWindow") == tda.TC_MIN_WINDOW
    assert const("kTcMaxHeadDim") == tda.TC_MAX_HEAD_DIM
    assert const("kTcKeys") == kTcKeys
    assert tda.kernel_body(tda.TC_MIN_WINDOW, 64) == "tensor_cores"
    assert tda.kernel_body(tda.TC_MIN_WINDOW - 1, 64) == "cuda_cores"
    assert tda.kernel_body(1024, tda.TC_MAX_HEAD_DIM + 1) == "cuda_cores"
