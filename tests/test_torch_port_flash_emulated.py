"""The flash kernels' CUDA source, run on the CPU.

``tests/torch_port_cuda_emulator.py`` compiles
``flexflow_tpu_torch/ops/kernels/csrc/flash_attention.cu`` with the host
C++ compiler against stand-in CUDA headers: one thread per CUDA thread,
mbarriers, TMA tile loads (zero fill, the 128-byte swizzle) and bf16
``wgmma`` m64n64k16 (shared-memory descriptors, K-major and MN-major B,
register A) emulated, ``mma.sync`` TF32 as for the paged kernel, shared
memory starting as NaN bits. Its exported launches then run on CPU
tensors and are held against the port's plain versions,
``reference_flash_forward``, ``reference_flash_backward_dq`` and
``reference_flash_backward_dkv``, at the card's gates: bf16 outputs
within one bf16 ulp of the plain value + 1e-3
(``chip_smoke.py::check_bf16``), the fp32 logsumexp within atol 1e-4 +
rtol 1e-4.

The bf16 forward, dQ and dK/dV take the wgmma bodies (``ff_flash_body``
says which body a call takes) at causal and non-causal shapes, a ragged
S, Sq != Sk, D = 64 and 128, padded head dims (40, 96), and sequences of
several ring wraps; the kept mma.sync bodies (D <= 32, D % 8 != 0, a
misaligned view) and the fp32 forms run beside them. What only the card
can show (that nvcc takes the source, that the hardware reads the
descriptors and swizzle as emulated here, the timing) stays with the
card's tests and ``chip_smoke.py``.

    python -m pytest tests/test_torch_port_flash_emulated.py
"""
import pytest
import torch

import torch_port_cuda_emulator as emulator
from flexflow_tpu_torch.ops.kernels import flash_attention as fa

pytestmark = pytest.mark.torch_port

BF16_ATOL = 1e-3  # chip_smoke.py's bf16 gate: 1 ulp of the plain value + this
ATOL = RTOL = 1e-4  # the fp32 gate (lse; the fp32 forms)
FORMS = {torch.float32: "f32", torch.bfloat16: "bf16"}
KINDS = {"fwd": 0, "dq": 1, "dkv": 2}


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return emulator.load(emulator.build(tmp_path_factory.mktemp("flash_emulated"),
                                        "flash_attention.cu"))


def _close(name, got, want):
    if got.dtype == torch.bfloat16:
        g, w = got.float(), want.float()
        ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(1e-30))) - 7)
        err = (g - w).abs()
        assert bool(torch.isfinite(g).all()), f"{name}: non-finite (unwritten) outputs"
        bad = err > ulp + BF16_ATOL
        assert not bad.any(), (f"{name}: {int(bad.sum())} values past 1 bf16 ulp + {BF16_ATOL}, "
                               f"max abs err {float(err.max()):.3e}")
    else:
        torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)


def _inputs(b, sq, sk, h, d, dtype, misaligned=False):
    """q, k, v, dO from a seeded generator; ``misaligned`` puts each one
    2 bytes past a 16-byte boundary (a contiguous view into a larger
    buffer)."""
    gen = torch.Generator().manual_seed(sq * 7 + sk + d)
    out = []
    for s in (sq, sk, sk, sq):
        t = torch.randn(b, s, h, d, generator=gen).to(dtype)
        if misaligned:
            buf = torch.empty(t.numel() + 8, dtype=dtype)
            t = buf[1:1 + t.numel()].view(t.shape).copy_(t)
        out.append(t)
    return out


def _body(lib, kind, dtype, *tensors, d):
    ptrs = [t.data_ptr() if t is not None else None for t in tensors]
    return fa.BODIES[lib.ff_flash_body(int(dtype == torch.bfloat16), KINDS[kind], *ptrs, d)]


def _check(lib, b, sq, sk, h, d, causal, dtype=torch.bfloat16, body="wgmma", misaligned=False):
    q, k, v, do = _inputs(b, sq, sk, h, d, dtype, misaligned)
    scale = d ** -0.5
    form = FORMS[dtype]
    o = torch.full_like(q, float("nan"))
    lse = torch.full((b, sq, h), float("nan"))
    assert _body(lib, "fwd", dtype, q, k, v, None, o, None, d=d) == body
    rc = getattr(lib, f"ff_flash_fwd_{form}")(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                              o.data_ptr(), lse.data_ptr(), b, sq, sk, h, d,
                                              scale, int(causal), None)
    assert rc == 0
    po, plse = fa.reference_flash_forward(q, k, v, causal, scale)
    _close("o", o, po)
    torch.testing.assert_close(lse, plse, atol=ATOL, rtol=RTOL)

    delta = fa.flash_delta(do, po)
    dk, dv = torch.full_like(k, float("nan")), torch.full_like(v, float("nan"))
    assert _body(lib, "dkv", dtype, q, k, v, do, dk, dv, d=d) == body
    rc = getattr(lib, f"ff_flash_bwd_dkv_{form}")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), plse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, sq, sk, h, d, scale, int(causal), None)
    assert rc == 0
    pdk, pdv = fa.reference_flash_backward_dkv(q, k, v, do, plse, delta, causal, scale)
    _close("dk", dk, pdk)
    _close("dv", dv, pdv)

    dq = torch.full_like(q, float("nan"))
    assert _body(lib, "dq", dtype, q, k, v, do, dq, None, d=d) == body
    rc = getattr(lib, f"ff_flash_bwd_dq_{form}")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), plse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), b, sq, sk, h, d, scale, int(causal), None)
    assert rc == 0
    _close("dq", dq, fa.reference_flash_backward_dq(q, k, v, do, plse, delta, causal, scale))


@pytest.mark.parametrize("b,sq,sk,h,d,causal", [
    (1, 128, 128, 2, 64, False),  # the training shape's sequence and head dim
    (1, 320, 320, 2, 64, True),  # 5 tiles of 64 through a ring of 2: wraps twice
    (2, 100, 100, 2, 64, False),  # a ragged S: the last tile's rows past S are TMA zeros
    (1, 70, 200, 2, 96, False),  # Sq != Sk, D = 96 padded to 128 by zero columns
    (1, 65, 65, 2, 40, True),  # D = 40 padded to 64, causal, one row past a tile
    (1, 200, 200, 1, 128, True),  # D = 128: two 64-column blocks a tile
    (2, 1, 1, 3, 64, False),  # one query and one key
])
def test_wgmma_bodies_match_plain(lib, b, sq, sk, h, d, causal):
    _check(lib, b, sq, sk, h, d, causal)


@pytest.mark.parametrize("b,sq,sk,h,d,causal,dtype,misaligned", [
    (1, 70, 70, 2, 33, False, torch.bfloat16, False),  # D % 8 != 0
    (2, 40, 40, 2, 16, True, torch.bfloat16, False),  # D <= 32 (kdim 8 / vdim 16 padded)
    (1, 96, 96, 2, 64, True, torch.bfloat16, True),  # a misaligned view
    (1, 96, 96, 2, 64, True, torch.float32, False),  # the fp32 form
])
def test_kept_mma_sync_bodies_match_plain(lib, b, sq, sk, h, d, causal, dtype, misaligned):
    """Calls the wgmma bodies do not take run the mma.sync bodies, which
    hold the same gates."""
    _check(lib, b, sq, sk, h, d, causal, dtype, body="mma_sync", misaligned=misaligned)


def test_body_rule(lib):
    """The library's choice of body by head dim, kind and form: bf16
    forward, dQ and dK/dV at 32 < D <= 128, D % 8 == 0 take wgmma; the
    fp32 forms keep mma.sync; D > 128 runs on the CUDA cores."""
    q, k, v, do = _inputs(1, 8, 8, 1, 8, torch.bfloat16)
    got = {(kind, bf16, d): fa.BODIES[lib.ff_flash_body(bf16, KINDS[kind], q.data_ptr(),
                                                        k.data_ptr(), v.data_ptr(),
                                                        do.data_ptr(), q.data_ptr(),
                                                        k.data_ptr(), d)]
           for kind in KINDS for bf16 in (0, 1) for d in (32, 40, 64, 100, 128, 136)}
    for (kind, bf16, d), body in got.items():
        if d > 128:
            want = "cuda_cores"
        elif bf16 and d > 32 and d % 8 == 0:
            want = "wgmma"
        else:
            want = "mma_sync"
        assert body == want, (kind, bf16, d)
