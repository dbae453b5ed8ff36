"""The flash kernels' CUDA source, run on the CPU.

``tests/torch_port_cuda_emulator.py`` compiles
``flexflow_tpu_torch/ops/kernels/csrc/flash_attention.cu`` with the host
C++ compiler against stand-in CUDA headers: one thread per CUDA thread,
mbarriers, TMA tile loads (zero fill, the 128-byte swizzle) and bf16
``wgmma`` m64n64k16 in bf16 and fp16 (shared-memory descriptors, K-major
and MN-major B, register A) emulated, ``mma.sync`` TF32 as for the paged
kernel, shared memory starting as NaN bits. Its exported launches then
run on CPU tensors and are held against the port's plain versions,
``reference_flash_forward``, ``reference_flash_backward_dq`` and
``reference_flash_backward_dkv``, at the card's gates: bf16 and fp16
outputs within one ulp of the type at the plain value + 1e-3
(``chip_smoke.py::check_half``), the fp32 logsumexp within atol 1e-4 +
rtol 1e-4.

The bf16 and fp16 forward, dQ and dK/dV take the wgmma bodies
(``ff_flash_body`` says which body a call takes) at causal and
non-causal shapes, a ragged S, Sq != Sk, D = 64 and 128, padded head dims
(40, 96), and sequences of several ring wraps; fp16 also at its range
ends (|dS| past 65504, dO of order 1e-6), gated as
``chip_smoke.py::check_fp16_range`` gates them: one ulp + 1e-3 of each
output's largest |value|, which the bodies without dS's row scaling
fail (infinities; 2 subnormal ulps in dQ and dK). The kept mma.sync bodies
(D <= 32, D % 8 != 0, a misaligned view) and the fp32 forms run beside
them. The emulated runtime keeps each kernel's shared-memory limit by
device, as the card's does: a launch on a second device after one on the
first shows that the launchers raise it once a device. What only the card
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

HALF_ATOL = 1e-3  # chip_smoke.py's 2-byte gate: 1 ulp of the plain value + this
ATOL = RTOL = 1e-4  # the fp32 gate (lse; the fp32 forms)
FORMS = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16"}
FORM_INDEX = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
MANTISSA = {torch.bfloat16: 7, torch.float16: 10}  # stored mantissa bits
KINDS = {"fwd": 0, "dq": 1, "dkv": 2}


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return emulator.load(emulator.build(tmp_path_factory.mktemp("flash_emulated"),
                                        "flash_attention.cu"))


def _close(name, got, want, share=None):
    """``got`` against the plain ``want``: bf16 and fp16 within one ulp of
    the type at the plain value + HALF_ATOL, fp32 at the fp32 gate.
    ``share`` (the fp16 range cases): one ulp no finer than fp16's
    subnormal spacing, 2^-24, + this share of the largest |plain value| in
    place of HALF_ATOL, as ``chip_smoke.py::check_fp16_range`` gates them
    (HALF_ATOL would pass outputs of order 1e-6 whatever they held)."""
    if got.dtype in MANTISSA:
        g, w = got.float(), want.float()
        lg = torch.floor(torch.log2(w.abs().clamp_min(1e-30)))
        if share is None:
            atol = HALF_ATOL
        else:
            lg, atol = lg.clamp_min(-14), share * float(w.abs().max())
        ulp = torch.exp2(lg - MANTISSA[got.dtype])
        err = (g - w).abs()
        assert bool(torch.isfinite(g).all()), f"{name}: non-finite (unwritten) outputs"
        bad = err > ulp + atol
        assert not bad.any(), (f"{name}: {int(bad.sum())} values past 1 ulp + {atol:.3g}, "
                               f"max abs err {float(err.max()):.3e}")
    else:
        torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)


def _inputs(b, sq, sk, h, d, dtype, misaligned=False, mul=(1, 1, 1, 1)):
    """q, k, v, dO from a seeded generator, times ``mul``; ``misaligned``
    puts each one 2 bytes past a 16-byte boundary (a contiguous view into
    a larger buffer)."""
    gen = torch.Generator().manual_seed(sq * 7 + sk + d)
    out = []
    for s, m in zip((sq, sk, sk, sq), mul):
        t = torch.randn(b, s, h, d, generator=gen).mul(m).to(dtype)
        if misaligned:
            buf = torch.empty(t.numel() + 8, dtype=dtype)
            t = buf[1:1 + t.numel()].view(t.shape).copy_(t)
        out.append(t)
    return out


def _body(lib, kind, dtype, *tensors, d):
    ptrs = [t.data_ptr() if t is not None else None for t in tensors]
    return fa.BODIES[lib.ff_flash_body(FORM_INDEX[dtype], KINDS[kind], *ptrs, d)]


def _check(lib, b, sq, sk, h, d, causal, dtype=torch.bfloat16, body="wgmma", misaligned=False,
           mul=None):
    """``mul``: an fp16 range case's input multipliers (q, k, v, dO),
    gated as _close's ``share`` says."""
    q, k, v, do = _inputs(b, sq, sk, h, d, dtype, misaligned, mul or (1, 1, 1, 1))
    share = None if mul is None else RANGE_SHARE
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
    _close("o", o, po, share)
    torch.testing.assert_close(lse, plse, atol=ATOL, rtol=RTOL)

    delta = fa.flash_delta(do, po)
    dk, dv = torch.full_like(k, float("nan")), torch.full_like(v, float("nan"))
    assert _body(lib, "dkv", dtype, q, k, v, do, dk, dv, d=d) == body
    rc = getattr(lib, f"ff_flash_bwd_dkv_{form}")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), plse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, sq, sk, h, d, scale, int(causal), None)
    assert rc == 0
    pdk, pdv = fa.reference_flash_backward_dkv(q, k, v, do, plse, delta, causal, scale)
    _close("dk", dk, pdk, share)
    _close("dv", dv, pdv, share)

    dq = torch.full_like(q, float("nan"))
    assert _body(lib, "dq", dtype, q, k, v, do, dq, None, d=d) == body
    rc = getattr(lib, f"ff_flash_bwd_dq_{form}")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), plse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), b, sq, sk, h, d, scale, int(causal), None)
    assert rc == 0
    _close("dq", dq, fa.reference_flash_backward_dq(q, k, v, do, plse, delta, causal, scale),
           share)


WGMMA_SHAPES = [
    (1, 128, 128, 2, 64, False),  # the training shape's sequence and head dim
    (1, 320, 320, 2, 64, True),  # 5 tiles of 64 through a ring of 2: wraps twice
    (2, 100, 100, 2, 64, False),  # a ragged S: the last tile's rows past S are TMA zeros
    (1, 70, 200, 2, 96, False),  # Sq != Sk, D = 96 padded to 128 by zero columns
    (1, 65, 65, 2, 40, True),  # D = 40 padded to 64, causal, one row past a tile
    (1, 200, 200, 1, 128, True),  # D = 128: two 64-column blocks a tile
    (2, 1, 1, 3, 64, False),  # one query and one key
]
# fp16's range ends at the training shape (q, k, v, dO multipliers), as
# chip_smoke.py::check_fp16_range runs them on the card: |dS| past 65504
# (each row of dS scaled down before its split) and dO of order 1e-6
# (dS and the gradients subnormal in fp16: each row scaled up; without
# the scaling dQ and dK err by 2 subnormal ulps, twice this gate)
F16_RANGE_CASES = [("dS_past_65504", (0.01, 0.01, 1000, 1000)),
                   ("gradients_1e-6", (1, 1, 1, 1e-6))]
RANGE_SHARE = 1e-3  # of the largest |plain value|: chip_smoke.py's HALF_RANGE_SHARE


@pytest.mark.parametrize("b,sq,sk,h,d,causal,dtype,mul", [
    pytest.param(*shape, dtype, None, id="-".join(map(str, shape)) + f"-{FORMS[dtype]}")
    for shape in WGMMA_SHAPES for dtype in (torch.bfloat16, torch.float16)
] + [pytest.param(1, 128, 128, 2, 64, False, torch.float16, mul,
                  id=f"1-128-128-2-64-False-f16-{case}") for case, mul in F16_RANGE_CASES])
def test_wgmma_bodies_match_plain(lib, b, sq, sk, h, d, causal, dtype, mul):
    _check(lib, b, sq, sk, h, d, causal, dtype, mul=mul)


@pytest.mark.parametrize("b,sq,sk,h,d,causal,dtype,misaligned", [
    (1, 70, 70, 2, 33, False, torch.bfloat16, False),  # D % 8 != 0
    (2, 40, 40, 2, 16, True, torch.bfloat16, False),  # D <= 32 (kdim 8 / vdim 16 padded)
    (1, 96, 96, 2, 64, True, torch.bfloat16, True),  # a misaligned view
    (1, 96, 96, 2, 64, True, torch.float32, False),  # the fp32 form
    (1, 70, 70, 2, 33, True, torch.float16, False),  # fp16, D % 8 != 0
    (1, 96, 96, 2, 64, False, torch.float16, True),  # fp16, a misaligned view
])
def test_kept_mma_sync_bodies_match_plain(lib, b, sq, sk, h, d, causal, dtype, misaligned):
    """Calls the wgmma bodies do not take run the mma.sync bodies, which
    hold the same gates."""
    _check(lib, b, sq, sk, h, d, causal, dtype, body="mma_sync", misaligned=misaligned)


def test_body_rule(lib):
    """The library's choice of body by head dim, kind and form: bf16 and
    fp16 forward, dQ and dK/dV at 32 < D <= 128, D % 8 == 0 take wgmma;
    the fp32 forms keep mma.sync; D > 128 runs on the CUDA cores; a form
    past fp16 is refused."""
    q, k, v, do = _inputs(1, 8, 8, 1, 8, torch.bfloat16)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), q.data_ptr(), k.data_ptr())
    got = {(kind, form, d): fa.BODIES[lib.ff_flash_body(form, KINDS[kind], *ptrs, d)]
           for kind in KINDS for form in (0, 1, 2) for d in (32, 40, 64, 100, 128, 136)}
    for (kind, form, d), body in got.items():
        if d > 128:
            want = "cuda_cores"
        elif form and d > 32 and d % 8 == 0:
            want = "wgmma"
        else:
            want = "mma_sync"
        assert body == want, (kind, form, d)
    assert lib.ff_flash_body(3, 0, *ptrs, 64) == -1


def test_second_device_raises_its_own_limit(lib):
    """The dynamic shared-memory limit is a kernel's attribute on one
    device: after launches on device 0 (which raise it there), the same
    instances launch on device 1 only if their launchers raise it again
    there. The emulated runtime refuses a launch past 48 KB on a device
    where the limit was not raised, as the card's runtime does. The fp16
    dQ and dK/dV wgmma instances at D = 64 ask for more than 48 KB."""
    b, s, h, d = 1, 64, 1, 64
    q, k, v, do = _inputs(b, s, s, h, d, torch.float16)
    scale = d ** -0.5
    _, lse = fa.reference_flash_forward(q, k, v, False, scale)
    delta = fa.flash_delta(do, fa.reference_flash_forward(q, k, v, False, scale)[0])
    want = fa.reference_flash_backward_dq(q, k, v, do, lse, delta, False, scale)
    try:
        for device in (0, 1):
            assert lib.emu_set_device(device) == 0
            dq = torch.full_like(q, float("nan"))
            assert _body(lib, "dq", torch.float16, q, k, v, do, dq, None, d=d) == "wgmma"
            rc = lib.ff_flash_bwd_dq_f16(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                                         lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, s,
                                         s, h, d, scale, 0, None)
            assert rc == 0, f"launch on device {device}: cudaError_t {rc}"
            _close("dq", dq, want)
        assert lib.emu_set_device(2) != 0  # the emulated machine has two devices
    finally:
        lib.emu_set_device(0)
