"""The paged attention kernel's CUDA source, run on the CPU.

``tests/torch_port_cuda_emulator.py`` compiles
``flexflow_tpu_torch/ops/kernels/csrc/paged_attention.cu`` with the host
C++ compiler against stand-in CUDA headers: one thread per CUDA thread,
barriers for blocks, warps and clusters, ``mma.sync`` TF32 emulated,
shared memory starting as NaN bits. Its exported launches (the six
``ff_paged_append_*`` symbols) then run on CPU tensors and are held
against the port's plain version, ``reference_paged_append_attention``,
at the card's gate (atol 1e-4 + rtol 1e-4): both bodies (the tensor-core
body from W = 9 at D <= 128, the CUDA-core body for decode and verify
windows and wider heads), every cache form, single-pass and split, with
and without a cluster split, padding queries exact zeros. This checks the
kernels' indexing, masking, fragment layouts and combine without a card;
what only the card can show (that nvcc takes the source, the timing, the
real mma's rounding) stays with the card tests.

    python -m pytest tests/test_torch_port_paged_emulated.py
"""
import numpy as np
import pytest
import torch

import torch_port_cuda_emulator as emulator
from flexflow_tpu_torch.ops.kernels import decode_attention as da

pytestmark = pytest.mark.torch_port

FORMS = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16"}


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return emulator.load(emulator.build(tmp_path_factory.mktemp("paged_emulated")))


def _case(qpos, h, d, bs, mb, seed, kv_dtype):
    """Random caches of ``kv_dtype`` and permuted tables for positions
    ``qpos`` [B, W]; block 0 is scratch, as in the engine's cache."""
    rs = np.random.RandomState(seed)
    b = qpos.shape[0]
    nb = b * mb + 1
    tables = rs.permutation(np.arange(1, nb))[:b * mb].reshape(b, mb).astype(np.int32)
    gen = torch.Generator().manual_seed(seed)
    k, v = (torch.randn(nb, bs, h, d, generator=gen).to(kv_dtype) for _ in range(2))
    q = torch.randn(b, qpos.shape[1], h, d, generator=gen)
    return (q, k, v, torch.from_numpy(tables),
            torch.from_numpy(np.ascontiguousarray(qpos, np.int32)))


def _run(lib, args, splits=1):
    """One launch of the emulated kernel of the caches' form; NaN where
    it writes nothing."""
    q, k, v, bt, qp = args
    b, w, h, d = q.shape
    out = torch.full_like(q, float("nan"))
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), bt.data_ptr(), qp.data_ptr(), out.data_ptr())
    if splits == 1:
        rc = getattr(lib, f"ff_paged_append_{FORMS[k.dtype]}")(
            *ptrs, b, w, h, d, k.shape[1], bt.shape[1], d ** -0.5, None)
    else:
        ctas, cols = da.split_plan(splits, bt.shape[1])
        rc = getattr(lib, f"ff_paged_append_split_{FORMS[k.dtype]}")(
            *ptrs, b, w, h, d, k.shape[1], bt.shape[1], ctas, cols, d ** -0.5, None)
    assert rc == 0
    return out


def _check(lib, args, splits=1):
    got = _run(lib, args, splits)
    torch.testing.assert_close(got, da.reference_paged_append_attention(*args),
                               atol=1e-4, rtol=1e-4)
    assert bool((got[args[4] < 0] == 0).all()), "padding queries must give exact zeros"


def _window(b, w, start, n_real):
    """A causal run of ``n_real`` queries from ``start`` in the first
    sequence, two queries at 0 and 1 in the second (a row that sees one
    position), padding elsewhere."""
    qpos = np.full((b, w), -1)
    qpos[0, :n_real] = start + np.arange(n_real)
    if b > 1:
        qpos[1, :2] = [0, 1]
    return qpos


@pytest.mark.parametrize("kv_dtype", list(FORMS))
@pytest.mark.parametrize("w,start,d,bs,mb,sms", [
    (16, 0, 64, 16, 8, 132),  # one query tile, a cluster of 2 over 128 positions
    (70, 40, 64, 16, 8, 132),  # two query tiles, padding rows, a cluster
    (70, 40, 64, 16, 8, 1),  # the same in one block a tile: no combine
    (9, 100, 32, 5, 30, 132),  # the crossover window, block size 5
    (33, 0, 100, 7, 12, 132),  # D = 100 padded to 128, block size 7
    (64, 60, 128, 16, 8, 132),
])
def test_tensor_core_body_matches_plain(lib, kv_dtype, w, start, d, bs, mb, sms):
    """The tensor-core body, single-pass (its cluster sized for ``sms``
    SMs) and split over 3 runs of columns."""
    assert da.kernel_body(w, d) == "tensor_cores"
    lib.emu_set_sms(sms)
    n_real = min(w - w // 7, mb * bs - start)
    args = _case(_window(2, w, start, n_real), 2, d, bs, mb, seed=w + d, kv_dtype=kv_dtype)
    _check(lib, args)
    _check(lib, args, splits=3)
    lib.emu_set_sms(132)


@pytest.mark.parametrize("kv_dtype", list(FORMS))
@pytest.mark.parametrize("w,d", [(1, 64), (5, 64), (8, 32), (40, 160)])
def test_cuda_core_body_matches_plain(lib, kv_dtype, w, d):
    """Decode and verify windows and a head dim past 128 (a window of two
    32-query tiles) on the CUDA-core body, single-pass and split."""
    assert da.kernel_body(w, d) == "cuda_cores"
    qpos = np.full((2, w), -1)
    qpos[0] = 100 + np.arange(w)
    qpos[1, 0] = 3
    args = _case(qpos, 2, d, 16, 8, seed=w, kv_dtype=kv_dtype)
    _check(lib, args)
    _check(lib, args, splits=4)


@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16])
def test_tensor_core_body_over_a_table_wider_than_a_block_holds(lib, kv_dtype):
    """3000 columns of one position: a block holds the first 2048 table
    columns in shared memory and reads the rest from device memory."""
    qpos = np.full((1, 24), -1)
    qpos[0, :20] = 2970 + np.arange(20)
    args = _case(qpos, 2, 64, 1, 3000, seed=19, kv_dtype=kv_dtype)
    _check(lib, args)
    _check(lib, args, splits=16)


@pytest.mark.parametrize("kv_dtype", list(FORMS))
def test_padding_only_windows_give_zeros(lib, kv_dtype):
    args = _case(np.full((2, 20), -1), 2, 64, 16, 8, seed=3, kv_dtype=kv_dtype)
    _check(lib, args)
    _check(lib, args, splits=4)


@pytest.mark.parametrize("kv_dtype,d", [(torch.bfloat16, 33), (torch.float32, 6),
                                        (torch.float16, 8), (torch.bfloat16, 6)])
def test_tensor_core_body_narrow_copies(lib, kv_dtype, d):
    """Head dims whose rows take 4-byte copies (fp32 D = 6, bf16 D = 6)
    or plain 2-byte loads (bf16 D = 33), and D = 8."""
    qpos = np.full((1, 12), -1)
    qpos[0, :10] = 30 + np.arange(10)
    _check(lib, _case(qpos, 2, d, 5, 10, seed=5, kv_dtype=kv_dtype))


def test_second_device_raises_its_own_limit(lib):
    """The dynamic shared-memory limit is a kernel's attribute on one
    device: the fp32 tensor-core instance at D = 64 asks for more than
    48 KB, and after a launch on device 0 it launches on device 1 only if
    its launcher raises the limit there too (the emulated runtime refuses
    the launch otherwise, as the card's does)."""
    args = _case(_window(2, 16, 0, 14), 2, 64, 16, 8, seed=3, kv_dtype=torch.float32)
    assert da.kernel_body(16, 64) == "tensor_cores"
    try:
        for device in (0, 1):
            assert lib.emu_set_device(device) == 0
            _check(lib, args)
    finally:
        lib.emu_set_device(0)
