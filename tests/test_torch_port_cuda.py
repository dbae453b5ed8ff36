"""The port's CUDA kernels against their plain versions, on a card.

Every case is marked ``gpu`` and skips where no GPU is present: a CUDA
kernel has no CPU mode. This file imports neither JAX nor the JAX
package, so it also runs on a GPU machine without them:

    python -m pytest --noconftest -q tests/test_torch_port_cuda.py

Tolerance: fp32, atol/rtol 1e-4 (the kernels sum in another order). The
engine's steps replayed as CUDA graphs must be bit-identical to the same
steps run eagerly: the same kernels in the same order.
"""
import numpy as np
import pytest
import torch

from flexflow_tpu_torch.generation import (
    ContinuousBatchingScheduler,
    GenerationEngine,
    SamplingParams,
    SpeculationConfig,
    init_decoder_params,
)
from flexflow_tpu_torch.models.transformer import TransformerConfig
from flexflow_tpu_torch.ops.kernels import decode_attention as da
from flexflow_tpu_torch.ops.kernels import flash_attention as fa

pytestmark = [pytest.mark.torch_port, pytest.mark.gpu]


# every form of the paged kernels (fp32, bf16 and fp16 caches) at no launch
PAGED_NONE = {f"{kernel}{form}": 0 for form in ("", "_bf16", "_f16")
              for kernel in ("paged_append", "paged_append_split")}
# every form of the flash kernels (fp32, bf16, fp16) at no launch
FLASH_NONE = {f"{kernel}{form}": 0 for form in ("", "_bf16", "_f16")
              for kernel in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
# a 2-byte flash form's launch-count suffix
HALF_FORMS = {torch.bfloat16: "_bf16", torch.float16: "_f16"}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("sq,sk,d,causal", [
    (128, 128, 64, False), (96, 96, 64, True), (40, 70, 100, False),
    # the tensor-core kernels' tile edges: one row, ragged 64-row blocks
    # and 16/32-row tiles, head dims padded to 32 and to 128, D % 4 != 0
    # (4-byte copies), and D = 256 on the CUDA-core forward and dK/dV
    (1, 1, 64, False), (63, 63, 64, True), (65, 65, 64, False), (129, 129, 64, True),
    (128, 128, 8, False), (65, 65, 100, True), (129, 129, 128, False), (70, 70, 33, False),
    (65, 65, 256, True), (512, 512, 64, True),
])
def test_cuda_kernels_match_plain_versions(cuda, sq, sk, d, causal):
    """The three flash kernels, causal and ragged, and the autograd path."""
    gen = torch.Generator().manual_seed(sq + sk + d)
    q = torch.randn(2, sq, 3, d, generator=gen).to(cuda)
    k = torch.randn(2, sk, 3, d, generator=gen).to(cuda)
    v = torch.randn(2, sk, 3, d, generator=gen).to(cuda)
    do = torch.randn(2, sq, 3, d, generator=gen).to(cuda)
    scale = d ** -0.5
    o, lse = fa.flash_forward_kernel(q, k, v, causal, scale)
    po, plse = fa.reference_flash_forward(q, k, v, causal, scale)
    torch.testing.assert_close(o, po, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(lse, plse, atol=1e-4, rtol=1e-4)
    delta = fa.flash_delta(do, po)
    dq = fa.flash_backward_dq_kernel(q, k, v, do, plse, delta, causal, scale)
    dk, dv = fa.flash_backward_dkv_kernel(q, k, v, do, plse, delta, causal, scale)
    want = fa.reference_flash_backward(q, k, v, do, plse, delta, causal, scale)
    for got, w in zip((dq, dk, dv), want):
        torch.testing.assert_close(got, w, atol=1e-4, rtol=1e-4)
    fa.reset_launch_counts()
    grads = []
    for backend in ("auto", "plain"):
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        (fa.flash_attention(*leaves, causal=causal, backend=backend) * do).sum().backward()
        grads.append([t.grad for t in leaves])
    assert fa.LAUNCHES == dict(FLASH_NONE, flash_fwd=1, flash_bwd_dq=1, flash_bwd_dkv=1)
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


def test_cuda_dkv_kernel_is_deterministic(cuda):
    """dK/dV is gridded over key tiles with no atomics: the same inputs
    give the same bits on every run."""
    gen = torch.Generator().manual_seed(5)
    q, k, v, do = (torch.randn(4, 256, 4, 64, generator=gen).to(cuda) for _ in range(4))
    o, lse = fa.flash_forward_kernel(q, k, v, True, 0.125)
    delta = fa.flash_delta(do, o)
    first = fa.flash_backward_dkv_kernel(q, k, v, do, lse, delta, True, 0.125)
    for _ in range(3):
        again = fa.flash_backward_dkv_kernel(q, k, v, do, lse, delta, True, 0.125)
        for a, b in zip(first, again):
            assert torch.equal(a, b)


def _dq_inputs(cuda, b, s, h, d, causal, seed):
    gen = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn(b, s, h, d, generator=gen).to(cuda) for _ in range(4))
    scale = d ** -0.5
    o, lse = fa.reference_flash_forward(q, k, v, causal, scale)
    return (q, k, v, do, lse, fa.flash_delta(do, o)), scale


@pytest.mark.parametrize("d", [8, 64, 100, 128, 256])  # 256: the CUDA-core dQ
@pytest.mark.parametrize("s,causal", [(1, False), (1, True), (65, False), (65, True),
                                      (100, False), (100, True)])
def test_cuda_dq_kernel_matches_plain(cuda, s, d, causal):
    """dQ on the tensor cores (D <= 128, head dims padded to 32/64/128,
    D % 4 != 0 with 4-byte copies) and on the CUDA cores (D = 256), with
    ragged 64-row blocks and 32-key tiles."""
    args, scale = _dq_inputs(cuda, 2, s, 3, d, causal, seed=s * 7 + d)
    got = fa.flash_backward_dq_kernel(*args, causal, scale)
    want = fa.reference_flash_backward_dq(*args, causal, scale)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_cuda_dq_kernel_is_deterministic(cuda):
    """dQ is gridded over query tiles with no atomics: the same inputs
    give the same bits on every run."""
    args, scale = _dq_inputs(cuda, 4, 256, 4, 64, True, seed=6)
    first = fa.flash_backward_dq_kernel(*args, True, scale)
    for _ in range(3):
        assert torch.equal(first, fa.flash_backward_dq_kernel(*args, True, scale))


def test_cuda_dq_kernel_into_unaligned_output(cuda):
    """An output 4 bytes past a 16-byte boundary takes scalar stores, not
    the paired float2 stores of an aligned one."""
    from flexflow_tpu_torch.ops.kernels._build import load_library

    args, scale = _dq_inputs(cuda, 2, 96, 3, 64, False, seed=8)
    q = args[0]
    buf = torch.full((q.numel() + 1,), float("nan"), device=cuda)
    dq = buf[1:].view_as(q)
    assert dq.data_ptr() % 16 == 4
    b, s, h, d = q.shape
    rc = load_library().ff_flash_bwd_dq_f32(
        *(t.data_ptr() for t in args), dq.data_ptr(), b, s, s, h, d, scale, 0,
        torch.cuda.current_stream().cuda_stream)
    assert rc == 0
    torch.cuda.synchronize()
    assert torch.isnan(buf[0])  # nothing written before the output
    torch.testing.assert_close(dq, fa.reference_flash_backward_dq(*args, False, scale),
                               atol=1e-4, rtol=1e-4)


def _paged_case(cuda, qpos, h, d, bs, mb, seed, kv_dtype=torch.float32):
    """Random caches (of ``kv_dtype``) and tables for positions ``qpos``
    [B, W]; block 0 is scratch, as in the engine's cache."""
    rs = np.random.RandomState(seed)
    b = qpos.shape[0]
    nb = b * mb + 1
    tables = rs.permutation(np.arange(1, nb))[:b * mb].reshape(b, mb).astype(np.int32)
    gen = torch.Generator().manual_seed(seed)
    k, v = (torch.randn(nb, bs, h, d, generator=gen).to(cuda, kv_dtype) for _ in range(2))
    q = torch.randn(b, qpos.shape[1], h, d, generator=gen).to(cuda)
    return (q, k, v, torch.from_numpy(tables).to(cuda),
            torch.from_numpy(np.ascontiguousarray(qpos, np.int32)).to(cuda))


def _check_paged(args):
    got = da.paged_append_attention(*args)
    want = da.reference_paged_append_attention(*args)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    pad = args[4] < 0
    assert bool((got[pad] == 0).all()), "padding queries must give exact zeros"


@pytest.mark.parametrize("ctx", [0, 1, 15, 16, 17, 129])
def test_cuda_paged_cluster_with_empty_ctas(cuda, ctx):
    """Decode (W = 1) over a 64-column table of 16: 8 blocks of 128
    positions a cluster. A short context leaves most blocks without a
    live position (ctx 129: one position in the second block; ctx 0: a
    padding-only sequence); a long one beside it fills six."""
    assert da.kernel_cluster_size(64, 16) == 8
    qpos = np.asarray([[ctx - 1], [730]])
    _check_paged(_paged_case(cuda, qpos, 4, 64, 16, 64, seed=ctx))


def test_cuda_paged_cluster_wide_window_ragged_table(cuda):
    """W = 32, D = 256, block size 5 and a table of 61 columns that the
    cluster's 3 blocks do not divide; padding queries, and one
    padding-only sequence."""
    c = da.kernel_cluster_size(61, 5)
    assert c == 3 and 61 % c != 0
    rs = np.random.RandomState(3)
    qpos = (rs.randint(0, 61 * 5 - 32, (3, 1)) + np.arange(32)[None, :])
    qpos[rs.rand(3, 32) < 0.2] = -1
    qpos[1] = -1
    _check_paged(_paged_case(cuda, qpos, 2, 256, 5, 61, seed=4))


@pytest.mark.parametrize("w,start", [(33, 0), (64, 512), (100, 40), (256, 0), (256, 512),
                                     (1024, 0)])
def test_cuda_paged_wide_windows_match_plain(cuda, w, start):
    """Windows past the kernel's 32-query tile, as a suffix prefill gives
    them (a causal run from ``start``, then padding queries), beside a
    short run and a padding-only sequence: one launch of the single-pass
    kernel (every query tile its own cluster), and the split kernel."""
    n_real = min(w, 1024 - start) - w // 7
    qpos = np.full((3, w), -1)
    qpos[0, :n_real] = start + np.arange(n_real)
    qpos[1, :5] = 300 + np.arange(5)
    args = _paged_case(cuda, qpos, 4, 64, 16, 64, seed=w + start)
    da.reset_launch_counts()
    _check_paged(args)
    assert da.LAUNCHES == {**PAGED_NONE, "paged_append": 1}
    _check_split(args, 8)


def test_cuda_paged_wide_window_edge_shapes(cuda):
    """W = 33 with D = 256 and block size 5 (4-byte copies in the second
    tile too), a window of padding only, and a 41-query verify batch."""
    rs = np.random.RandomState(21)
    qpos = rs.randint(0, 30 * 5 - 33, (2, 1)) + np.arange(33)[None, :]
    qpos[rs.rand(2, 33) < 0.2] = -1
    _check_paged(_paged_case(cuda, qpos, 2, 256, 5, 30, seed=21))
    _check_paged(_paged_case(cuda, np.full((2, 70), -1), 4, 64, 16, 8, seed=22))
    qpos = np.full((4, 41), -1)
    for i, (st, n) in enumerate(((100, 41), (700, 13), (0, 0), (300, 33))):
        qpos[i, :n] = st + np.arange(n)
    _check_paged(_paged_case(cuda, qpos, 12, 64, 16, 64, seed=23))


FORMS = {torch.float32: "", torch.bfloat16: "_bf16", torch.float16: "_f16"}


def _suffix_window(w, start, b=3, table_positions=1024):
    """A suffix prefill's window of ``w`` queries: a causal run from
    ``start`` (a seventh of the window left as padding), a short run
    beside it, and a padding-only sequence."""
    n_real = min(w, table_positions - start) - w // 7
    qpos = np.full((b, w), -1)
    qpos[0, :n_real] = start + np.arange(n_real)
    qpos[1, :min(w, 5)] = 300 + np.arange(min(w, 5))
    return qpos


@pytest.mark.parametrize("kv_dtype", list(FORMS))
@pytest.mark.parametrize("w", [9, 16, 32, 33, 64, 256, 1024])
@pytest.mark.parametrize("start", [0, 512])
def test_cuda_paged_tensor_core_windows_match_plain(cuda, kv_dtype, w, start):
    """The tensor-core body (W >= 9, D <= 128) in each cache form, at the
    suffix buckets and past a query tile, from positions 0 and 512 of a
    64-column table of 16: one launch of the form's single-pass kernel,
    then the split kernel, each against the plain version at the fp32
    gate (both widen K and V exactly), padding queries exact zeros."""
    args = _paged_case(cuda, _suffix_window(w, start), 4, 64, 16, 64, seed=w + start,
                       kv_dtype=kv_dtype)
    form = FORMS[kv_dtype]
    da.reset_launch_counts()
    _check_paged(args)
    assert da.LAUNCHES == {**PAGED_NONE, f"paged_append{form}": 1}
    da.reset_launch_counts()
    got = da.paged_append_attention(*args, kv_splits=8)
    assert da.LAUNCHES == {**PAGED_NONE, f"paged_append_split{form}": 1}
    torch.testing.assert_close(got, da.reference_paged_append_attention(*args),
                               atol=1e-4, rtol=1e-4)
    assert bool((got[args[4] < 0] == 0).all()), "padding queries must give exact zeros"


@pytest.mark.parametrize("kv_dtype", list(FORMS))
@pytest.mark.parametrize("d", [32, 64, 96, 128, 256])  # 256: the CUDA-core body
def test_cuda_paged_tensor_core_head_dims(cuda, kv_dtype, d):
    """Head dims 32, 64, 96 and 128 on the tensor-core body (96 padded to
    128 in shared memory) and 256 on the CUDA-core body, at a 40-query
    window with padding queries, single-pass and split."""
    rs = np.random.RandomState(d)
    qpos = rs.randint(0, 20 * 16 - 40, (2, 1)) + np.arange(40)[None, :]
    qpos[rs.rand(2, 40) < 0.2] = -1
    args = _paged_case(cuda, qpos, 2, d, 16, 20, seed=d, kv_dtype=kv_dtype)
    _check_paged(args)
    _check_split(args, 4)


@pytest.mark.parametrize("kv_dtype", list(FORMS))
def test_cuda_paged_tensor_core_ragged_tables(cuda, kv_dtype):
    """The tensor-core body over block size 5 and a ragged 61-column
    table (a 70-query window, padding rows among live ones, one
    padding-only sequence), over a table wider than the 2048 columns a
    CTA holds in shared memory (3000 columns of one position), and a
    window of padding only: single-pass and split against the plain
    version, every padding row exact zeros."""
    rs = np.random.RandomState(17)
    qpos = rs.randint(0, 61 * 5 - 70, (3, 1)) + np.arange(70)[None, :]
    qpos[rs.rand(3, 70) < 0.25] = -1
    qpos[2] = -1
    args = _paged_case(cuda, qpos, 2, 64, 5, 61, seed=18, kv_dtype=kv_dtype)
    _check_paged(args)
    for splits in (3, 61):
        _check_split(args, splits)
    qpos = np.full((1, 24), -1)
    qpos[0, :20] = 2970 + np.arange(20)
    args = _paged_case(cuda, qpos, 2, 64, 1, 3000, seed=19, kv_dtype=kv_dtype)
    _check_paged(args)
    _check_split(args, 16)
    args = _paged_case(cuda, np.full((2, 100), -1), 2, 64, 16, 8, seed=20, kv_dtype=kv_dtype)
    _check_paged(args)
    _check_split(args, 4)


@pytest.mark.parametrize("kv_dtype", list(FORMS))
@pytest.mark.parametrize("splits", [3, 8])
def test_cuda_paged_tensor_core_split_w64(cuda, kv_dtype, splits):
    """The split form's tensor-core body at a 64-query window (the
    long-context cell's table of 64 columns of 16, context past 700)
    against the plain split partials + combine and the single-pass plain
    version."""
    qpos = np.full((1, 64), -1)
    qpos[0, :54] = 700 + np.arange(54)
    _check_split(_paged_case(cuda, qpos, 12, 64, 16, 64, seed=splits, kv_dtype=kv_dtype), splits)


@pytest.mark.parametrize("splits", [1, 8])
def test_cuda_paged_tensor_core_body_replays_in_a_cuda_graph(cuda, splits):
    """A 256-query window (both forms of the tensor-core body) captured
    into a CUDA graph and replayed on new queries copied into the
    captured buffer: each replay equals an eager launch exactly."""
    args = _paged_case(cuda, _suffix_window(256, 512), 4, 64, 16, 64, seed=41)
    da.paged_append_attention(*args, kv_splits=splits)  # first launch outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = da.paged_append_attention(*args, kv_splits=splits)
    for _ in range(2):
        args[0].copy_(torch.randn_like(args[0]))
        graph.replay()
        torch.cuda.synchronize()
        torch.testing.assert_close(out, da.paged_append_attention(*args, kv_splits=splits),
                                   atol=0, rtol=0)
        torch.testing.assert_close(out, da.reference_paged_append_attention(*args),
                                   atol=1e-4, rtol=1e-4)


def test_cuda_paged_body_by_window_and_head_dim(cuda):
    """Which body a launch runs, by its device kernel's name: the
    tensor-core body from W = 9 at D <= 128, the CUDA-core body for
    W <= 8 and for D > 128, in both forms."""
    from torch.profiler import ProfilerActivity, profile

    def kernels(w, d, splits):
        args = _paged_case(cuda, 100 + np.arange(w)[None, :], 2, d, 16, 20, seed=w + d)
        da.paged_append_attention(*args, kv_splits=splits)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            da.paged_append_attention(*args, kv_splits=splits)
            torch.cuda.synchronize()
        return {e.name for e in prof.events() if "paged_append" in e.name}

    for splits in (1, 4):
        for w, d, body in ((1, 64, "paged_append_kernel<"), (8, 64, "paged_append_kernel<"),
                           (9, 64, "paged_append_tc_kernel<"), (40, 128, "paged_append_tc_kernel<"),
                           (40, 256, "paged_append_kernel<")):
            names = kernels(w, d, splits)
            assert names and all(body in n for n in names), (w, d, splits, names)


def _check_split(args, kv_splits):
    """The fused split kernel of the caches' form against the plain split
    + combine and the single-pass plain version: one launch, no
    single-pass launch."""
    da.reset_launch_counts()
    got = da.paged_append_attention(*args, kv_splits=kv_splits)
    assert da.LAUNCHES == {**PAGED_NONE, f"paged_append_split{FORMS[args[1].dtype]}": 1}
    partials = da.reference_paged_append_partials(*args, kv_splits)
    torch.testing.assert_close(got, da._combine_splits(*partials, args[4], torch.float32),
                               atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(got, da.reference_paged_append_attention(*args),
                               atol=1e-4, rtol=1e-4)
    pad = args[4] < 0
    assert bool((got[pad] == 0).all()), "padding queries must give exact zeros"


@pytest.mark.parametrize("splits", [2, 4, 8, 16, 64])  # 64 = MB: 8 splits a block
@pytest.mark.parametrize("w", [1, 3, 32])
@pytest.mark.parametrize("d", [1, 64, 100, 256])
def test_cuda_paged_split_matches_plain(cuda, splits, w, d):
    """The split-KV kernel (a cluster of blocks over runs of whole
    splits, combined on-chip) over 64 columns of 16: a long context, a
    short one that leaves most splits empty, a padding-only sequence,
    and padding queries; D = 1 and 100 take 4-byte copies."""
    rs = np.random.RandomState(splits * 1000 + w * 10 + d)
    base = np.asarray([900, 20, 0])[:, None]
    qpos = base + np.arange(w)[None, :]
    qpos[rs.rand(3, w) < 0.2] = -1
    qpos[2] = -1
    _check_split(_paged_case(cuda, qpos, 2, d, 16, 64, seed=splits + w + d), splits)


@pytest.mark.parametrize("splits,mb", [(3, 61), (7, 61), (61, 61), (2, 9), (9, 9), (5, 30)])
def test_cuda_paged_split_ragged_plans(cuda, splits, mb):
    """Split counts that do not divide the table, and blocks that take
    several splits (as many splits as columns), with block size 5."""
    ctas, cols = da.split_plan(splits, mb)
    assert (ctas - 1) * cols < mb <= ctas * cols
    qpos = np.asarray([[mb * 5 - 3, mb * 5 - 2, mb * 5 - 1], [2, 40, -1]])
    _check_split(_paged_case(cuda, qpos, 3, 64, 5, mb, seed=splits * mb), splits)


def test_cuda_paged_split_takes_a_table_too_wide_for_the_single_pass_kernel(cuda):
    """60000 columns of one position, which the reference serves: the
    single-pass kernel (one launch, no split) holds the row's first 2048
    columns in shared memory and reads the rest from device memory, and
    matches the plain version; so do the split kernel's blocks, 2048
    columns each."""
    rs = np.random.RandomState(11)
    mb, nb = 60000, 4097
    tables = torch.from_numpy(rs.randint(1, nb, (1, mb)).astype(np.int32)).to(cuda)
    gen = torch.Generator().manual_seed(11)
    k, v = (torch.randn(nb, 1, 2, 64, generator=gen).to(cuda) for _ in range(2))
    q = torch.randn(1, 3, 2, 64, generator=gen).to(cuda)
    qpos = torch.tensor([[57000, 59999, -1]], dtype=torch.int32, device=cuda)
    args = (q, k, v, tables, qpos)
    da.reset_launch_counts()
    _check_paged(args)
    assert da.LAUNCHES == {**PAGED_NONE, "paged_append": 1}
    for splits in (16, mb):
        _check_split(args, splits)


def test_cuda_paged_cluster_launch_replays_in_a_cuda_graph(cuda):
    """The cluster launch is captured into a CUDA graph and replayed on
    new inputs copied into the captured buffers."""
    qpos = np.asarray([[730], [17], [-1], [376]])
    args = _paged_case(cuda, qpos, 12, 64, 16, 64, seed=9)
    da.paged_append_attention(*args)  # first launch outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = da.paged_append_attention(*args)
    args[0].copy_(torch.randn_like(args[0]))
    graph.replay()
    torch.cuda.synchronize()
    torch.testing.assert_close(out, da.reference_paged_append_attention(*args),
                               atol=1e-4, rtol=1e-4)


def test_cuda_paged_split_replays_in_a_cuda_graph(cuda):
    """The split kernel captured into a CUDA graph: two replays on new
    queries copied into the captured buffer each give what an eager call
    gives (the kernel keeps no state between launches)."""
    qpos = np.asarray([[930]])
    args = _paged_case(cuda, qpos, 12, 64, 16, 64, seed=12)
    da.paged_append_attention(*args, kv_splits=8)  # first launch outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = da.paged_append_attention(*args, kv_splits=8)
    for _ in range(2):
        args[0].copy_(torch.randn_like(args[0]))
        graph.replay()
        torch.cuda.synchronize()
        torch.testing.assert_close(out, da.paged_append_attention(*args, kv_splits=8),
                                   atol=0, rtol=0)
        torch.testing.assert_close(out, da.reference_paged_append_attention(*args),
                                   atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("w,h,d,bs,mb", [
    (1, 12, 64, 16, 64),  # the serving decode shape (16-byte copies)
    (5, 4, 33, 5, 30),  # odd head dim: plain 2-byte loads, odd block size
    (3, 2, 6, 7, 12),  # D % 8 != 0, even: 4-byte copies
    (40, 2, 512, 16, 20),  # the 512-wide instance, a 32-query tile and a second one
    (1, 2, 512, 16, 20),
])
def test_cuda_paged_two_byte_cache_forms_match_plain(cuda, kv_dtype, w, h, d, bs, mb):
    """The bf16 and fp16 forms of both paged kernels against the plain
    version over the same 2-byte caches (both widen K and V exactly and
    compute in fp32: the fp32 gate), each launching its own form only;
    padding queries give exact zeros."""
    rs = np.random.RandomState(w * 100 + d)
    base = rs.randint(0, mb * bs - w, (3, 1))
    qpos = base + np.arange(w)[None, :]
    qpos[rs.rand(3, w) < 0.2] = -1
    qpos[2] = -1
    args = _paged_case(cuda, qpos, h, d, bs, mb, seed=w + d, kv_dtype=kv_dtype)
    form = "_bf16" if kv_dtype == torch.bfloat16 else "_f16"
    da.reset_launch_counts()
    got = da.paged_append_attention(*args)
    assert da.LAUNCHES == {**PAGED_NONE, f"paged_append{form}": 1}
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, da.reference_paged_append_attention(*args),
                               atol=1e-4, rtol=1e-4)
    assert bool((got[args[4] < 0] == 0).all()), "padding queries must give exact zeros"
    for splits in (3, mb):
        da.reset_launch_counts()
        got = da.paged_append_attention(*args, kv_splits=splits)
        assert da.LAUNCHES == {**PAGED_NONE, f"paged_append_split{form}": 1}
        partials = da.reference_paged_append_partials(*args, splits)
        torch.testing.assert_close(got, da._combine_splits(*partials, args[4], torch.float32),
                                   atol=1e-4, rtol=1e-4)
        assert bool((got[args[4] < 0] == 0).all())


def test_cuda_paged_two_byte_cache_unaligned_rows(cuda):
    """A bf16 cache that starts 4 bytes past a 16-byte boundary takes the
    4-byte copies (D = 64), one 2 bytes past takes plain loads: both
    match the plain version."""
    qpos = np.asarray([[300, 301], [17, -1]])
    q, k, v, bt, qp = _paged_case(cuda, qpos, 4, 64, 16, 32, seed=31, kv_dtype=torch.bfloat16)
    for shift in (2, 1):  # elements: 4 and 2 bytes
        kb = torch.empty(k.numel() + 8, dtype=k.dtype, device=cuda)
        vb = torch.empty_like(kb)
        ks, vs = kb[shift:shift + k.numel()].view_as(k), vb[shift:shift + v.numel()].view_as(v)
        ks.copy_(k)
        vs.copy_(v)
        assert ks.data_ptr() % 16 == 2 * shift
        got = da.paged_append_attention(q, ks, vs, bt, qp)
        torch.testing.assert_close(got, da.reference_paged_append_attention(q, k, v, bt, qp),
                                   atol=1e-4, rtol=1e-4)


def test_cuda_engine_serves_from_a_bf16_cache(cuda):
    """A graph engine over a bf16 cache: its greedy streams equal an
    eager engine's over the same cache dtype, every decode step launches
    the bf16 kernel once a layer (the fp32 forms never), and a decode
    step's logits agree with plain attention over the same cache within
    1e-3."""
    from flexflow_tpu_torch.core.types import DataType
    from flexflow_tpu_torch.generation import CacheConfig
    from flexflow_tpu_torch.generation.decoder import decode_step

    cfg = TransformerConfig(num_layers=2, hidden_size=128, num_heads=2, ff_size=256,
                            seq_length=64, vocab_size=97, causal=True)
    params = init_decoder_params(torch.Generator().manual_seed(7), cfg)
    cc = CacheConfig(num_layers=2, num_heads=2, head_dim=64, num_blocks=40, block_size=8,
                     dtype=DataType.BFLOAT16)
    prompts = [[3, 1, 4, 1, 5, 9, 2, 6], list(range(10, 30)), [7] * 5]
    streams = {}
    for eager in (False, True):
        engine = GenerationEngine(params, cfg, cache_config=cc, max_batch_slots=3,
                                  prompt_buckets=(8, 16, 32, 64), device=cuda,
                                  eager_steps=eager, prefix_cache=False)
        assert engine.cache.k.dtype == torch.bfloat16
        engine.generate(prompts, SamplingParams(max_new_tokens=3))  # every step captured
        decode0 = engine.step_counts["decode"]
        da.reset_launch_counts()
        streams[eager] = engine.generate(prompts, SamplingParams(max_new_tokens=10))
        steps = engine.step_counts["decode"] - decode0
        assert da.LAUNCHES == {**PAGED_NONE, "paged_append_bf16": cfg.num_layers * steps}
    assert streams[False] == streams[True]
    tok = torch.tensor([5, 6, 7], dtype=torch.int32, device=cuda)
    pos = torch.tensor([8, 20, 5], dtype=torch.int32, device=cuda)
    tables = torch.tensor([[1, 2, 0, 0, 0, 0, 0, 0], [3, 4, 5, 0, 0, 0, 0, 0],
                           [6, 0, 0, 0, 0, 0, 0, 0]], dtype=torch.int32, device=cuda)
    logits = {}
    for backend in ("auto", "plain"):
        ck, cv = engine.cache.k.clone(), engine.cache.v.clone()
        logits[backend], _, _ = decode_step(engine.params, tok, pos, ck, cv, tables, pos + 1,
                                            backend=backend)
    torch.testing.assert_close(logits["auto"], logits["plain"], atol=1e-3, rtol=0)


def _half_close(name, got, want):
    """bf16 or fp16 outputs against the plain version's: within one unit
    in the last place of the type at the plain value (no finer than the
    type's smallest normal's), plus atol 1e-3 (the kernels sum in another
    order, so a value near a rounding boundary may round to the
    neighbour)."""
    assert got.dtype == want.dtype and got.dtype in HALF_FORMS, name
    bits, low = (7, -126) if got.dtype == torch.bfloat16 else (10, -14)
    g, w = got.float(), want.float()
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(1e-30))).clamp_min(low) - bits)
    bad = (g - w).abs() > ulp + 1e-3
    assert not bad.any(), f"{name}: {int(bad.sum())} values past 1 ulp + 1e-3, " \
        f"max abs err {float((g - w).abs().max()):.3e}"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "f16"])
@pytest.mark.parametrize("sq,sk,d,causal", [
    (128, 128, 64, False), (512, 512, 64, True), (65, 65, 128, True), (40, 70, 96, False),
    # D % 8 != 0 (element copies), one row, D = 32, the CUDA-core forms
    (70, 70, 33, False), (1, 1, 64, False), (129, 129, 32, True), (65, 65, 256, True),
    (64, 64, 512, False),
])
def test_cuda_bf16_kernels_match_plain_versions(cuda, sq, sk, d, causal, dtype):
    """The bf16 and fp16 forms of the three flash kernels against the
    plain versions on the same inputs of that type: outputs within 1 ulp
    of the type + 1e-3, the logsumexp (fp32) within 1e-4."""
    gen = torch.Generator().manual_seed(sq + sk + d + 7)
    q, k, v, do = (torch.randn(2, s, 3, d, generator=gen).to(cuda, dtype)
                   for s in (sq, sk, sk, sq))
    scale = d ** -0.5
    fa.reset_launch_counts()
    o, lse = fa.flash_forward_kernel(q, k, v, causal, scale)
    po, plse = fa.reference_flash_forward(q, k, v, causal, scale)
    _half_close("o", o, po)
    torch.testing.assert_close(lse, plse, atol=1e-4, rtol=1e-4)
    delta = fa.flash_delta(do, po)
    dq = fa.flash_backward_dq_kernel(q, k, v, do, plse, delta, causal, scale)
    dk, dv = fa.flash_backward_dkv_kernel(q, k, v, do, plse, delta, causal, scale)
    pdq, pdk, pdv = fa.reference_flash_backward(q, k, v, do, plse, delta, causal, scale)
    for name, got, want in (("dq", dq, pdq), ("dk", dk, pdk), ("dv", dv, pdv)):
        _half_close(name, got, want)
    form = HALF_FORMS[dtype]
    assert fa.LAUNCHES == dict(FLASH_NONE, **{f"flash_fwd{form}": 1, f"flash_bwd_dq{form}": 1,
                                             f"flash_bwd_dkv{form}": 1})


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "f16"])
@pytest.mark.parametrize("d,misaligned,body", [
    (64, False, "wgmma"), (40, False, "wgmma"), (128, False, "wgmma"),
    (32, False, "mma_sync"), (33, False, "mma_sync"), (64, True, "mma_sync"),
    (160, False, "cuda_cores"),
])
def test_cuda_bf16_launches_are_counted_by_body(cuda, d, misaligned, body, dtype):
    """The bf16 and fp16 forward, dQ and dK/dV take the wgmma bodies
    where TMA takes the tensors (32 < D <= 128, D % 8 == 0,
    16-byte-aligned bases), else the mma.sync bodies (D > 128: the CUDA
    cores). Each launch is counted under the body the library reports,
    and every body matches the plain versions."""
    gen = torch.Generator().manual_seed(d)
    tensors = []
    for _ in range(4):
        t = torch.randn(2, 70, 3, d, generator=gen).to(cuda, dtype)
        if misaligned:  # 2 bytes past a 16-byte boundary
            t = torch.empty(t.numel() + 8, dtype=t.dtype, device=cuda)[1:1 + t.numel()] \
                .view(t.shape).copy_(t)
        tensors.append(t)
    q, k, v, do = tensors
    scale = d ** -0.5
    fa.reset_launch_counts()
    o, lse = fa.flash_forward_kernel(q, k, v, True, scale)
    po, plse = fa.reference_flash_forward(q, k, v, True, scale)
    delta = fa.flash_delta(do, po)
    dk, dv = fa.flash_backward_dkv_kernel(q, k, v, do, plse, delta, True, scale)
    dq = fa.flash_backward_dq_kernel(q, k, v, do, plse, delta, True, scale)
    pdq, pdk, pdv = fa.reference_flash_backward(q, k, v, do, plse, delta, True, scale)
    for name, got, want in (("o", o, po), ("dq", dq, pdq), ("dk", dk, pdk), ("dv", dv, pdv)):
        _half_close(name, got, want)
    torch.testing.assert_close(lse, plse, atol=1e-4, rtol=1e-4)
    form = HALF_FORMS[dtype]
    assert {key: n for key, n in fa.LAUNCHES_BY_BODY.items() if n} == {
        f"flash_fwd{form} {body}": 1, f"flash_bwd_dkv{form} {body}": 1,
        f"flash_bwd_dq{form} {body}": 1}


def test_cuda_bf16_dq_into_a_misaligned_output_alone_keeps_mma_sync(cuda):
    """The dQ body rule checks dq's own alignment: with q, k, v and dO
    aligned, a dq 2 bytes past a 16-byte boundary (paired bf16 stores
    could not take it) sends the call to the mma.sync body, which writes
    it and matches the plain version; the aligned output takes wgmma."""
    from flexflow_tpu_torch.ops.kernels._build import load_library

    gen = torch.Generator().manual_seed(12)
    q, k, v, do = (torch.randn(2, 96, 3, 64, generator=gen).to(cuda, torch.bfloat16)
                   for _ in range(4))
    scale = 64 ** -0.5
    po, plse = fa.reference_flash_forward(q, k, v, True, scale)
    delta = fa.flash_delta(do, po)
    want = fa.reference_flash_backward_dq(q, k, v, do, plse, delta, True, scale)
    buf = torch.full((q.numel() + 8,), float("nan"), dtype=torch.bfloat16, device=cuda)
    dq = buf[1:1 + q.numel()].view(q.shape)
    assert dq.data_ptr() % 16 == 2
    assert fa.kernel_body("flash_bwd_dq", q, k, v, do, torch.empty_like(q)) == "wgmma"
    assert fa.kernel_body("flash_bwd_dq", q, k, v, do, dq) == "mma_sync"
    b, s, h, d = q.shape
    rc = load_library().ff_flash_bwd_dq_bf16(
        *(t.data_ptr() for t in (q, k, v, do, plse, delta)), dq.data_ptr(), b, s, s, h, d,
        scale, 1, torch.cuda.current_stream().cuda_stream)
    assert rc == 0
    torch.cuda.synchronize()
    _half_close("dq", dq, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_cuda_value_head_dim_other_than_key_head_dim(cuda, dtype):
    """multihead attention with kdim=8, vdim=16 (and the reverse): the
    kernels run on zero-padded head dims and match the plain versions,
    forward and gradients."""
    for dk, dv in ((8, 16), (64, 24)):
        gen = torch.Generator().manual_seed(dk * 100 + dv)
        base = [torch.randn(2, 8, 2, d, generator=gen).to(cuda, dtype) for d in (dk, dk, dv)]
        dout = torch.randn(2, 8, 2, dv, generator=gen).to(cuda, dtype)
        outs = {}
        for backend in ("auto", "plain"):
            q, k, v = (t.clone().requires_grad_(True) for t in base)
            fa.reset_launch_counts()
            o = fa.flash_attention(q, k, v, backend=backend)
            o.backward(dout)
            launched = sum(fa.LAUNCHES.values())
            assert launched == (3 if backend == "auto" else 0)
            outs[backend] = (o.detach(), q.grad, k.grad, v.grad)
        assert outs["auto"][0].shape == (2, 8, 2, dv) and outs["auto"][3].shape == base[2].shape
        for name, got, want in zip(("o", "dq", "dk", "dv"), outs["auto"], outs["plain"]):
            if dtype in HALF_FORMS:
                _half_close(name, got, want)
            else:
                torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_cuda_model_with_value_head_dim_other_than_key_head_dim(cuda):
    """multihead_attention(t, t, t, 32, 2, kdim=8, vdim=16) through
    FFModel on the card: predict gives [2, 8, 32], and predict and three
    SGD steps through the kernels equal those through the plain
    attention from the same weights (fp32, atol 1e-4 + rtol 1e-4; the
    parameters within 1e-5)."""
    from flexflow_tpu_torch.config import FFConfig
    from flexflow_tpu_torch.core.types import LossType
    from flexflow_tpu_torch.model import FFModel
    from flexflow_tpu_torch.runtime import SGDOptimizer

    m = FFModel(FFConfig(batch_size=2), device=cuda)
    t = m.create_tensor((2, 8, 32))
    m.multihead_attention(t, t, t, 32, 2, kdim=8, vdim=16, name="attn")
    m.compile(optimizer=SGDOptimizer(lr=0.01), loss_type=LossType.MEAN_SQUARED_ERROR)
    ex = m.executor
    gen = torch.Generator().manual_seed(8)
    x, y = (torch.randn(4, 2, 8, 32, generator=gen).to(cuda) for _ in range(2))
    snap = {k: {n: p.detach().clone() for n, p in g.items()} for k, g in ex.params.items()}
    runs = {}
    for backend in ("auto", "plain"):
        with torch.no_grad():
            for k, g in ex.params.items():
                for n, p in g.items():
                    p.copy_(snap[k][n])
        ex.backend = backend
        fa.reset_launch_counts()
        out = m.predict(x[0])
        losses = [float(ex.train_batch([x[i]], y[i])["loss"]) for i in range(1, 4)]
        assert sum(fa.LAUNCHES.values()) == (10 if backend == "auto" else 0)
        runs[backend] = (out, losses, {k: {n: p.detach().clone() for n, p in g.items()}
                                       for k, g in ex.params.items()})
    (ok, lk, pk), (op, lp, pp) = runs["auto"], runs["plain"]
    assert ok.shape == (2, 8, 32)
    torch.testing.assert_close(ok, op, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(lk, lp, rtol=1e-5)
    for k in pk:
        for n in pk[k]:
            torch.testing.assert_close(pk[k][n], pp[k][n], atol=1e-5, rtol=0)


def test_cuda_model_and_engine_on_a_second_device(cuda):
    """An FFModel and a GenerationEngine on cuda:1 while the current
    device is 0: the flash kernels (the fp32 forward at D = 64 asks for
    more than 48 KB of shared memory) and the paged kernel's tensor-core
    body (an 11-token prompt) launch on cuda:1 after their first launches
    on cuda:0 raised the limit there, the step graphs capture and replay
    on cuda:1, and both match their plain versions. Needs two GPUs."""
    from flexflow_tpu_torch.config import FFConfig
    from flexflow_tpu_torch.core.types import LossType
    from flexflow_tpu_torch.generation.decoder import forward_full
    from flexflow_tpu_torch.model import FFModel
    from flexflow_tpu_torch.runtime import SGDOptimizer

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two GPUs")
    torch.cuda.set_device(0)
    one = torch.device("cuda:1")
    cfg = TransformerConfig(num_layers=2, hidden_size=128, num_heads=2, ff_size=256,
                            seq_length=64, vocab_size=97, causal=True)
    prompts = [list(range(3, 14)), [5, 1, 4]]
    for device in (cuda, one):  # first the current device, then the other
        m = FFModel(FFConfig(batch_size=2), device=device)
        t = m.create_tensor((2, 128, 128))
        m.multihead_attention(t, t, t, 128, 2, name="attn")
        m.compile(optimizer=SGDOptimizer(lr=0.01), loss_type=LossType.MEAN_SQUARED_ERROR)
        ex = m.executor
        gen = torch.Generator().manual_seed(4)
        x, y = (torch.randn(2, 128, 128, generator=gen).to(device) for _ in range(2))
        snap = {k: {n: p.detach().clone() for n, p in g.items()} for k, g in ex.params.items()}
        losses = {}
        for backend in ("auto", "plain"):
            with torch.no_grad():
                for k, g in ex.params.items():
                    for n, p in g.items():
                        p.copy_(snap[k][n])
            ex.backend = backend
            fa.reset_launch_counts()
            losses[backend] = float(ex.train_batch([x], y)["loss"])
            assert sum(fa.LAUNCHES.values()) == (3 if backend == "auto" else 0)
        np.testing.assert_allclose(losses["auto"], losses["plain"], rtol=1e-5)

        params = init_decoder_params(torch.Generator().manual_seed(5), cfg)
        engine = GenerationEngine(params, cfg, max_batch_slots=2, block_size=8,
                                  prompt_buckets=(8, 16, 32), device=device)
        da.reset_launch_counts()
        got = engine.generate(prompts, SamplingParams(max_new_tokens=6))
        assert da.LAUNCHES["paged_append"] > 0
        for prompt, stream in zip(prompts, got):
            seq = list(prompt)
            for _ in range(6):
                with torch.no_grad():
                    logits = forward_full(engine.params, torch.tensor([seq], device=device))
                seq.append(int(logits[0, -1].argmax()))
            assert stream == seq[len(prompt):]
        torch.cuda.synchronize(device)
        assert torch.cuda.current_device() == 0


@pytest.mark.parametrize("sq,d,causal", [(96, 512, False), (65, 512, True), (40, 300, False)])
def test_cuda_flash_kernels_past_head_dim_256(cuda, sq, d, causal):
    """fp32 forward, dQ and dK/dV at D = 512 (and a ragged D between 256
    and 512) against the plain versions."""
    gen = torch.Generator().manual_seed(sq + d)
    q, k, v, do = (torch.randn(2, sq, 2, d, generator=gen).to(cuda) for _ in range(4))
    scale = d ** -0.5
    o, lse = fa.flash_forward_kernel(q, k, v, causal, scale)
    po, plse = fa.reference_flash_forward(q, k, v, causal, scale)
    torch.testing.assert_close(o, po, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(lse, plse, atol=1e-4, rtol=1e-4)
    delta = fa.flash_delta(do, po)
    dq = fa.flash_backward_dq_kernel(q, k, v, do, plse, delta, causal, scale)
    dk, dv = fa.flash_backward_dkv_kernel(q, k, v, do, plse, delta, causal, scale)
    for got, want in zip((dq, dk, dv), fa.reference_flash_backward(q, k, v, do, plse, delta,
                                                                   causal, scale)):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("w", [1, 5, 40])
def test_cuda_paged_kernel_past_head_dim_256(cuda, w):
    """The paged append kernel at D = 512 (and D = 300) against its plain
    version, single-pass and split-KV."""
    for d in (512, 300):
        qpos = np.asarray([[60 + i for i in range(w)], [200 + i for i in range(w)]])
        args = _paged_case(cuda, qpos, 2, d, 16, 20, seed=w + d)
        _check_paged(args)
        _check_split(args, 4)


def test_cuda_engine_with_head_dim_512_streams_as_plain_attention(cuda):
    """A GenerationEngine at hidden 1024 with 2 heads (head dim 512): its
    greedy streams (captured graphs, the paged kernel) equal a greedy
    loop over the full forward with plain attention."""
    from flexflow_tpu_torch.generation.decoder import forward_full

    cfg = TransformerConfig(num_layers=2, hidden_size=1024, num_heads=2, ff_size=256,
                            seq_length=64, vocab_size=97, causal=True)
    params = init_decoder_params(torch.Generator().manual_seed(5), cfg)
    engine = GenerationEngine(params, cfg, max_batch_slots=2, block_size=8,
                              prompt_buckets=(8, 16, 32), device=cuda)
    prompts = [[3, 1, 4, 1, 5, 9, 2, 6], list(range(10, 30))]
    da.reset_launch_counts()
    got = engine.generate(prompts, SamplingParams(max_new_tokens=12))
    assert da.LAUNCHES["paged_append"] + da.LAUNCHES["paged_append_split"] > 0
    for prompt, stream in zip(prompts, got):
        seq = list(prompt)
        for _ in range(12):
            with torch.no_grad():
                logits = forward_full(engine.params, torch.tensor([seq], device=cuda))
            seq.append(int(logits[0, -1].argmax()))
        assert stream == seq[len(prompt):]


def test_cuda_wrappers_raise_instead_of_falling_back(cuda):
    q = torch.randn(1, 16, 1, 600, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q, q, q)
    q = torch.randn(1, 16, 1, 64, device=cuda, dtype=torch.float64)
    with pytest.raises(TypeError):
        fa.flash_attention(q, q, q)
    # the paged kernels take fp32 q over fp32, bf16 or fp16 caches of one
    # dtype: a bf16 q, mismatched caches or a float64 cache raise, with no
    # fallback and no launch
    args = _paged_case(cuda, np.asarray([[10]]), 2, 64, 16, 4, seed=3)
    q, k, v = args[:3]
    da.reset_launch_counts()
    for bad in ((q.bfloat16(), k.bfloat16(), v.bfloat16()),
                (q, k.bfloat16(), v.half()),
                (q, k.bfloat16(), v),
                (q, k.double(), v.double())):
        for splits in (1, 2):
            with pytest.raises(TypeError):
                da.paged_append_attention(*bad, *args[3:], kv_splits=splits)
    assert da.LAUNCHES == PAGED_NONE


# ---------------------------------------------------------------------------
# the engine's steps as CUDA graphs
# ---------------------------------------------------------------------------

GRAPH_CFG = TransformerConfig(num_layers=2, hidden_size=64, num_heads=4, ff_size=128,
                              seq_length=64, vocab_size=97, causal=True)


def _graph_and_eager_engines(cuda, slots=3):
    params = init_decoder_params(torch.Generator().manual_seed(3), GRAPH_CFG)
    kw = dict(max_batch_slots=slots, block_size=8, prompt_buckets=(8, 16, 32, 64),
              max_spec_tokens=4, device=cuda)
    return (GenerationEngine(params, GRAPH_CFG, **kw),
            GenerationEngine(params, GRAPH_CFG, eager_steps=True, **kw))


def test_cuda_step_graphs_replay_bit_identical_to_eager(cuda):
    """Prefill (three buckets), decode and verify steps replayed from
    their graphs give the eager steps' tokens and logits bit for bit,
    with one capture per signature and the paged kernel's launches
    counted per replay: num_layers per decode or verify step."""
    graph, eager = _graph_and_eager_engines(cuda)
    assert graph.graphs and not eager.graphs
    b, w, mb, layers = 3, graph.spec_window, graph.max_blocks_per_seq, GRAPH_CFG.num_layers
    prompts = [[1, 2, 3, 1, 2, 3, 1], list(range(5, 17)), list(range(20, 50))]
    sps = [SamplingParams(), SamplingParams(temperature=0.9, top_k=10, seed=21),
           SamplingParams(temperature=0.7, seed=2**31 + 5)]
    tables = np.zeros((b, mb), np.int32)
    tokens = np.zeros((b,), np.int32)
    for i, (p, sp) in enumerate(zip(prompts, sps)):
        blocks = graph.allocator.allocate(graph.cache_config.blocks_for(len(p) + 20))
        assert eager.allocator.allocate(len(blocks)) == blocks
        tables[i, : len(blocks)] = blocks
        tokens[i] = graph.prefill_one(p, blocks, sp, 0)
        assert eager.prefill_one(p, blocks, sp, 0) == tokens[i]
        assert torch.equal(graph.last_logits, eager.last_logits)
    positions = np.asarray([len(p) for p in prompts], np.int32)
    active = np.ones((b,), bool)
    temps = np.asarray([sp.temperature for sp in sps], np.float32)
    top_ks = np.asarray([sp.top_k for sp in sps], np.int32)
    seeds = np.asarray([sp.seed & 0xFFFFFFFF for sp in sps], np.uint32)
    for step in range(4):
        counts = np.full((b,), 1 + step, np.int32)
        da.reset_launch_counts()
        out = graph.decode(tokens, positions, tables, active, temps, top_ks, seeds, counts)
        if step > 0:  # a replay: the capture's launches, counted once
            assert da.LAUNCHES["paged_append"] == layers
        np.testing.assert_array_equal(
            out, eager.decode(tokens, positions, tables, active, temps, top_ks, seeds, counts))
        assert torch.equal(graph.last_logits, eager.last_logits)
        # past scratch block 0, whose duplicate padding writes land in any order
        assert torch.equal(graph.cache.k[:, 1:], eager.cache.k[:, 1:])
        assert torch.equal(graph.cache.v[:, 1:], eager.cache.v[:, 1:])
        tokens, positions = out.astype(np.int32), positions + 1
    for step, n_draft in enumerate(([2, 4, 0], [1, -1, 3], [4, 4, 4])):
        n_draft = np.asarray(n_draft, np.int32)
        window = np.zeros((b, w), np.int32)
        window[:, 0] = tokens
        window[:, 1:] = np.asarray([[5, 6, 7, 8]] * b)
        counts = np.full((b,), 10 + step, np.int32)
        args = (window, positions, n_draft, tables, temps, top_ks, seeds, counts)
        da.reset_launch_counts()
        out, n = graph.verify(*args)
        if step > 0:
            assert da.LAUNCHES["paged_append"] == layers
        eout, en = eager.verify(*args)
        np.testing.assert_array_equal(n, en)
        np.testing.assert_array_equal(out, eout)
        assert torch.equal(graph.last_logits, eager.last_logits)
        np.testing.assert_array_equal(graph.last_finite, eager.last_finite)
        positions = positions + np.where(n_draft >= 0, n, 0)
        tokens = out[np.arange(b), np.maximum(n - 1, 0)]
    assert graph.trace_counts == eager.trace_counts == {
        "prefill[8]": 1, "prefill[16]": 1, "prefill[32]": 1, "decode": 1, "verify": 1}


def test_cuda_speculative_streams_through_graphs_equal_eager_and_plain(cuda):
    """Through the scheduler: greedy streams with speculation equal the
    plain ones, and the graph engine's seeded speculative streams equal
    the eager engine's."""
    graph, eager = _graph_and_eager_engines(cuda, slots=4)
    prompts = [[1, 2, 3, 1, 2, 3, 1, 2], [4, 5] * 6, list(range(30, 47)), [7, 7, 7]]
    greedy = SamplingParams(max_new_tokens=20)
    spec = SpeculationConfig(k=4)
    plain = graph.generate(prompts, greedy)
    assert graph.generate(prompts, greedy, speculation=spec) == plain
    seeded = SamplingParams(max_new_tokens=20, temperature=0.8, top_k=20, seed=9)
    assert graph.generate(prompts, seeded, speculation=spec) == eager.generate(
        prompts, seeded, speculation=spec)
    assert graph.step_counts["verify"] > 0 and graph.recompiles() == {}
    sched = ContinuousBatchingScheduler(graph)
    da.reset_launch_counts()
    decode0, verify0 = graph.step_counts["decode"], graph.step_counts["verify"]
    hits0 = graph.prefix_cache.hits  # suffix prefills over the cached prompts
    handles = [sched.submit(p, greedy, speculation=spec) for p in prompts]
    while not all(h.done() for h in handles):
        sched.step()
    steps = (graph.step_counts["decode"] - decode0) + (graph.step_counts["verify"] - verify0)
    steps += graph.prefix_cache.hits - hits0
    assert da.LAUNCHES["paged_append"] == GRAPH_CFG.num_layers * steps
    assert [h.result(0) for h in handles] == plain


def test_cuda_prefix_prefill_replays_bit_identical_to_eager(cuda):
    """Suffix prefills over a cached prefix at four suffix buckets (the
    widest, 64 queries, two tiles of the paged kernel): each replayed
    ``prefix_prefill[W]`` step gives the eager step's token, logits and
    cache bit for bit, with one capture per bucket and num_layers paged
    launches per replay."""
    graph, eager = _graph_and_eager_engines(cuda)
    layers = GRAPH_CFG.num_layers
    rs = np.random.RandomState(7)
    sp = SamplingParams(temperature=0.8, top_k=20, seed=5)
    for prefix_len, n_suffix in ((8, 3), (16, 12), (8, 40), (16, 30), (8, 2)):
        prompt = rs.randint(0, GRAPH_CFG.vocab_size, prefix_len + n_suffix).tolist()
        blocks = graph.allocator.allocate(graph.cache_config.blocks_for(len(prompt) + 1))
        assert eager.allocator.allocate(len(blocks)) == blocks
        for e in (graph, eager):
            e.prefill_one(prompt[:prefix_len], blocks, sp, 0)
        da.reset_launch_counts()
        replays = f"prefix_prefill[{graph.bucket_for(n_suffix)}]" in graph.trace_counts
        token = graph.prefill_one(prompt, blocks, sp, 1, prefix_len=prefix_len)
        if replays:
            assert da.LAUNCHES["paged_append"] == layers
        assert eager.prefill_one(prompt, blocks, sp, 1, prefix_len=prefix_len) == token
        assert torch.equal(graph.last_logits, eager.last_logits)
        idx = torch.tensor(blocks, device=cuda)
        assert torch.equal(graph.cache.k[:, idx], eager.cache.k[:, idx])
        assert torch.equal(graph.cache.v[:, idx], eager.cache.v[:, idx])
        for e in (graph, eager):
            e.allocator.free(blocks)
    prefix_sigs = {k: v for k, v in graph.trace_counts.items() if k.startswith("prefix_prefill")}
    assert prefix_sigs == {"prefix_prefill[8]": 1, "prefix_prefill[16]": 1,
                           "prefix_prefill[32]": 1, "prefix_prefill[64]": 1} == {
        k: v for k, v in eager.trace_counts.items() if k.startswith("prefix_prefill")}


def test_cuda_block_copies_and_swap_in_write_the_cache_in_place(cuda):
    """The prefix cache's copy-on-write copy, swap-out read and swap-in
    write keep cache.k/cache.v where the captured graphs hold them, and
    through the scheduler an offloaded prefix swapped back in gives the
    uncached stream."""
    graph, eager = _graph_and_eager_engines(cuda)
    ptrs = (graph.cache.k.data_ptr(), graph.cache.v.data_ptr())
    gen = torch.Generator().manual_seed(1)
    graph.cache.k[:, 3] = torch.randn(graph.cache.k[:, 3].shape, generator=gen).to(cuda)
    graph.cache.v[:, 3] = torch.randn(graph.cache.v[:, 3].shape, generator=gen).to(cuda)
    graph._copy_block(3, 5)
    assert torch.equal(graph.cache.k[:, 5], graph.cache.k[:, 3])
    hk, hv = graph._read_block(5)
    graph._write_block(7, hk, hv)
    assert torch.equal(graph.cache.k[:, 7], graph.cache.k[:, 3])
    assert torch.equal(graph.cache.v[:, 7], graph.cache.v[:, 3])
    assert (graph.cache.k.data_ptr(), graph.cache.v.data_ptr()) == ptrs
    sp = SamplingParams(max_new_tokens=6)
    template = list(range(1, 17))
    ref = eager.generate([template + [30]], sp)
    graph.prefix_cache.swap_overhead_s = 0.0
    graph.generate([template + [20]], sp)
    assert graph.reclaim_cached(2) == 2 and graph.prefix_cache.offloaded_blocks == 2
    assert graph.generate([template + [30]], sp) == ref
    assert graph.prefix_cache.swaps_in_total == 2 and graph.prefix_cache.hits == 1
    assert (graph.cache.k.data_ptr(), graph.cache.v.data_ptr()) == ptrs


def test_cuda_engine_serves_a_41_token_verify_window(cuda):
    """max_spec_tokens = 40 constructs and serves on the card: the verify
    step (two query tiles of the paged kernel) replayed from its graph,
    greedy speculative streams equal to the plain ones, and seeded ones
    equal to an eager engine's."""
    params = init_decoder_params(torch.Generator().manual_seed(3), GRAPH_CFG)
    kw = dict(max_batch_slots=2, block_size=8, prompt_buckets=(8, 16, 32, 64),
              max_spec_tokens=40, device=cuda)
    graph = GenerationEngine(params, GRAPH_CFG, **kw)
    eager = GenerationEngine(params, GRAPH_CFG, eager_steps=True, **kw)
    assert graph.spec_window == 41
    prompts = [[1, 2, 3, 1, 2, 3, 1, 2], [4, 5] * 6]
    spec = SpeculationConfig(k=40)
    greedy = SamplingParams(max_new_tokens=20)
    assert graph.generate(prompts, greedy, speculation=spec) == graph.generate(prompts, greedy)
    seeded = SamplingParams(max_new_tokens=20, temperature=0.8, top_k=20, seed=4)
    assert graph.generate(prompts, seeded, speculation=spec) == eager.generate(
        prompts, seeded, speculation=spec)
    assert graph.step_counts["verify"] > 0 and graph.trace_counts["verify"] == 1


# ---------------------------------------------------------------------------
# the overlap pipeline's dispatch/collect and the engine's reset, on the card
# ---------------------------------------------------------------------------


def _decode_batch(engine, other):
    """Three prefilled sequences, the same blocks in ``engine`` and
    ``other``; returns the decode inputs of their first step."""
    b, mb = 3, engine.max_blocks_per_seq
    prompts = [[1, 2, 3, 1, 2, 3, 1], list(range(5, 17)), list(range(20, 50))]
    sps = [SamplingParams(), SamplingParams(temperature=0.9, top_k=10, seed=21),
           SamplingParams(temperature=0.7, seed=5)]
    tables = np.zeros((b, mb), np.int32)
    tokens = np.zeros((b,), np.int32)
    for i, (p, sp) in enumerate(zip(prompts, sps)):
        blocks = engine.allocator.allocate(engine.cache_config.blocks_for(len(p) + 20))
        assert other.allocator.allocate(len(blocks)) == blocks
        tables[i, : len(blocks)] = blocks
        tokens[i] = engine.prefill_one(p, blocks, sp, 0)
        assert other.prefill_one(p, blocks, sp, 0) == tokens[i]
    return dict(
        tokens=tokens, positions=np.asarray([len(p) for p in prompts], np.int32), tables=tables,
        active=np.ones((b,), bool), temps=np.asarray([sp.temperature for sp in sps], np.float32),
        top_ks=np.asarray([sp.top_k for sp in sps], np.int32),
        seeds=np.asarray([sp.seed for sp in sps], np.uint32))


def _args(x, step):
    return (x["positions"] + step, x["tables"], x["active"], x["temps"], x["top_ks"],
            x["seeds"], np.full((3,), 1 + step, np.int32))


def test_cuda_two_decode_steps_in_flight_equal_two_sequential_steps(cuda):
    """Step N+1 dispatched, its tokens carried on the device from step N,
    before either is collected: the tokens, the last logits and the cache
    equal two sequential host-fed steps of the eager engine."""
    graph, eager = _graph_and_eager_engines(cuda)
    x = _decode_batch(graph, eager)
    h1 = graph.decode_async(x["tokens"], *_args(x, 0))
    h2 = graph.decode_async(None, *_args(x, 1), carry=h1)
    t1 = graph.consume_decode(h1)
    t2 = graph.consume_decode(h2)
    r1 = eager.decode(x["tokens"], *_args(x, 0))
    r2 = eager.decode(r1, *_args(x, 1))
    np.testing.assert_array_equal(t1, r1)
    np.testing.assert_array_equal(t2, r2)
    assert torch.equal(graph.last_logits, eager.last_logits)
    assert torch.equal(graph.cache.k[:, 1:], eager.cache.k[:, 1:])
    assert torch.equal(graph.cache.v[:, 1:], eager.cache.v[:, 1:])
    assert graph.trace_counts["decode"] == 1


def test_cuda_staging_and_readback_buffers_are_not_clobbered(cuda):
    """Two steps of one signature in flight take the two pinned staging
    and readback buffers: the first step's staged inputs survive the
    second's packing, each readback lands in its own buffer, and a third
    dispatch before a collect raises."""
    graph, eager = _graph_and_eager_engines(cuda)
    x = _decode_batch(graph, eager)
    h1 = graph.decode_async(x["tokens"], *_args(x, 0))
    staged = h1.handle.step.host[h1.handle.slot].clone()
    h2 = graph.decode_async(x["tokens"] + 1, *_args(x, 5))
    step = h1.handle.step
    assert h1.handle.slot != h2.handle.slot and step.host[0].data_ptr() != step.host[1].data_ptr()
    assert torch.equal(step.host[h1.handle.slot], staged)
    assert step.readback[0].data_ptr() != step.readback[1].data_ptr()
    with pytest.raises(RuntimeError, match="in flight"):
        graph.decode_async(x["tokens"], *_args(x, 6))
    t1, t2 = graph.consume_decode(h1), graph.consume_decode(h2)
    np.testing.assert_array_equal(t1, eager.decode(x["tokens"], *_args(x, 0)))
    np.testing.assert_array_equal(t2, eager.decode(x["tokens"] + 1, *_args(x, 5)))


def test_cuda_token_carry_equals_a_host_fed_step(cuda):
    """A step whose tokens are carried from its predecessor on the device
    gives the tokens and logits of the same step fed those tokens from
    the host."""
    graph, eager = _graph_and_eager_engines(cuda)
    x = _decode_batch(graph, eager)
    h1 = graph.decode_async(x["tokens"], *_args(x, 0))
    t1 = graph.consume_decode(h1)
    carried = graph.consume_decode(graph.decode_async(None, *_args(x, 1), carry=h1))
    carried_logits = graph.last_logits.clone()
    host_fed = graph.decode(t1, *_args(x, 1))  # rewrites the same positions
    np.testing.assert_array_equal(carried, host_fed)
    assert torch.equal(carried_logits, graph.last_logits)


def test_cuda_reset_zeroes_the_cache_in_place_and_captures_nothing(cuda):
    """``reset()`` zeroes cache.k/cache.v where the graphs hold them,
    restores the allocator, and the replayed graphs then give the same
    streams again, capturing nothing again; a scheduler's crash on the card
    (``donate`` set) resets and replays the journal to the fault-free
    streams."""
    from flexflow_tpu_torch.runtime import faults

    graph, _ = _graph_and_eager_engines(cuda)
    prompts = [[1, 2, 3, 1, 2, 3, 1, 2], [4, 5] * 6, list(range(30, 47))]
    sp = SamplingParams(max_new_tokens=12, temperature=0.8, top_k=20, seed=9)
    ref = graph.generate(prompts, sp)
    ptrs, captures = (graph.cache.k.data_ptr(), graph.cache.v.data_ptr()), dict(graph.trace_counts)
    graph.reset()
    assert graph.resets == 1 and graph.donate
    assert (graph.cache.k.data_ptr(), graph.cache.v.data_ptr()) == ptrs
    assert not graph.cache.k.any() and not graph.cache.v.any()
    assert graph.allocator.num_free == graph.allocator.num_total
    assert graph.generate(prompts, sp) == ref
    sched = ContinuousBatchingScheduler(graph)
    plan = faults.FaultPlan(seed=0).on(faults.GENERATION_DECODE_STEP, mode="error",
                                       error=RuntimeError("crash"), nth=(4,))
    with plan.active():
        handles = [sched.submit(p, sp) for p in prompts]
        while not all(h.done() for h in handles):
            sched.step()
    assert [h.result(0) for h in handles] == ref
    assert graph.resets == 2 and sched.recovery_stats.recoveries == 1
    assert (graph.cache.k.data_ptr(), graph.cache.v.data_ptr()) == ptrs
    # the replay's prefills may take a new (suffix) signature, never a
    # second capture of one
    assert {k: graph.trace_counts[k] for k in captures} == captures and not graph.recompiles()


def test_cuda_pipelined_streams_equal_sequential_and_eager(cuda):
    """Through the scheduler on graph steps, overlap on and off, and on
    eager steps: identical streams, the pipeline engaged."""
    graph, eager = _graph_and_eager_engines(cuda, slots=2)
    prompts = [[1, 2, 3, 4, 5, 6, 7], list(range(5, 17)), list(range(20, 50)), [7, 7, 7]]
    sp = SamplingParams(max_new_tokens=20, temperature=0.8, top_k=20, seed=3)
    outs = []
    for engine, overlap in ((graph, True), (graph, False), (eager, True), (eager, False)):
        sched = ContinuousBatchingScheduler(engine, overlap=overlap)
        handles = [sched.submit(p, sp) for p in prompts]
        while not all(h.done() for h in handles):
            sched.step()
        outs.append([h.result(0) for h in handles])
        assert (sched.pipe_dispatches > 0) == overlap
    assert all(o == outs[0] for o in outs)


# ------------------------------------------------------------ grammar masks


def _grammars(vocab_size):
    from flexflow_tpu_torch.generation.constrained import (
        compile_response_format,
        default_vocabulary,
    )

    vocab = default_vocabulary(vocab_size)
    schema = {"type": "object",
              "properties": {"ok": {"type": "boolean"}, "n": {"type": "integer"}}}
    return vocab, [compile_response_format(s, vocab) for s in (
        {"type": "json_schema", "json_schema": schema},
        {"type": "regex", "pattern": "[a-z]{1,8}-[0-9]{2,4}"})]


def _mask_tensors(engine):
    return [m for m in (engine._mask1, engine._mask_dec, engine._mask_ver) if m is not None]


def test_cuda_masked_steps_replay_bit_identical_to_eager(cuda):
    """Prefill, decode and verify steps with grammar rows: each replay
    gives the eager step's tokens and logits bit for bit, with num_layers
    paged launches per replay, every sampled token allowed by its row,
    the mask tensors zero again after each step, and no capture beyond
    the unmasked steps' signatures."""
    graph, eager = _graph_and_eager_engines(cuda)
    vocab, (g_json, g_re) = _grammars(GRAPH_CFG.vocab_size)
    b, w, mb, layers = 3, graph.spec_window, graph.max_blocks_per_seq, GRAPH_CFG.num_layers
    rows = [g_json.mask_row(g_json.start, None), g_re.mask_row(g_re.start, None)]
    prompts = [[1, 2, 3, 1, 2, 3, 1], list(range(5, 17)), list(range(20, 50))]
    sps = [SamplingParams(), SamplingParams(temperature=0.9, top_k=40, seed=21),
           SamplingParams(temperature=0.7, seed=5)]
    tables = np.zeros((b, mb), np.int32)
    tokens = np.zeros((b,), np.int32)
    for i, (p, sp) in enumerate(zip(prompts, sps)):
        blocks = graph.allocator.allocate(graph.cache_config.blocks_for(len(p) + 20))
        assert eager.allocator.allocate(len(blocks)) == blocks
        tables[i, : len(blocks)] = blocks
        row = rows[i % 2]
        tokens[i] = graph.prefill_one(p, blocks, sp, 0, mask=row)
        assert eager.prefill_one(p, blocks, sp, 0, mask=row) == tokens[i]
        assert row[tokens[i]] == 0.0
        assert torch.equal(graph.last_logits, eager.last_logits)
        assert not any(m.any() for m in _mask_tensors(graph))
    positions = np.asarray([len(p) for p in prompts], np.int32)
    active = np.ones((b,), bool)
    temps = np.asarray([sp.temperature for sp in sps], np.float32)
    top_ks = np.asarray([sp.top_k for sp in sps], np.int32)
    seeds = np.asarray([sp.seed for sp in sps], np.uint32)
    for step in range(3):
        counts = np.full((b,), 1 + step, np.int32)
        mask = {0: rows[0], 1: rows[1]} if step != 1 else {2: rows[1]}
        da.reset_launch_counts()
        out = graph.decode(tokens, positions, tables, active, temps, top_ks, seeds, counts,
                           mask=mask)
        if step > 0:
            assert da.LAUNCHES["paged_append"] == layers
        assert not any(m.any() for m in _mask_tensors(graph))
        np.testing.assert_array_equal(out, eager.decode(
            tokens, positions, tables, active, temps, top_ks, seeds, counts, mask=mask))
        assert torch.equal(graph.last_logits, eager.last_logits)
        assert all(r[out[i]] == 0.0 for i, r in mask.items())
        tokens, positions = out.astype(np.int32), positions + 1
    window = np.zeros((b, w), np.int32)
    window[:, 0] = tokens
    window[:, 1:3] = 7
    n_draft = np.asarray([2, 0, 2], np.int32)
    vmask = {(0, 0): rows[0], (0, 1): rows[1], (2, 2): rows[0]}
    args = (window, positions, n_draft, tables, temps, top_ks, seeds, np.full((b,), 9, np.int32))
    for replay in (False, True):  # capture, then a replay
        da.reset_launch_counts()
        out, n = graph.verify(*args, mask=vmask)
        if replay:
            assert da.LAUNCHES["paged_append"] == layers
        eout, en = eager.verify(*args, mask=vmask)
        np.testing.assert_array_equal(n, en)
        np.testing.assert_array_equal(out, eout)
        assert torch.equal(graph.last_logits, eager.last_logits)
        assert not any(m.any() for m in _mask_tensors(graph))
    assert graph.trace_counts == eager.trace_counts == {
        "prefill[8]": 1, "prefill[16]": 1, "prefill[32]": 1, "decode": 1, "verify": 1}


def test_cuda_capture_survives_a_dead_engine_in_a_reference_cycle(cuda):
    """A graph engine that died in a reference cycle is collected before
    the next capture, not inside it (destroying its graphs there would
    invalidate the capture): with the cyclic collector at its most eager,
    a second engine still captures its steps and serves."""
    import gc

    params = init_decoder_params(torch.Generator().manual_seed(4), GRAPH_CFG)
    kw = dict(max_batch_slots=3, block_size=8, prompt_buckets=(8, 16, 32, 64), device=cuda)
    dead = GenerationEngine(params, GRAPH_CFG, **kw)
    want = dead.generate([[1, 2, 3]], SamplingParams(max_new_tokens=4))  # captures its graphs
    dead.cycle = dead  # unreachable now only to the cyclic collector
    del dead
    threshold = gc.get_threshold()
    gc.set_threshold(1)
    try:
        live = GenerationEngine(params, GRAPH_CFG, **kw)
        got = live.generate([[1, 2, 3]], SamplingParams(max_new_tokens=4))
    finally:
        gc.set_threshold(*threshold)
    assert got == want
    assert live.trace_counts["decode"] == 1


def test_cuda_unconstrained_replay_after_a_masked_step_equals_a_fresh_engine(cuda):
    """A masked sequential decode step leaves the mask tensors all zero:
    the pipelined unconstrained step dispatched straight after it gives
    the tokens and logits of the same step on an engine that never saw a
    grammar."""
    params = init_decoder_params(torch.Generator().manual_seed(3), GRAPH_CFG)
    kw = dict(max_batch_slots=3, block_size=8, prompt_buckets=(8, 16, 32, 64), device=cuda)
    masked, fresh = GenerationEngine(params, GRAPH_CFG, **kw), GenerationEngine(
        params, GRAPH_CFG, **kw)
    _, (g_json, _) = _grammars(GRAPH_CFG.vocab_size)
    x = _decode_batch(masked, fresh)
    row = g_json.mask_row(g_json.start, None)
    masked.decode(x["tokens"], *_args(x, 0), mask={0: row, 1: row, 2: row})
    fresh.decode(x["tokens"], *_args(x, 0))  # the same inputs: the same K/V writes
    for m in _mask_tensors(masked):
        torch.cuda.synchronize()
        assert not m.any()
    nxt = np.asarray([3, 4, 5], np.int32)
    got = masked.consume_decode(masked.decode_async(nxt, *_args(x, 1)))
    want = fresh.consume_decode(fresh.decode_async(nxt, *_args(x, 1)))
    np.testing.assert_array_equal(got, want)
    assert torch.equal(masked.last_logits, fresh.last_logits)
    assert masked.masked_step_count == 1 and fresh.masked_step_count == 0


def test_cuda_constrained_traffic_captures_nothing_and_reset_keeps_the_masks(cuda):
    """A graph engine warmed by unconstrained traffic (decode, verify,
    suffix prefills) serves constrained requests, pipeline on and off,
    with speculation and without, capturing nothing new; every
    constrained text parses; ``reset()`` zeroes the mask tensors where
    the graphs hold them."""
    from flexflow_tpu_torch.generation.constrained import decode_text, validate_json

    graph, _ = _graph_and_eager_engines(cuda)
    vocab, (g_json, g_re) = _grammars(GRAPH_CFG.vocab_size)
    prompts = [list(range(1, 12)), [4, 5], list(range(1, 12)) + [3]]
    sp = SamplingParams(max_new_tokens=40)
    spec = SpeculationConfig(k=4)

    def serve(grammars, overlap, speculation):
        sched = ContinuousBatchingScheduler(graph, overlap=overlap)
        handles = [sched.submit(p, sp, grammar=g, speculation=speculation)
                   for p, g in zip(prompts, grammars)]
        while not all(h.done() for h in handles):
            sched.step()
        return [h.result(0) for h in handles], sched

    for overlap, speculation in ((True, None), (False, spec)):
        graph.prefix_cache.reset()
        serve([None] * 3, overlap, speculation)
    captures = dict(graph.trace_counts)
    assert "verify" in captures and any(k.startswith("prefix_prefill") for k in captures)
    ptrs = [m.data_ptr() for m in _mask_tensors(graph)]
    streams = None
    for overlap, speculation in ((True, None), (False, None), (False, spec)):
        graph.prefix_cache.reset()
        outs, sched = serve([g_json, None, g_re], overlap, speculation)
        assert validate_json(decode_text(vocab, outs[0], None),
                             {"type": "object", "properties": {
                                 "ok": {"type": "boolean"}, "n": {"type": "integer"}}}) == []
        assert sched.constrained_stats.masked_steps > 0
        streams = streams or outs
        assert outs == streams
    assert graph.trace_counts == captures and not graph.recompiles()
    graph.reset()
    assert [m.data_ptr() for m in _mask_tensors(graph)] == ptrs
    assert not any(m.any() for m in _mask_tensors(graph))


# ------------------------------------------------------------ HTTP front end


def test_cuda_generation_model_over_http_gives_the_scheduler_streams(cuda):
    """A GenerationModel on the card behind the port's InferenceServer on
    loopback: JSON and SSE requests give the streams a scheduler over the
    same engine gives, the exposition is valid, and the HTTP traffic
    captures no new step graph."""
    import json
    import urllib.request

    from flexflow_tpu_torch.obs import validate_exposition
    from flexflow_tpu_torch.serving import GenerationModel, InferenceServer

    graph, _ = _graph_and_eager_engines(cuda, slots=2)
    prompts = [[1, 2, 3, 4, 5, 6, 7], list(range(5, 17)), list(range(20, 50))]
    sps = [dict(max_new_tokens=12), dict(max_new_tokens=12, temperature=0.8, top_k=20, seed=3),
           dict(max_new_tokens=12)]
    sched = ContinuousBatchingScheduler(graph)
    handles = [sched.submit(p, SamplingParams(**s)) for p, s in zip(prompts, sps)]
    while not all(h.done() for h in handles):
        sched.step()
    want = [h.result(0) for h in handles]
    graph.prefix_cache.reset()
    captures = dict(graph.trace_counts)
    srv = InferenceServer(port=0)
    srv.register_generation(GenerationModel(graph, name="lm"))
    srv.start()
    try:
        base = f"http://127.0.0.1:{srv.port}"
        got = []
        for i, (p, s) in enumerate(zip(prompts, sps)):
            body = json.dumps(dict(s, prompt=p, stream=bool(i % 2))).encode()
            req = urllib.request.Request(base + "/v2/models/lm/generate", data=body,
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                text = r.read().decode()
            if i % 2:
                got.append(json.loads(text.strip().split("\n\n")[-1][len("data: "):])["tokens"])
            else:
                got.append(json.loads(text)["tokens"])
        with urllib.request.urlopen(base + "/metrics", timeout=60) as r:
            assert validate_exposition(r.read().decode()) == []
    finally:
        srv.stop()
    assert got == want
    assert graph.trace_counts == captures and not graph.recompiles()


# ------------------------------------------------------------ window path
def _snapshot(tree):
    return {k: {n: t.detach().clone() for n, t in g.items()} for k, g in tree.items()}


def _trees_equal(a, b) -> bool:
    return all(torch.equal(a[k][n], b[k][n]) for k in a for n in a[k])


def _window_models(build, optimizer, loss):
    """Two compiled models of one graph from the same weights (the first
    model's, copied in): the window path's and the eager steps'."""
    from flexflow_tpu_torch.model import FFModel

    a = build()
    a.compile(optimizer=optimizer(), loss_type=loss)
    b = FFModel.from_graph(a.graph, a.config, seed=a._seed, device=a.device)
    b.compile(optimizer=optimizer(), loss_type=loss,
              outputs=b.output_tensors([(t.node.guid, t.idx) for t in a._outputs]))
    with torch.no_grad():
        for k, g in a.executor.params.items():
            for n, p in g.items():
                b.executor.params[k][n].copy_(p)
    return a, b


def _bert(cuda, dropout=0.1):
    from flexflow_tpu_torch.config import FFConfig
    from flexflow_tpu_torch.models import build_transformer

    return build_transformer(FFConfig(batch_size=4, seed=3),
                             TransformerConfig(num_layers=2, hidden_size=128, num_heads=2,
                                               ff_size=256, seq_length=32, dropout=dropout),
                             device=cuda)


def test_cuda_fit_window_replays_bit_identical_to_eager_steps(cuda):
    """``fit(trace_window=4)`` over 8 batches (two windows: a warm-up step
    and the capture, then 7 replays) against 8 ``train_batch`` calls with
    the same keys, from the same weights, with dropout: every loss and
    every parameter bit for bit (the same kernels in the same order), one
    capture, and the flash launches of 8 steps (replays counted)."""
    from flexflow_tpu_torch.core.types import LossType
    from flexflow_tpu_torch.runtime import SGDOptimizer

    a, b = _window_models(lambda: _bert(cuda), lambda: SGDOptimizer(lr=0.01),
                          LossType.MEAN_SQUARED_ERROR)
    gen = torch.Generator().manual_seed(2)
    x, y = (torch.randn(32, 32, 128, generator=gen).to(cuda) for _ in range(2))
    fa.reset_launch_counts()
    a.fit(x, y, batch_size=4, verbose=False, trace_window=4)
    assert a.executor.graph_captures == 1
    assert {k: n for k, n in fa.LAUNCHES.items() if n} == \
        {"flash_fwd": 16, "flash_bwd_dq": 16, "flash_bwd_dkv": 16}
    words = b._step_words(1, 8, 4)
    losses = [float(b.executor.train_batch([x[4 * i:4 * i + 4]], y[4 * i:4 * i + 4],
                                           rng=(words[i, 0], words[i, 1]))["loss"])
              for i in range(8)]
    assert a.step_losses == losses
    assert _trees_equal(a.executor.params, b.executor.params)


def test_cuda_repeated_eval_window_and_learning_rate_replay_as_eager(cuda):
    """Adam: ``train_batch_repeated`` (4 steps), then the rate changed and
    a ``train_window`` of 3 on the same geometry (no new capture), then
    ``eval_window``: against the eager steps with the same keys, bit for
    bit."""
    from flexflow_tpu_torch.core.types import LossType
    from flexflow_tpu_torch.generation import prng
    from flexflow_tpu_torch.runtime import AdamOptimizer

    a, b = _window_models(lambda: _bert(cuda, dropout=0.0), lambda: AdamOptimizer(alpha=1e-3),
                          LossType.MEAN_SQUARED_ERROR)
    gen = torch.Generator().manual_seed(3)
    x, y = (torch.randn(3, 4, 32, 128, generator=gen).to(cuda) for _ in range(2))
    key = prng.key(7)
    last = a.executor.train_batch_repeated([x[0]], y[0], key, 4)
    a.executor.set_learning_rate(5e-4)
    mets = a.executor.train_window([x], y, key)
    ev = a.executor.eval_window([x], y)
    assert a.executor.graph_captures == 2  # the train step and the eval step
    words = b.executor._split_words(key, 4)
    eager = [float(b.executor.train_batch([x[0]], y[0], rng=(w[0], w[1]))["loss"])
             for w in words]
    b.executor.set_learning_rate(5e-4)
    words = b.executor._split_words(key, 3)
    eager += [float(b.executor.train_batch([x[i]], y[i], rng=(words[i, 0], words[i, 1]))["loss"])
              for i in range(3)]
    assert float(last["loss"]) == eager[3] and mets["loss"].tolist() == eager[4:]
    assert _trees_equal(a.executor.params, b.executor.params)
    assert _trees_equal(a.executor.opt_state["m"], b.executor.opt_state["m"])
    assert ev["loss"].tolist() == [float(b.executor.eval_batch([x[i]], y[i])["loss"])
                                   for i in range(3)]


def _tiny_nmt(cuda):
    from flexflow_tpu_torch.config import FFConfig
    from flexflow_tpu_torch.models import build_nmt

    return build_nmt(FFConfig(batch_size=4, seed=5), src_vocab=50, tgt_vocab=50, embed_dim=16,
                     hidden_size=16, src_len=6, tgt_len=6, device=cuda)


def _tiny_dlrm(cuda):
    from flexflow_tpu_torch.config import FFConfig
    from flexflow_tpu_torch.models import build_dlrm

    return build_dlrm(FFConfig(batch_size=4, seed=6), embedding_sizes=(100,) * 3,
                      embedding_dim=8, embedding_bag_size=2, dense_dim=8, bottom_mlp=(16, 8),
                      top_mlp=(16, 1), device=cuda)


@pytest.mark.parametrize("model", ["nmt", "dlrm"])
def test_cuda_nmt_and_dlrm_windows_replay_as_eager(cuda, model):
    """The LSTM recurrence and the embedding lookups (their backward a
    scatter into the tables) inside a captured step: ``fit(trace_window=
    3)`` over 6 batches against ``train_batch`` with the same keys, bit
    for bit."""
    from flexflow_tpu_torch.core.types import LossType
    from flexflow_tpu_torch.runtime import SGDOptimizer

    build, loss = ((_tiny_nmt, LossType.SPARSE_CATEGORICAL_CROSSENTROPY) if model == "nmt"
                   else (_tiny_dlrm, LossType.MEAN_SQUARED_ERROR))
    a, b = _window_models(lambda: build(cuda), lambda: SGDOptimizer(lr=0.1), loss)
    gen = torch.Generator().manual_seed(9)
    if model == "nmt":
        xs = [torch.randint(0, 50, (24, 6), generator=gen, dtype=torch.int32) for _ in range(2)]
        y = torch.randint(0, 50, (24, 6), generator=gen, dtype=torch.int32)
    else:
        xs = [torch.randint(0, 100, (24, 2), generator=gen, dtype=torch.int32) for _ in range(3)]
        xs.append(torch.randn(24, 8, generator=gen))
        y = torch.rand(24, 1, generator=gen)
    xs, y = [t.to(cuda) for t in xs], y.to(cuda)
    a.fit(xs, y, verbose=False, trace_window=3)
    assert a.executor.graph_captures == 1
    words = b._step_words(1, 6, 3)
    losses = [float(b.executor.train_batch([t[4 * i:4 * i + 4] for t in xs], y[4 * i:4 * i + 4],
                                           rng=(words[i, 0], words[i, 1]))["loss"])
              for i in range(6)]
    assert a.step_losses == losses
    assert _trees_equal(a.executor.params, b.executor.params)


def test_cuda_a_capture_that_fails_raises(cuda):
    """A step body that syncs the host cannot be captured: the capture
    raises after the eager warm-up ran, and nothing is replayed."""
    from flexflow_tpu_torch.runtime.executor import _full_fp32
    from flexflow_tpu_torch.runtime.step_graph import StepGraph

    def body(inputs, label, key):
        s = inputs[0].sum()
        return {"loss": s * float(s)}  # float() waits for the device

    g = StepGraph(cuda, body, [torch.ones(4, device=cuda)], torch.zeros(1, device=cuda),
                  wrap=_full_fp32)
    with pytest.raises(RuntimeError):
        g.run()
    assert g.graph is None


def test_cuda_window_capture_is_one_trace_and_a_measured_pair(cuda):
    """On the card a window's capture is the executor program's trace: a
    fit of two windows registers ``train_window[4]`` once, captures once,
    and its second window joins the step prediction in the ledger."""
    from flexflow_tpu_torch.config import FFConfig
    from flexflow_tpu_torch.core.types import ActiMode, LossType
    from flexflow_tpu_torch.model import FFModel
    from flexflow_tpu_torch.obs.capacity import GLOBAL_PROGRAMS
    from flexflow_tpu_torch.obs.truth import GLOBAL_LEDGER
    from flexflow_tpu_torch.runtime import SGDOptimizer

    m = FFModel(FFConfig(batch_size=8))
    t = m.dense(m.create_tensor((8, 8)), 8, ActiMode.RELU)
    m.softmax(m.dense(t, 4))
    m.compile(optimizer=SGDOptimizer(lr=0.1), loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(64, 8, generator=gen).to(cuda)
    y = torch.randint(0, 4, (64,), generator=gen, dtype=torch.int32).to(cuda)
    m.fit(x, y, epochs=1, trace_window=4, verbose=False)
    ns = m.executor._prog_ns
    progs = {e["name"]: e for e in GLOBAL_PROGRAMS.snapshot() if e["name"].startswith(ns + ".")}
    assert set(progs) == {f"{ns}.train_window[4]"} and progs[f"{ns}.train_window[4]"]["traces"] == 1
    assert m.executor.graph_captures == 1
    entry = next(e for e in GLOBAL_LEDGER.report()["entries"] if e["key"] == f"{ns}.train_step")
    assert entry["predicted_s"] > 0 and entry["pairs"] == 1


def test_cuda_dataloader_gathers_natively_into_pinned_memory(cuda):
    import flexflow_tpu_torch._native as native
    from flexflow_tpu_torch.runtime.dataloader import SingleDataLoader

    data = torch.randn(40, 3, 5).to(torch.bfloat16)
    loader = SingleDataLoader(data, 8, shuffle=True, seed=2)
    native.reset_call_counts()
    order = np.random.RandomState(2).permutation(40)
    for i, b in enumerate(loader.batches()):
        assert b.device.type == "cuda"
        want = data[torch.from_numpy(order[i * 8:(i + 1) * 8])]
        assert torch.equal(b.cpu().view(torch.int16), want.view(torch.int16))
    assert native.CALLS["batch_gather"] == 5


def test_cuda_tensor_parallel_engine_over_nccl(cuda):
    """A tp=2 engine whose ranks sit on cuda:0 and cuda:1, its collectives
    over NCCL: greedy and seeded streams equal to the single-device
    engine's, each rank's paged kernel launched once a layer a decode
    step over its own heads. Needs two GPUs."""
    from flexflow_tpu_torch.parallel.mesh import serving_mesh

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two GPUs (NCCL cannot put two ranks of one communicator on "
                    "one device)")
    cfg = TransformerConfig(num_layers=2, hidden_size=128, num_heads=4, ff_size=256,
                            seq_length=64, vocab_size=97, causal=True)
    params = init_decoder_params(torch.Generator().manual_seed(5), cfg)
    prompts = [list(range(3, 14)), [5, 1, 4], [7] * 20]
    one = GenerationEngine(params, cfg, max_batch_slots=2, block_size=8, device=cuda)
    mesh = serving_mesh(2, ["cuda:0", "cuda:1"])
    assert mesh.backend == "nccl"
    tp = GenerationEngine(params, cfg, max_batch_slots=2, block_size=8, mesh=mesh)
    try:
        for samp in (SamplingParams(max_new_tokens=8),
                     SamplingParams(max_new_tokens=8, temperature=0.8, top_k=5, seed=3)):
            assert tp.generate(prompts, samp) == one.generate(prompts, samp)
        tp.reset_rank_counters()
        decode0 = tp.step_counts["decode"]
        tp.generate(prompts[:1], SamplingParams(max_new_tokens=6))
        steps = tp.step_counts["decode"] - decode0
        for info in tp.rank_info():
            assert info["cache_heads"] == 2
            assert info["launches"]["paged_append"] == cfg.num_layers * steps
    finally:
        tp.close()


def _dp_pair(mesh, cuda, seed=3):
    """A 2-layer encoder (2 heads of 64, seq 64) at batch 8 on one card
    and over ``mesh``'s ranks, from one graph and seed (the same initial
    weights)."""
    from flexflow_tpu_torch.config import FFConfig
    from flexflow_tpu_torch.core.types import LossType
    from flexflow_tpu_torch.model import FFModel
    from flexflow_tpu_torch.models import build_transformer
    from flexflow_tpu_torch.runtime import SGDOptimizer

    cfg = TransformerConfig(num_layers=2, hidden_size=128, num_heads=2, ff_size=256,
                            seq_length=64)
    one = build_transformer(FFConfig(batch_size=8, seed=seed), cfg, device=cuda)
    one.compile(optimizer=SGDOptimizer(lr=0.01), loss_type=LossType.MEAN_SQUARED_ERROR)
    two = FFModel.from_graph(one.graph, FFConfig(batch_size=8, seed=seed), mesh=mesh)
    two.compile(optimizer=SGDOptimizer(lr=0.01), loss_type=LossType.MEAN_SQUARED_ERROR,
                outputs=two.output_tensors([(t.node.guid, t.idx) for t in one._outputs]))
    return cfg, one, two


def _dp_steps(cfg, one, two, steps=2):
    """``steps`` steps of both models on the same batches: losses rtol
    1e-5, the ranks bit-identical, each rank's own flash launches."""
    from flexflow_tpu_torch.generation import prng

    gen = torch.Generator(device="cuda").manual_seed(11)
    xs = torch.randn(steps, 8, cfg.seq_length, cfg.hidden_size, generator=gen, device="cuda")
    ys = torch.randn(steps, 8, cfg.seq_length, cfg.hidden_size, generator=gen, device="cuda")
    want = [float(one.executor.train_batch([xs[s]], ys[s], rng=prng.key(s))["loss"])
            for s in range(steps)]
    two.executor.reset_rank_counters()
    got = [float(two.executor.train_batch([xs[s]], ys[s], rng=prng.key(s))["loss"])
           for s in range(steps)]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    info = two.executor.rank_info()
    assert len({i["params_sha"] for i in info}) == 1
    for i in info:
        for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            assert i["flash_launches"][k] == cfg.num_layers * steps
    return info


def test_cuda_data_parallel_two_ranks_share_one_card_over_gloo(cuda):
    """Two data-parallel ranks on cuda:0 over gloo (host-staged
    collectives): the losses of the one-card run, bit-identical ranks,
    each rank's flash kernels on its 4 rows."""
    from flexflow_tpu_torch.parallel.mesh import data_parallel_mesh

    mesh = data_parallel_mesh(2, ["cuda:0", "cuda:0"], backend="gloo")
    try:
        cfg, one, two = _dp_pair(mesh, cuda)
        info = _dp_steps(cfg, one, two)
        assert all(i["collectives"]["all_reduce"] == 2 for i in info)
        two.close()
    finally:
        mesh.close()


def test_cuda_data_parallel_training_over_nccl(cuda):
    """Two data-parallel ranks on cuda:0 and cuda:1, their collectives
    over NCCL (the default for distinct GPUs). Needs two GPUs."""
    from flexflow_tpu_torch.parallel.mesh import data_parallel_mesh

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two GPUs (NCCL cannot put two ranks of one communicator on "
                    "one device)")
    mesh = data_parallel_mesh(2)
    assert mesh.backend == "nccl"
    try:
        cfg, one, two = _dp_pair(mesh, cuda)
        _dp_steps(cfg, one, two)
        two.close()
    finally:
        mesh.close()


def _tp_pair(mesh, cuda, dp=1, seed=3):
    """The encoder of ``_dp_pair`` (2 heads of 64) on one card and under
    ``megatron_strategy(dp, tp=2)`` over ``mesh``'s ranks, from one graph
    and seed."""
    from flexflow_tpu_torch.config import FFConfig
    from flexflow_tpu_torch.core.types import LossType
    from flexflow_tpu_torch.model import FFModel
    from flexflow_tpu_torch.models import build_transformer
    from flexflow_tpu_torch.parallel.strategy import megatron_strategy
    from flexflow_tpu_torch.runtime import SGDOptimizer

    cfg = TransformerConfig(num_layers=2, hidden_size=128, num_heads=2, ff_size=256,
                            seq_length=64)
    one = build_transformer(FFConfig(batch_size=8, seed=seed), cfg, device=cuda)
    one.compile(optimizer=SGDOptimizer(lr=0.01), loss_type=LossType.MEAN_SQUARED_ERROR)
    two = FFModel.from_graph(one.graph, FFConfig(batch_size=8, seed=seed), mesh=mesh)
    two.compile(optimizer=SGDOptimizer(lr=0.01), loss_type=LossType.MEAN_SQUARED_ERROR,
                outputs=two.output_tensors([(t.node.guid, t.idx) for t in one._outputs]),
                strategy=megatron_strategy(one.graph, dp=dp, tp=2))
    return cfg, one, two


def _tp_steps(cfg, one, two, steps=2):
    """``steps`` steps of both models on the same batches: losses rtol
    1e-5, the gathered parameters within 1e-3 of the steps' largest
    update (the training phase's gate: float32 in another summation
    order), the ranks of one shard bit-identical, each rank's flash
    launches on its one head."""
    from flexflow_tpu_torch.generation import prng

    gen = torch.Generator(device="cuda").manual_seed(11)
    xs = torch.randn(steps, 8, cfg.seq_length, cfg.hidden_size, generator=gen, device="cuda")
    ys = torch.randn(steps, 8, cfg.seq_length, cfg.hidden_size, generator=gen, device="cuda")
    before = {k: {n: t.detach().clone() for n, t in g.items()}
              for k, g in one.executor.params.items()}
    want = [float(one.executor.train_batch([xs[s]], ys[s], rng=prng.key(s))["loss"])
            for s in range(steps)]
    two.executor.reset_rank_counters()
    got = [float(two.executor.train_batch([xs[s]], ys[s], rng=prng.key(s))["loss"])
           for s in range(steps)]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    whole = two.executor.whole_params()
    with torch.no_grad():
        moved = max(float((t - before[k][n]).abs().max())
                    for k, g in one.executor.params.items() for n, t in g.items())
        for k, g in one.executor.params.items():
            for n, t in g.items():
                assert float((whole[k][n] - t).abs().max()) <= 1e-3 * moved, (k, n)
    info = two.executor.rank_info()
    for m in {i["model_rank"] for i in info}:
        assert len({i["params_sha"] for i in info if i["model_rank"] == m}) == 1
    assert len({i["replicated_sha"] for i in info}) == 1
    for i in info:
        for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            assert i["flash_launches"][k] == cfg.num_layers * steps
            assert i["flash_launches_by_heads"][f"{k} H=1"] == cfg.num_layers * steps
    return info


def test_cuda_tensor_parallel_two_ranks_share_one_card_over_gloo(cuda):
    """``megatron_strategy(dp=1, tp=2)`` on two ranks sharing cuda:0 over
    gloo: the one-card run's losses and parameters, each rank's flash
    kernels on its one head of two."""
    from flexflow_tpu_torch.parallel.mesh import tensor_parallel_mesh

    mesh = tensor_parallel_mesh(2, devices=["cuda:0", "cuda:0"], backend="gloo")
    try:
        cfg, one, two = _tp_pair(mesh, cuda)
        _tp_steps(cfg, one, two)
        two.close()
    finally:
        mesh.close()


def test_cuda_tensor_parallel_training_over_nccl(cuda):
    """``megatron_strategy(dp=1, tp=2)`` on cuda:0 and cuda:1 over NCCL.
    Needs two GPUs."""
    from flexflow_tpu_torch.parallel.mesh import tensor_parallel_mesh

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two GPUs (NCCL cannot put two ranks of one communicator on "
                    "one device)")
    mesh = tensor_parallel_mesh(2)
    assert mesh.backend == "nccl"
    try:
        cfg, one, two = _tp_pair(mesh, cuda)
        _tp_steps(cfg, one, two)
        two.close()
    finally:
        mesh.close()
