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
    assert fa.LAUNCHES == {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
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


def _paged_case(cuda, qpos, h, d, bs, mb, seed):
    """Random caches and tables for positions ``qpos`` [B, W]; block 0 is
    scratch, as in the engine's cache."""
    rs = np.random.RandomState(seed)
    b = qpos.shape[0]
    nb = b * mb + 1
    tables = rs.permutation(np.arange(1, nb))[:b * mb].reshape(b, mb).astype(np.int32)
    gen = torch.Generator().manual_seed(seed)
    k, v = (torch.randn(nb, bs, h, d, generator=gen).to(cuda) for _ in range(2))
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
    assert da.LAUNCHES == {"paged_append": 1, "paged_append_split": 0}
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


def _check_split(args, kv_splits):
    """The fused split kernel against the plain split + combine and the
    single-pass plain version: one launch, no single-pass launch."""
    da.reset_launch_counts()
    got = da.paged_append_attention(*args, kv_splits=kv_splits)
    assert da.LAUNCHES == {"paged_append": 0, "paged_append_split": 1}
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
    assert da.LAUNCHES == {"paged_append": 1, "paged_append_split": 0}
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


def test_cuda_wrappers_raise_instead_of_falling_back(cuda):
    q = torch.randn(1, 16, 1, 300, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q, q, q)
    q = torch.randn(1, 16, 1, 64, device=cuda, dtype=torch.float64)
    with pytest.raises(TypeError):
        fa.flash_attention(q, q, q)


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
