"""The port's paged decode/append attention against the JAX package.

Same numpy inputs through both packages: the port's plain PyTorch
versions (what its wrappers run for CPU tensors, and what the CUDA
kernels are held against on the card by chip_smoke.py) against the JAX
Pallas kernels in interpret mode and the JAX plain reference. Covers
both split modes (split counts past the heuristic's 8, up to one split
per table column, and counts that do not divide the table), W = 1 and
W = 5 windows, padding queries, inactive slots and block-table entries
that point at scratch block 0; and the split-KV CUDA kernel's plan of
blocks (:func:`split_plan`), whose column ranges are recombined here on
the CPU as the kernel recombines them on-chip.

Tolerance: atol 1e-5 on fp32 outputs of O(1) — the two packages sum in
different orders, nothing more.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.ops.kernels import decode_attention as jda
from flexflow_tpu_torch.ops.kernels import decode_attention as tda

pytestmark = pytest.mark.torch_port

ATOL = 1e-5


def _fixtures(seed, b, w, max_blocks, nb=33, bs=8, h=4, d=64):
    """Random caches, tables with some scratch (block 0) entries, and
    query positions with padding queries (-1); the last sequence of a
    batch of 3+ is an inactive slot (every query padding)."""
    rs = np.random.RandomState(seed)
    k_cache = rs.randn(nb, bs, h, d).astype(np.float32)
    v_cache = rs.randn(nb, bs, h, d).astype(np.float32)
    q = rs.randn(b, w, h, d).astype(np.float32)
    tables = rs.randint(1, nb, (b, max_blocks)).astype(np.int32)
    tables[:, -1] = 0  # a scratch entry at the end of every table
    tables[0, 0] = 0  # and one inside a live range
    qpos = []
    for i in range(b):
        base = int(rs.randint(0, max_blocks * bs - w))
        qpos.append([base + j if rs.rand() > 0.2 else -1 for j in range(w)])
    qpos = np.asarray(qpos, np.int32)
    if b >= 3:
        qpos[-1] = -1
    return q, k_cache, v_cache, tables, qpos


def _jax(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("kv_splits", [1, 4])
@pytest.mark.parametrize("w", [1, 5])
@pytest.mark.parametrize("d", [16, 64])
def test_paged_append_matches_jax(kv_splits, w, d):
    inputs = _fixtures(10 * w + kv_splits + d, 3, w, 12, d=d)
    ref = np.asarray(jda.reference_paged_append_attention(*_jax(*inputs)))
    ker = np.asarray(
        jda.paged_append_attention(*_jax(*inputs), interpret=True, kv_splits=kv_splits)
    )
    out = tda.paged_append_attention(*_torch(*inputs), kv_splits=kv_splits).numpy()
    np.testing.assert_allclose(out, ker, atol=ATOL, rtol=0)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
    pad = inputs[4] < 0
    assert pad.any()
    assert np.all(out[pad] == 0.0)  # padding queries: exact zeros, not NaN


@pytest.mark.parametrize(
    "b,w,max_blocks,splits",
    [(1, 1, 32, 8), (2, 4, 16, 3), (3, 5, 7, 4), (1, 3, 9, 2)],
)
def test_split_partials_recombine_to_reference(b, w, max_blocks, splits):
    """Every split count, including ones that do not divide the table
    (ragged last split) and more splits than blocks per split, gives the
    single-pass result; an empty split carries (acc=0, m=NEG_INF, l=0)."""
    inputs = _torch(*_fixtures(100 + b + w + splits, b, w, max_blocks))
    acc, m, l = tda.reference_paged_append_partials(*inputs, kv_splits=splits)
    assert acc.shape == (b, splits, w, 4, 64)
    assert m.shape == l.shape == (b, splits, 4, w)
    empty = l == 0
    assert torch.all(m[empty] == tda.NEG_INF)
    out = tda._combine_splits(acc, m, l, inputs[4], torch.float32)
    ref = tda.reference_paged_append_attention(*inputs)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=ATOL, rtol=0)


def _jax_split(inputs, kv_splits):
    return np.asarray(
        jda.paged_append_attention(*_jax(*inputs), interpret=True, kv_splits=kv_splits)
    )


@pytest.mark.parametrize("kv_splits,max_blocks", [(16, 64), (64, 64), (24, 40)])
def test_split_path_matches_jax_beyond_eight_splits(kv_splits, max_blocks):
    """More splits than default_kv_splits picks (at most 8): 16 over 64
    columns, one split per column, and 24 over 40 (splits of 2 columns,
    the last 4 splits past the table)."""
    inputs = _fixtures(kv_splits + max_blocks, 2, 1, max_blocks, nb=97, bs=4, d=16)
    out = tda.paged_append_attention(*_torch(*inputs), kv_splits=kv_splits).numpy()
    np.testing.assert_allclose(out, _jax_split(inputs, kv_splits), atol=ATOL, rtol=0)


@pytest.mark.parametrize("kv_splits", [5, 7, 11])
def test_split_path_window_with_padding_matches_jax(kv_splits):
    """W = 5 with padding queries and an all-padding sequence, at split
    counts that do not divide the 12-column table; padding queries give
    exact zeros."""
    inputs = _fixtures(200 + kv_splits, 3, 5, 12)
    pad = inputs[4] < 0
    assert pad.any() and pad[-1].all() and not pad[0].all()
    out = tda.paged_append_attention(*_torch(*inputs), kv_splits=kv_splits).numpy()
    np.testing.assert_allclose(out, _jax_split(inputs, kv_splits), atol=ATOL, rtol=0)
    assert np.all(out[pad] == 0.0)


def test_split_plan_takes_runs_of_whole_splits():
    """For every table width up to 80 and every split count the JAX
    wrapper accepts (1..MB, and more, which it clamps): at most 8 blocks,
    each a run of whole JAX splits, covering the table with a column in
    every block — the plan the CUDA launcher checks."""
    for mb in range(1, 81):
        for s in range(1, mb + 3):
            splits, bps = tda._clamp_splits(s, mb)
            ctas, cols = tda.split_plan(s, mb)
            assert 1 <= ctas <= tda.MAX_CLUSTER
            assert cols % bps == 0
            assert (ctas - 1) * cols < mb <= ctas * cols
            assert (ctas > 1) == (splits > 1)
    assert tda.split_plan(8, 64) == (8, 8)  # the long-context cell: one split a block
    assert tda.split_plan(16, 64) == tda.split_plan(64, 64) == (8, 8)
    assert tda.split_plan(24, 40) == (7, 6)  # 20 splits of 2 columns hold the table
    assert tda.split_plan(16, 64, max_ctas=16) == (16, 4)


@pytest.mark.parametrize("kv_splits,max_blocks", [(8, 64), (16, 64), (64, 64), (24, 40), (5, 12)])
def test_split_plan_ranges_recombine_to_jax(kv_splits, max_blocks):
    """The kernel's decomposition, on the CPU: each block's column range
    of split_plan attended alone (the partials of its slice of the table,
    positions shifted to it), then the blocks combined exactly, gives the
    JAX split path's output."""
    bs = 4
    inputs = _fixtures(300 + kv_splits, 2, 3, max_blocks, nb=97, bs=bs, d=16)
    q, kc, vc, bt, qp = _torch(*inputs)
    ctas, cols = tda.split_plan(kv_splits, max_blocks)
    parts = []
    for r in range(ctas):
        c0, c1 = r * cols, min((r + 1) * cols, max_blocks)
        parts.append(tda.reference_paged_append_partials(
            q, kc, vc, bt[:, c0:c1].contiguous(), qp - c0 * bs, kv_splits=1))
    acc, m, l = (torch.cat(x, dim=1) for x in zip(*parts))
    out = tda._combine_splits(acc, m, l, qp, torch.float32).numpy()
    np.testing.assert_allclose(out, _jax_split(inputs, kv_splits), atol=ATOL, rtol=0)


def test_combine_splits_matches_jax():
    """The plain combine on the same partials, including all-empty
    splits and a padding query."""
    rs = np.random.RandomState(3)
    b, s, w, h, d = 2, 4, 3, 2, 8
    acc = rs.randn(b, s, w, h, d).astype(np.float32)
    m = rs.randn(b, s, h, w).astype(np.float32)
    l = rs.rand(b, s, h, w).astype(np.float32) + 0.5
    m[:, 1] = jda.NEG_INF  # an empty split
    l[:, 1] = 0.0
    acc[:, 1] = 0.0
    m[1, :, :, 2] = jda.NEG_INF  # a query no split saw
    l[1, :, :, 2] = 0.0
    acc[1, :, 2] = 0.0
    qpos = np.asarray([[3, 4, 5], [7, 8, -1]], np.int32)
    ref = np.asarray(jda._combine_splits(*_jax(acc, m, l, qpos), jnp.float32))
    out = tda._combine_splits(*_torch(acc, m, l, qpos), torch.float32).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
    assert np.all(out[1, 2] == 0.0)


def test_decode_form_and_split_heuristic():
    """The W = 1 decode wrapper (context_lens, 0 = inactive slot) and
    the split heuristic, against the JAX package."""
    for batch, mb in [(1, 32), (2, 64), (8, 32), (1, 8), (1, 16), (4, 64), (1, 64)]:
        assert tda.default_kv_splits(batch, mb) == jda.default_kv_splits(batch, mb)
    q, k_cache, v_cache, tables, _ = _fixtures(5, 3, 1, 24)
    ctx = np.asarray([150, 40, 0], np.int32)
    ref = np.asarray(
        jda.reference_paged_attention(*_jax(q[:, 0], k_cache, v_cache, tables, ctx))
    )
    for splits in (None, 1, 4):
        out = tda.paged_decode_attention(
            *_torch(q[:, 0], k_cache, v_cache, tables, ctx), kv_splits=splits
        ).numpy()
        np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
        assert np.all(out[2] == 0.0)  # inactive slot -> zeros, not NaN
    plain = tda.reference_paged_attention(
        *_torch(q[:, 0], k_cache, v_cache, tables, ctx)
    ).numpy()
    np.testing.assert_allclose(plain, ref, atol=ATOL, rtol=0)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    """On the CPU the wrappers run the plain version; only a CUDA launch
    adds to a kernel's count."""
    inputs = _torch(*_fixtures(11, 2, 5, 8))
    tda.reset_launch_counts()
    for splits in (1, 2):
        tda.paged_append_attention(*inputs, kv_splits=splits)
    assert tda.LAUNCHES == {"paged_append": 0, "paged_append_split": 0}


def test_kernel_input_checks():
    """The checks the CUDA wrapper runs before handing pointers to the
    kernel refuse what the kernel does not take."""
    q, kc, vc, bt, qp = _torch(*_fixtures(12, 2, 5, 8))
    tda._check_kernel_inputs(q, kc, vc, bt, qp)  # the good case passes
    with pytest.raises(TypeError):
        tda._check_kernel_inputs(q.double(), kc, vc, bt, qp)
    with pytest.raises(TypeError):
        tda._check_kernel_inputs(q, kc, vc, bt.long(), qp)
    with pytest.raises(ValueError):
        tda._check_kernel_inputs(q.transpose(1, 2), kc, vc, bt, qp)  # wrong layout
    with pytest.raises(ValueError):
        wide = torch.zeros(2, 33, 4, 64)
        tda._check_kernel_inputs(wide, kc, vc, bt, torch.zeros(2, 33, dtype=torch.int32))
    with pytest.raises(ValueError):
        tda._check_kernel_inputs(q, kc[:, :, :, ::2], vc[:, :, :, ::2], bt, qp)
    with pytest.raises(ValueError):
        tda._check_kernel_inputs(q, kc, vc, bt[:, ::2], qp)  # non-contiguous table
    with pytest.raises(ValueError):
        tda.paged_append_attention(q.to("meta"), kc, vc, bt, qp)


def test_kernel_build_raises_without_nvcc_and_is_keyed_by_source():
    """The kernels build at first use only; without nvcc the build
    raises — there is no fallback to the plain version on a GPU."""
    from flexflow_tpu_torch.ops.kernels import _build

    digest = _build.source_digest()
    assert digest == _build.source_digest() and len(digest) == 16
    assert any(p.suffix == ".cu" for p in _build._sources())
    if _build.find_nvcc() is not None:
        pytest.skip("nvcc is installed here: the no-compiler path cannot be shown")
    assert {p.name for p in _build.kernel_sources()} >= {
        "paged_attention.cu", "flash_attention.cu"}
    for src in _build.kernel_sources():  # one library per source, keyed by it
        assert _build.source_digest(src) != digest
        assert _build.library_path(src).name.startswith(f"libff_{src.stem}_")
    if all(_build.library_path(src).exists() for src in _build.kernel_sources()):
        pytest.skip("built libraries for these sources are already present")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load_library()
