"""The port's decoder, attention, cache and package boundary against the
JAX package.

Same weights (the JAX pytree converted with decoder_params_from_numpy),
same numpy tokens, through both packages: ``forward_full``, ``prefill``,
``decode_step`` and ``verify_step`` logits agree within atol 1e-5, the
JAX package's own tolerance for its forwards (tests/test_generation.py).
"""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.generation import decoder as jdec
from flexflow_tpu.generation.cache import (
    BlockAllocator as JBlockAllocator,
    CacheConfig as JCacheConfig,
    slot_mapping as jslot_mapping,
)
from flexflow_tpu.models.transformer import TransformerConfig as JTransformerConfig
from flexflow_tpu.ops.attention import masked_attention as jmasked_attention
from flexflow_tpu.ops.attention import reference_attention as jreference_attention
from flexflow_tpu_torch.generation import decoder as tdec
from flexflow_tpu_torch.generation.cache import BlockAllocator, CacheConfig, KVCache, slot_mapping
from flexflow_tpu_torch.generation.convert import decoder_params_from_numpy
from flexflow_tpu_torch.models.transformer import TransformerConfig
from flexflow_tpu_torch.ops.attention import masked_attention, reference_attention

pytestmark = pytest.mark.torch_port

CFG_KW = dict(
    num_layers=2, hidden_size=32, num_heads=4, ff_size=64,
    seq_length=64, vocab_size=50, causal=True,
)
CFG = TransformerConfig(**CFG_KW)
JCFG = JTransformerConfig(**CFG_KW)
BLOCK = 8
ATOL = 1e-5
REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def params():
    """(JAX params, the same weights as the port's params)."""
    jp = jdec.init_decoder_params(jax.random.key(0), JCFG)
    return jp, decoder_params_from_numpy(jax.tree.map(np.asarray, jp))


def _tokens(seed, shape):
    return np.random.RandomState(seed).randint(0, CFG.vocab_size, shape).astype(np.int32)


def _caches(num_blocks=12):
    shape = (CFG.num_layers, num_blocks, BLOCK, CFG.num_heads, CFG.hidden_size // CFG.num_heads)
    rs = np.random.RandomState(99)
    k = rs.randn(*shape).astype(np.float32)
    v = rs.randn(*shape).astype(np.float32)
    return k, v


# ---------------------------------------------------------------------------
# the four forwards
# ---------------------------------------------------------------------------


def test_forward_full_matches_jax(params):
    jp, tp = params
    toks = _tokens(0, (2, 13))
    lens = np.asarray([13, 9], np.int32)
    ref = np.asarray(jdec.forward_full(jp, jnp.asarray(toks), jnp.asarray(lens)))
    out = tdec.forward_full(tp, torch.from_numpy(toks), torch.from_numpy(lens)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
    ref = np.asarray(jdec.forward_full(jp, jnp.asarray(toks)))
    out = tdec.forward_full(tp, torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("prompt_len", [5, 8, 9, 16])
def test_prefill_matches_jax(params, prompt_len):
    """Bucketed (padded) prefill: logits and every layer's K/V."""
    jp, tp = params
    toks = np.zeros((1, 16), np.int32)
    toks[0, :prompt_len] = _tokens(prompt_len, (prompt_len,))
    lens = np.asarray([prompt_len], np.int32)
    jl, jk, jv = jdec.prefill(jp, jnp.asarray(toks), jnp.asarray(lens))
    tl, tk, tv = tdec.prefill(tp, torch.from_numpy(toks), torch.from_numpy(lens))
    assert tk.shape == jk.shape == (CFG.num_layers, 1, 16, CFG.num_heads, 8)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL, rtol=0)


def test_decode_step_matches_jax(params):
    """Three slots over caches with history: a live slot, a slot whose
    table holds scratch entries, and an inactive slot (context 0, table
    all scratch). Logits and the caches written in place agree."""
    jp, tp = params
    k, v = _caches()
    tables = np.asarray([[1, 2, 3, 4], [5, 6, 0, 0], [0, 0, 0, 0]], np.int32)
    positions = np.asarray([27, 11, 0], np.int32)
    ctx = np.asarray([28, 12, 0], np.int32)
    toks = _tokens(1, (3,))
    jl, jk, jv = jdec.decode_step(
        jp, *map(jnp.asarray, (toks, positions, k, v, tables, ctx)), backend="cpu"
    )
    tk, tv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    tl, tk2, tv2 = tdec.decode_step(
        tp, *map(torch.from_numpy, (toks, positions)), tk, tv,
        *map(torch.from_numpy, (tables, ctx)),
    )
    assert tk2 is tk and tv2 is tv  # written in place
    np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2], atol=ATOL, rtol=0)
    np.testing.assert_allclose(tk.numpy()[:, 1:], np.asarray(jk)[:, 1:], atol=ATOL, rtol=0)
    np.testing.assert_allclose(tv.numpy()[:, 1:], np.asarray(jv)[:, 1:], atol=ATOL, rtol=0)
    # the inactive slot attended to nothing: its logits are finite
    assert np.isfinite(tl.numpy()[2]).all()


def test_verify_step_matches_jax_and_sequential_decode(params):
    """A W = 4 window with padding slots: logits agree with JAX, and the
    real window tokens agree with W sequential decode steps."""
    jp, tp = params
    k, v = _caches()
    tables = np.asarray([[1, 2, 3, 4], [5, 6, 7, 0]], np.int32)
    positions = np.asarray([[20, 21, 22, 23], [9, 10, -1, -1]], np.int32)
    toks = _tokens(2, (2, 4))
    jl, jk, jv = jdec.verify_step(
        jp, *map(jnp.asarray, (toks, positions, k, v, tables)), backend="cpu"
    )
    tk, tv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    tl, _, _ = tdec.verify_step(tp, *map(torch.from_numpy, (toks, positions)), tk, tv,
                                torch.from_numpy(tables))
    real = positions >= 0
    np.testing.assert_allclose(tl.numpy()[real], np.asarray(jl)[real], atol=ATOL, rtol=0)
    np.testing.assert_allclose(tk.numpy()[:, 1:], np.asarray(jk)[:, 1:], atol=ATOL, rtol=0)
    # the same window, one decode step at a time
    sk, sv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    for j in range(4):
        active = real[:, j]
        step_pos = np.where(active, positions[:, j], 0).astype(np.int32)
        ctx = np.where(active, positions[:, j] + 1, 0).astype(np.int32)
        step_tables = np.where(active[:, None], tables, 0).astype(np.int32)
        dl, _, _ = tdec.decode_step(
            tp, torch.from_numpy(np.where(active, toks[:, j], 0).astype(np.int32)),
            torch.from_numpy(step_pos), sk, sv, torch.from_numpy(step_tables),
            torch.from_numpy(ctx),
        )
        np.testing.assert_allclose(
            dl.numpy()[active], tl.numpy()[active, j], atol=ATOL, rtol=0
        )


@pytest.mark.parametrize("prompt_len", [7, 8, 17])
def test_incremental_decode_matches_full_forward(params, prompt_len):
    """The port's own KV-cache contract: prefill into the cache, then
    every decode step's logits equal the full-context forward's."""
    _, tp = params
    cc = CacheConfig(num_layers=2, num_heads=4, head_dim=8, num_blocks=10, block_size=BLOCK)
    cache = KVCache.create(cc)
    blocks = torch.arange(1, 9, dtype=torch.int32)
    seq = _tokens(prompt_len + 30, (prompt_len,)).tolist()
    _, ks, vs = tdec.prefill(tp, torch.tensor([seq], dtype=torch.int32),
                             torch.tensor([prompt_len], dtype=torch.int32))
    slots = slot_mapping(blocks, torch.arange(prompt_len, dtype=torch.int32), BLOCK).long()
    for li in range(cc.num_layers):
        cache.k[li].view(-1, 4, 8)[slots] = ks[li, 0]
        cache.v[li].view(-1, 4, 8)[slots] = vs[li, 0]
    full = tdec.forward_full(tp, torch.tensor([seq], dtype=torch.int32))
    for _ in range(4):
        tok = int(torch.argmax(full[0, -1]))
        seq.append(tok)
        pos = len(seq) - 1
        logits, _, _ = tdec.decode_step(
            tp, torch.tensor([tok], dtype=torch.int32), torch.tensor([pos], dtype=torch.int32),
            cache.k, cache.v, blocks[None], torch.tensor([pos + 1], dtype=torch.int32),
        )
        full = tdec.forward_full(tp, torch.tensor([seq], dtype=torch.int32))
        np.testing.assert_allclose(logits[0].numpy(), full[0, -1].numpy(), atol=ATOL, rtol=0)


def test_init_decoder_params_shapes_match_jax():
    """The port's own initializer: the JAX pytree's keys and shapes,
    the same fan-in/fan-out bounds, seeded by a torch.Generator."""
    jp = jdec.init_decoder_params(jax.random.key(1), JCFG)
    tp = tdec.init_decoder_params(torch.Generator().manual_seed(1), CFG)
    tp2 = tdec.init_decoder_params(torch.Generator().manual_seed(1), CFG)
    assert set(tp) == set(jp)
    for key in ("tok_embed", "pos_embed", "lm_head", "final_ln_g"):
        assert tuple(tp[key].shape) == jp[key].shape
        assert torch.equal(tp[key], tp2[key])
    for tl, jl in zip(tp["layers"], jp["layers"]):
        assert set(tl) == set(jl)
        for key in jl:
            assert tuple(tl[key].shape) == jl[key].shape
            lim = float(np.abs(np.asarray(jl[key])).max())
            assert float(tl[key].abs().max()) <= max(lim * 1.1, 1.0)


def test_decoder_params_from_numpy_rejects_unknown_keys(params):
    jp, _ = params
    tree = jax.tree.map(np.asarray, jp)
    tree["extra"] = np.zeros(2)
    with pytest.raises(ValueError):
        decoder_params_from_numpy(tree)


# ---------------------------------------------------------------------------
# prefill attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal", [True, False])
def test_masked_attention_matches_jax(causal):
    """Including a sequence of length 0 (every row fully masked: zeros,
    not NaN) and padded keys."""
    rs = np.random.RandomState(4)
    q, k, v = (rs.randn(3, 6, 2, 8).astype(np.float32) for _ in range(3))
    lens = np.asarray([6, 3, 0], np.int32)
    ref = np.asarray(jmasked_attention(*map(jnp.asarray, (q, k, v, lens)), causal=causal))
    out = masked_attention(*map(torch.from_numpy, (q, k, v, lens)), causal=causal).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
    assert np.all(out[2] == 0.0)
    ref = np.asarray(jreference_attention(*map(jnp.asarray, (q, k, v)), causal=causal))
    out = reference_attention(*map(torch.from_numpy, (q, k, v)), causal=causal).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


# ---------------------------------------------------------------------------
# cache geometry and accounting
# ---------------------------------------------------------------------------


def test_slot_mapping_matches_jax():
    table = np.asarray([3, 7], np.int32)
    pos = np.asarray([0, 5, 9, 100], np.int32)
    out = slot_mapping(torch.from_numpy(table), torch.from_numpy(pos), 4).numpy()
    ref = np.asarray(jslot_mapping(jnp.asarray(table), jnp.asarray(pos), 4))
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, [12, 29, 0, 0])  # past the table: scratch
    # batched form == the JAX package's vmap over rows
    tables = np.asarray([[3, 7, 2], [5, 1, 0]], np.int32)
    pos = np.asarray([[0, 13, 40], [4, 9, 11]], np.int32)
    out = slot_mapping(torch.from_numpy(tables), torch.from_numpy(pos), 8).numpy()
    ref = np.asarray(jax.vmap(lambda t, p: jslot_mapping(t, p, 8))(tables, pos))
    np.testing.assert_array_equal(out, ref)


def test_block_allocator_matches_jax():
    cc = CacheConfig(num_layers=1, num_heads=2, head_dim=8, num_blocks=5, block_size=4)
    jcc = JCacheConfig(num_layers=1, num_heads=2, head_dim=8, num_blocks=5, block_size=4)
    alloc, jalloc = BlockAllocator(cc), JBlockAllocator(jcc)
    assert alloc.num_total == jalloc.num_total == 4  # block 0 is scratch
    a = alloc.allocate(3)
    assert a == jalloc.allocate(3) and 0 not in a
    assert alloc.allocate(2) is None  # atomic: no partial grab
    assert alloc.num_free == 1 and alloc.low_water == 1
    alloc.free(a)
    assert alloc.num_free == 4 and alloc.total_freed == 3
    with pytest.raises(ValueError):
        alloc.free(a[:1])  # double free
    with pytest.raises(ValueError):
        alloc.free([0])  # scratch is never allocatable


@pytest.mark.parametrize(
    "slots,max_seq,sharing", [(4, 1024, 0.0), (3, 64, 0.0), (4, 100, 0.5), (1, 900, 0.0)]
)
def test_cache_config_sizing_matches_jax(slots, max_seq, sharing):
    kw = dict(num_layers=12, num_heads=12, head_dim=64, max_seq_len=max_seq,
              max_batch_slots=slots, block_size=16, expected_prefix_sharing=sharing)
    cc, jcc = CacheConfig.for_slots(**kw), JCacheConfig.for_slots(**kw)
    assert cc.num_blocks == jcc.num_blocks
    assert cc.bytes_per_block == jcc.bytes_per_block
    assert cc.total_bytes == jcc.total_bytes
    assert cc.blocks_for(33) == jcc.blocks_for(33) == 3
    budget = dict(num_layers=2, num_heads=4, head_dim=8, block_size=16)
    assert (CacheConfig.from_budget(1 << 20, **budget).num_blocks
            == JCacheConfig.from_budget(1 << 20, **budget).num_blocks)
    assert (CacheConfig.from_budget(1 << 20, kv_shards=2, **budget).num_blocks
            == JCacheConfig.from_budget(1 << 20, kv_shards=2, **budget).num_blocks)
    with pytest.raises(ValueError):
        CacheConfig.from_budget(100, **budget)


def test_gpt2_small_cache_geometry():
    """The slice's full-width configuration: 4 slots of 1024 positions
    in 16-token blocks is 257 blocks (with scratch), about 0.3 GB."""
    cc = CacheConfig.for_slots(num_layers=12, num_heads=12, head_dim=64,
                               max_seq_len=1024, max_batch_slots=4)
    assert cc.num_blocks == 257
    assert 0.3e9 < cc.total_bytes < 0.31e9


# ---------------------------------------------------------------------------
# package boundary
# ---------------------------------------------------------------------------


def test_port_imports_neither_jax_nor_the_jax_package():
    """Import every module of flexflow_tpu_torch in a fresh interpreter:
    neither jax nor flexflow_tpu may be loaded."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import flexflow_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flexflow_tpu'))\n"
        "assert not bad, bad\n"
        "assert 'flexflow_tpu_torch.generation.scheduler' in names, names\n"
        "assert 'flexflow_tpu_torch.ops.kernels._build' in names, names\n"
        "assert 'flexflow_tpu_torch.generation.prefix' in names, names\n"
        "assert 'flexflow_tpu_torch.obs.capacity' in names, names\n"
        "print(len(names))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 14
