"""The port's speculative decoding against the JAX package.

Acceptance (``speculative_accept``, ``rejection_sample``), the window
keys, both drafters, the engine's verify step and the scheduler's
speculative streams run through both packages on the same numpy inputs,
seeds and converted weights: tokens and emitted counts identical, logits
within atol 1e-5 (fp32 summation order). Scheduler properties mirror
``tests/test_speculative.py`` on the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.generation import GenerationEngine as JGenerationEngine
from flexflow_tpu.generation import SamplingParams as JSamplingParams
from flexflow_tpu.generation import SpeculationConfig as JSpeculationConfig
from flexflow_tpu.generation import decoder as jdec
from flexflow_tpu.generation import init_decoder_params as jinit_decoder_params
from flexflow_tpu.generation.engine import derive_window_keys as jderive_window_keys
from flexflow_tpu.generation.scheduler import ContinuousBatchingScheduler as JScheduler
from flexflow_tpu.generation.speculative import DraftModelDrafter as JDraftModelDrafter
from flexflow_tpu.generation.speculative import NgramDrafter as JNgramDrafter
from flexflow_tpu.generation.speculative import rejection_sample as jrejection_sample
from flexflow_tpu.generation.speculative import residual_distribution as jresidual_distribution
from flexflow_tpu.generation.speculative import speculative_accept as jspeculative_accept
from flexflow_tpu.models.transformer import TransformerConfig as JTransformerConfig
from flexflow_tpu_torch.generation import (
    CacheConfig,
    ContinuousBatchingScheduler,
    GenerationEngine,
    NgramDrafter,
    SamplingParams,
    SpeculationConfig,
    decoder_params_from_numpy,
)
from flexflow_tpu_torch.generation import prng
from flexflow_tpu_torch.generation.engine import derive_window_keys
from flexflow_tpu_torch.generation.scheduler import Request
from flexflow_tpu_torch.generation.speculative import (
    DraftModelDrafter,
    build_drafter,
    rejection_sample,
    residual_distribution,
    speculative_accept,
)
from flexflow_tpu_torch.models.transformer import TransformerConfig

pytestmark = pytest.mark.torch_port

CFG_KW = dict(
    num_layers=2, hidden_size=32, num_heads=4, ff_size=64,
    seq_length=64, vocab_size=50, causal=True,
)
CFG_C_KW = dict(
    num_layers=1, hidden_size=48, num_heads=3, ff_size=96,
    seq_length=64, vocab_size=31, causal=True,
)
BUCKETS = (8, 16, 32, 64)
BLOCK = 8
LOGITS_ATOL = 1e-5


def _params(seed, cfg_kw=CFG_KW):
    jparams = jinit_decoder_params(jax.random.key(seed), JTransformerConfig(**cfg_kw))
    return jparams, decoder_params_from_numpy(jax.tree.map(np.asarray, jparams))


@pytest.fixture(scope="module")
def both_params():
    return _params(0)


def jengine(jparams, cfg_kw=CFG_KW, slots=3, block=BLOCK, cache_config=None, spec_k=4):
    return JGenerationEngine(
        jparams, JTransformerConfig(**cfg_kw), cache_config=cache_config,
        max_batch_slots=slots, block_size=block, prompt_buckets=BUCKETS,
        max_spec_tokens=spec_k, prefix_cache=False,
    )


def engine(params, cfg_kw=CFG_KW, slots=3, block=BLOCK, cache_config=None, spec_k=4):
    return GenerationEngine(
        params, TransformerConfig(**cfg_kw), cache_config=cache_config,
        max_batch_slots=slots, block_size=block, prompt_buckets=BUCKETS,
        max_spec_tokens=spec_k, device="cpu",
    )


def _jsp(sp):
    return JSamplingParams(max_new_tokens=sp.max_new_tokens, temperature=sp.temperature,
                           top_k=sp.top_k, eos_id=sp.eos_id, seed=sp.seed)


def _jspec(spec):
    return JSpeculationConfig(k=spec.k, method=spec.method, adaptive=spec.adaptive)


# ---------------------------------------------------------------------------
# keys and acceptance
# ---------------------------------------------------------------------------


def test_window_keys_and_their_draws_are_jax_bits():
    """derive_window_keys, the accept coins (uniform of fold_in(key, 1))
    and the residual/bonus Gumbel draws from the same keys as JAX's."""
    seeds = np.asarray([0, 1, 2**31, 2**32 - 1, 12345], np.uint32)
    counts = np.asarray([0, 7, 3, 1000, 2**20], np.int32)
    w, v = 5, 37
    jkeys = jderive_window_keys(jnp.asarray(seeds), jnp.asarray(counts), w)
    keys = derive_window_keys(torch.from_numpy(seeds.astype(np.int64)), torch.from_numpy(counts), w)
    jdata = np.asarray(jax.random.key_data(jkeys))
    np.testing.assert_array_equal(keys[0].numpy(), jdata[..., 0])
    np.testing.assert_array_equal(keys[1].numpy(), jdata[..., 1])
    coin = jax.vmap(jax.vmap(lambda k: jax.random.uniform(jax.random.fold_in(k, 1))))(jkeys)
    np.testing.assert_array_equal(prng.uniform(prng.fold_in(keys, 1), ()).numpy(), np.asarray(coin))
    res = jax.vmap(jax.vmap(lambda k: jax.random.gumbel(jax.random.fold_in(k, 2), (v,))))(jkeys)
    np.testing.assert_allclose(prng.gumbel(prng.fold_in(keys, 2), (v,)).numpy(),
                               np.asarray(res), rtol=1e-6, atol=1e-6)
    bonus = jax.vmap(jax.vmap(lambda k: jax.random.gumbel(k, (v,))))(jkeys)
    np.testing.assert_allclose(prng.gumbel(keys, (v,)).numpy(), np.asarray(bonus),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_speculative_accept_matches_jax(seed):
    """Greedy, temperature and top-k rows with 0, 1, 2, 3 and k = 4
    drafts, drafts the target likes (its argmax chain) and drafts it does
    not: the emitted tokens and counts are JAX's."""
    rs = np.random.RandomState(seed)
    b, w, v = 8, 5, 40
    logits = (rs.randn(b, w, v) * 3).astype(np.float32)
    greedy_chain = logits.argmax(-1)[:, :-1]
    drafts = np.where(rs.rand(b, w - 1) < 0.7, greedy_chain,
                      rs.randint(0, v, (b, w - 1))).astype(np.int32)
    n_draft = np.asarray([0, 2, 4, 1, 3, 4, 2, 4], np.int32)
    temps = np.asarray([0.0, 0.0, 0.0, 0.8, 1.2, 0.7, 1.0, 0.5], np.float32)
    top_ks = np.asarray([0, 5, 0, 0, 5, 3, 0, 10], np.int32)
    seeds = rs.randint(0, 2**32, b, dtype=np.int64).astype(np.uint32)
    counts = rs.randint(0, 500, b).astype(np.int32)
    jout, jn = jspeculative_accept(
        jnp.asarray(logits), jnp.asarray(drafts), jnp.asarray(n_draft), jnp.asarray(temps),
        jnp.asarray(top_ks), jderive_window_keys(jnp.asarray(seeds), jnp.asarray(counts), w),
    )
    out, n = speculative_accept(
        torch.from_numpy(logits), torch.from_numpy(drafts), torch.from_numpy(n_draft),
        torch.from_numpy(temps), torch.from_numpy(top_ks),
        derive_window_keys(torch.from_numpy(seeds.astype(np.int64)), torch.from_numpy(counts), w),
    )
    jout, jn = np.asarray(jout), np.asarray(jn)
    assert out.dtype == n.dtype == torch.int32
    np.testing.assert_array_equal(n.numpy(), jn)
    for i in range(b):
        np.testing.assert_array_equal(out[i, : jn[i]].numpy(), jout[i, : jn[i]])
    assert ((jn > 1) & (jn <= n_draft)).any() or (jn == n_draft + 1).any()


def test_rejection_sample_and_residual_match_jax():
    """The general min(1, p/q) rule with a soft proposal: tokens and
    accept flags equal to JAX's over 300 keys, residuals within 1e-7."""
    rs = np.random.RandomState(1)
    v, n = 6, 300
    p = np.array(jax.nn.softmax(jnp.asarray(rs.randn(v), jnp.float32)))
    q = np.array(jax.nn.softmax(jnp.asarray(rs.randn(v) * 2.0, jnp.float32)))
    drafts = rs.randint(0, v, n).astype(np.int32)
    seeds = rs.randint(0, 2**31, n).astype(np.int64)
    jtok, jacc = jax.vmap(lambda d, s: jrejection_sample(
        jnp.asarray(p), jnp.asarray(q), d, jax.random.key(s)))(
            jnp.asarray(drafts), jnp.asarray(seeds.astype(np.uint32)))
    pt, qt = torch.from_numpy(p).expand(n, v), torch.from_numpy(q).expand(n, v)
    tok, acc = rejection_sample(pt, qt, torch.from_numpy(drafts), prng.key(torch.from_numpy(seeds)))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    assert 0 < int(acc.sum()) < n
    # one step, no batch axis
    t0, a0 = rejection_sample(torch.from_numpy(p), torch.from_numpy(q),
                              torch.tensor(int(drafts[0])), prng.key(int(seeds[0])))
    assert (int(t0), bool(a0)) == (int(tok[0]), bool(acc[0]))
    np.testing.assert_allclose(
        residual_distribution(torch.from_numpy(p), torch.from_numpy(q)).numpy(),
        np.asarray(jresidual_distribution(jnp.asarray(p), jnp.asarray(q))), atol=1e-7)
    # q covering p everywhere: the residual falls back to p, never NaN
    np.testing.assert_array_equal(
        residual_distribution(torch.from_numpy(p), torch.from_numpy(p)).numpy(), p)


# ---------------------------------------------------------------------------
# drafters
# ---------------------------------------------------------------------------


def test_ngram_drafter_matches_jax():
    d, jd = NgramDrafter(max_ngram=3, min_ngram=1), JNgramDrafter(max_ngram=3, min_ngram=1)
    assert d.propose([1, 2, 3, 4, 5, 9, 1, 2], 3) == [3, 4, 5]
    assert d.propose([1, 2, 3, 1, 2, 7, 8, 1, 2], 2) == [7, 8]
    assert d.propose([1, 2, 3, 4, 5, 6], 4) == [] and d.propose([7], 4) == []
    rs = np.random.RandomState(0)
    for _ in range(300):
        prefix = rs.randint(0, 5, rs.randint(0, 40)).tolist()
        k = int(rs.randint(0, 6))
        assert d.propose(prefix, k) == jd.propose(prefix, k), (prefix, k)
    short = NgramDrafter(max_ngram=2, max_lookback=6)
    jshort = JNgramDrafter(max_ngram=2, max_lookback=6)
    seq = [1, 2, 9, 9, 9, 9, 9, 1, 2]
    assert short.propose(seq, 3) == jshort.propose(seq, 3)


def test_draft_model_drafter_matches_jax(both_params):
    """Greedy proposals of a draft decoder from the same weights, across
    the 8/16 bucket edges, equal JAX's; pure in the prefix."""
    jparams, params = _params(99)
    jd = JDraftModelDrafter(jparams, max_seq_len=64, buckets=BUCKETS)
    d = DraftModelDrafter(params, max_seq_len=64, buckets=BUCKETS)
    rs = np.random.RandomState(3)
    for n in (3, 7, 8, 15, 17):
        prefix = rs.randint(0, 50, n).tolist()
        out = d.propose(prefix, 3)
        assert len(out) == 3 and out == jd.propose(prefix, 3) == d.propose(prefix, 3)


def test_speculation_config_and_drafter_factory():
    with pytest.raises(ValueError):
        SpeculationConfig(k=0)
    with pytest.raises(ValueError):
        SpeculationConfig(method="tea-leaves")
    with pytest.raises(ValueError):
        SpeculationConfig(min_ngram=3, max_ngram=2)
    assert isinstance(build_drafter(SpeculationConfig()), NgramDrafter)
    with pytest.raises(ValueError, match="draft params"):
        build_drafter(SpeculationConfig(method="draft_model"))


def test_adaptive_k_shrinks_and_regrows():
    cfg = SpeculationConfig(k=4, low_acceptance=0.3, high_acceptance=0.8, ema_alpha=1.0)
    req = Request([1], SamplingParams(), speculation=cfg, drafter=NgramDrafter())
    assert req.spec_k == 4
    req.update_speculation(proposed=4, accepted=0)  # ema 0.0 -> shrink
    assert req.spec_k == 3
    for p in (3, 2, 1):
        req.update_speculation(proposed=p, accepted=0)
    assert req.spec_k == 1  # floor
    for _ in range(4):
        req.update_speculation(proposed=1, accepted=1)  # ema 1.0 -> grow
    assert req.spec_k == 4  # ceiling: back at config.k
    assert req.spec_proposed == 14 and req.spec_accepted == 4
    off = Request([1], SamplingParams(), speculation=SpeculationConfig(enabled=False),
                  drafter=NgramDrafter())
    assert off.speculation is None and off.drafter is None and off.spec_k == 0


# ---------------------------------------------------------------------------
# the engine's verify step
# ---------------------------------------------------------------------------


def _verify_args(b, w, mb, rows):
    """Slot-indexed verify arrays; rows: slot -> (window, start, n_draft,
    blocks, temp, top_k, seed, count); other slots inactive."""
    a = dict(window=np.zeros((b, w), np.int32), start=np.zeros((b,), np.int32),
             n_draft=np.full((b,), -1, np.int32), tables=np.zeros((b, mb), np.int32),
             temps=np.zeros((b,), np.float32), top_ks=np.zeros((b,), np.int32),
             seeds=np.zeros((b,), np.uint32), counts=np.zeros((b,), np.int32))
    for i, (win, start, nd, blocks, temp, top_k, seed, count) in rows.items():
        a["window"][i, : len(win)] = win
        a["start"][i], a["n_draft"][i] = start, nd
        a["tables"][i, : len(blocks)] = blocks
        a["temps"][i], a["top_ks"][i], a["seeds"][i], a["counts"][i] = temp, top_k, seed, count
    return a


def test_engine_verify_matches_jax_engine(both_params):
    """Two verify steps over three prefilled slots — greedy with 2 drafts,
    temperature/top-k with k = 4, an inactive slot (-1), then a zero-draft
    window — give JAX's tokens, emitted counts and finiteness, and logits
    within 1e-5 of the JAX forward at every real window position."""
    jparams, params = both_params
    jeng, eng = jengine(jparams), engine(params)
    b, w, mb = 3, eng.spec_window, eng.max_blocks_per_seq
    prompts = [[1, 2, 3, 1, 2, 3, 1], [5, 9, 4, 4, 7, 1, 2, 3, 8, 11], [7, 7, 7]]
    sps = [SamplingParams(), SamplingParams(temperature=0.9, top_k=10, seed=21),
           SamplingParams(temperature=0.7, seed=5)]
    blocks, first = [], []
    for p, sp in zip(prompts, sps):
        jb = jeng.allocator.allocate(jeng.cache_config.blocks_for(len(p) + 12))
        tb = eng.allocator.allocate(eng.cache_config.blocks_for(len(p) + 12))
        assert jb == tb
        blocks.append(tb)
        jt = jeng.prefill_one(p, jb, _jsp(sp), jax.random.fold_in(jax.random.key(sp.seed), 0))
        assert eng.prefill_one(p, tb, sp, 0) == jt
        first.append(jt)
    steps = [
        {0: ([first[0], 2, 3], len(prompts[0]), 2, blocks[0], 0.0, 0, 0, 1),
         1: ([first[1], 9, 4, 4, 7], len(prompts[1]), 4, blocks[1], 0.9, 10, 21, 1)},
        {0: ([first[0]], len(prompts[0]), 0, blocks[0], 0.0, 0, 0, 1),
         1: ([first[1], 1, 2], len(prompts[1]), 2, blocks[1], 0.9, 10, 21, 1),
         2: ([first[2]], len(prompts[2]), 0, blocks[2], 0.7, 0, 5, 1)},
    ]
    for rows in steps:
        a = _verify_args(b, w, mb, rows)
        snap = (jeng.cache.k, jeng.cache.v)
        jout, jn = jeng.verify(a["window"], a["start"], a["n_draft"], a["tables"], a["temps"],
                               a["top_ks"], a["seeds"], a["counts"])
        out, n = eng.verify(a["window"], a["start"], a["n_draft"], a["tables"], a["temps"],
                            a["top_ks"], a["seeds"], a["counts"])
        np.testing.assert_array_equal(n, jn)
        assert n[[i for i in range(b) if i not in rows]].tolist() == [0] * (b - len(rows))
        for i in rows:
            np.testing.assert_array_equal(out[i, : jn[i]], np.asarray(jout)[i, : jn[i]])
        np.testing.assert_array_equal(eng.last_finite, np.asarray(jeng.last_finite))
        offs = np.arange(w)[None, :]
        pos = np.where(offs <= a["n_draft"][:, None], a["start"][:, None] + offs, -1)
        jlogits, _, _ = jdec.verify_step(jparams, jnp.asarray(a["window"]), jnp.asarray(pos),
                                         snap[0], snap[1], jnp.asarray(a["tables"]))
        valid = pos >= 0
        np.testing.assert_allclose(eng.last_logits.numpy()[valid], np.asarray(jlogits)[valid],
                                   atol=LOGITS_ATOL, rtol=0)
    assert eng.trace_counts["verify"] == 1 and eng.step_counts["verify"] == 2


def test_wide_verify_window_matches_jax_engine(both_params):
    """max_spec_tokens = 40: a 41-token verify window (two tiles of the
    paged kernel on a card). Verify steps with 40, 23 and 0 drafts give
    the JAX engine's tokens and emitted counts, and logits within 1e-5 at
    every real window position; greedy speculative streams at k = 40 equal
    the JAX engine's and the plain ones."""
    jparams, params = both_params
    jeng, eng = jengine(jparams, slots=2, spec_k=40), engine(params, slots=2, spec_k=40)
    b, w, mb = 2, eng.spec_window, eng.max_blocks_per_seq
    assert w == 41 and jeng.spec_window == w
    rs = np.random.RandomState(40)
    prompts = [rs.randint(0, 50, 12).tolist(), rs.randint(0, 50, 19).tolist()]
    sps = [SamplingParams(), SamplingParams(temperature=0.8, top_k=12, seed=9)]
    blocks, first = [], []
    for p, sp in zip(prompts, sps):
        tb = eng.allocator.allocate(eng.cache_config.blocks_for(len(p) + w))
        assert jeng.allocator.allocate(len(tb)) == tb
        blocks.append(tb)
        jt = jeng.prefill_one(p, tb, _jsp(sp), jax.random.fold_in(jax.random.key(sp.seed), 0))
        assert eng.prefill_one(p, tb, sp, 0) == jt
        first.append(jt)
    greedy_chain = rs.randint(0, 50, 40).tolist()
    for n0, n1 in ((40, 23), (0, 40)):
        rows = {0: ([first[0]] + greedy_chain[:n0], len(prompts[0]), n0, blocks[0], 0.0, 0, 0, 1),
                1: ([first[1]] + greedy_chain[:n1], len(prompts[1]), n1, blocks[1], 0.8, 12, 9, 1)}
        a = _verify_args(b, w, mb, rows)
        snap = (jeng.cache.k, jeng.cache.v)
        args = (a["window"], a["start"], a["n_draft"], a["tables"], a["temps"], a["top_ks"],
                a["seeds"], a["counts"])
        jout, jn = jeng.verify(*args)
        out, n = eng.verify(*args)
        np.testing.assert_array_equal(n, jn)
        for i in rows:
            np.testing.assert_array_equal(out[i, : jn[i]], np.asarray(jout)[i, : jn[i]])
        offs = np.arange(w)[None, :]
        pos = np.where(offs <= a["n_draft"][:, None], a["start"][:, None] + offs, -1)
        jlogits, _, _ = jdec.verify_step(jparams, jnp.asarray(a["window"]), jnp.asarray(pos),
                                         snap[0], snap[1], jnp.asarray(a["tables"]))
        valid = pos >= 0
        np.testing.assert_allclose(eng.last_logits.numpy()[valid], np.asarray(jlogits)[valid],
                                   atol=LOGITS_ATOL, rtol=0)
    stream_prompts = [[1, 2, 3, 1, 2, 3, 1], [4, 5, 4, 5, 4, 5]]
    sp = SamplingParams(max_new_tokens=30)
    spec = engine(params, spec_k=40).generate(stream_prompts, sp,
                                              speculation=SpeculationConfig(k=40))
    assert spec == engine(params).generate(stream_prompts, sp)
    assert spec == jengine(jparams, spec_k=40).generate(
        stream_prompts, _jsp(sp), speculation=JSpeculationConfig(k=40), overlap=False)


@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_zero_draft_verify_samples_like_decode(both_params, temperature):
    """A zero-draft window samples exactly the token a decode step does."""
    _, params = both_params
    eng = engine(params)
    sp = SamplingParams(temperature=temperature, seed=5)
    prompt = [9, 8, 7, 6]
    blocks = eng.allocator.allocate(eng.cache_config.blocks_for(len(prompt) + 2))
    t0 = eng.prefill_one(prompt, blocks, sp, 0)
    snap = (eng.cache.k.clone(), eng.cache.v.clone())
    b, mb = eng.max_batch_slots, eng.max_blocks_per_seq
    a = _verify_args(b, eng.spec_window, mb,
                     {0: ([t0], len(prompt), 0, blocks, temperature, 0, 5, 1)})
    active = np.asarray([True] + [False] * (b - 1))
    tokens = np.where(active, t0, 0)
    positions = np.where(active, len(prompt), 0)
    via_decode = eng.decode(tokens, positions, a["tables"], active, a["temps"], a["top_ks"],
                            a["seeds"], a["counts"])[0]
    eng.cache.k.copy_(snap[0])  # in place: the cache tensors keep their storage
    eng.cache.v.copy_(snap[1])
    out, n = eng.verify(a["window"], a["start"], a["n_draft"], a["tables"], a["temps"],
                        a["top_ks"], a["seeds"], a["counts"])
    assert n[0] == 1 and out[0, 0] == via_decode


def test_max_spec_tokens_bounded_by_the_kernel_window(both_params):
    """The paged kernel takes any window (in tiles of 32 queries), so the
    engine takes any max_spec_tokens >= 1, as the JAX engine does."""
    _, params = both_params
    with pytest.raises(ValueError, match="max_spec_tokens"):
        engine(params, spec_k=0)
    for k in (31, 32, 40):
        assert engine(params, spec_k=k).spec_window == k + 1


# ---------------------------------------------------------------------------
# speculative streams through the scheduler
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cfg_kw", [CFG_KW, CFG_C_KW], ids=["cfg_a", "cfg_c"])
def test_greedy_speculative_streams_equal_plain_and_jax(cfg_kw):
    """Speculative greedy == non-speculative greedy == the JAX package's
    speculative stream; block size 4 puts windows across block edges,
    prompts straddle the bucket edges."""
    jparams, params = _params(1, cfg_kw)
    v = cfg_kw["vocab_size"]
    prompts = [[1, 2, 3, 1, 2, 3, 1], [4] * 8, list(range(2, 19)), [7, 7, 7]]
    prompts = [[t % v for t in p] for p in prompts]
    sp = SamplingParams(max_new_tokens=22)
    plain = engine(params, cfg_kw, block=4).generate(prompts, sp)
    spec_eng = engine(params, cfg_kw, block=4)
    spec = spec_eng.generate(prompts, sp, speculation=SpeculationConfig(k=4))
    assert spec == plain
    assert spec_eng.step_counts["verify"] > 0
    jspec = jengine(jparams, cfg_kw, block=4).generate(
        prompts, _jsp(sp), speculation=JSpeculationConfig(k=4), overlap=False)
    assert spec == jspec


def test_seeded_speculative_streams_match_jax_scheduler(both_params):
    """Temperature/top-k streams under speculation (same windows on both
    sides) are the JAX scheduler's token for token; a mixed batch with a
    plain greedy request too."""
    jparams, params = both_params
    prompts = [[1, 2, 1, 2, 1, 2, 1], [6, 7, 8, 9], [3, 4, 3, 4, 3, 4]]
    sps = [SamplingParams(max_new_tokens=12, temperature=0.9, top_k=12, seed=21),
           SamplingParams(max_new_tokens=12, temperature=1.1, seed=2**31 + 3),
           SamplingParams(max_new_tokens=12)]
    specs = [SpeculationConfig(k=3), SpeculationConfig(k=4, adaptive=False), None]

    def drive(sched, sub):
        handles = [sub(sched, p, sp, s) for p, sp, s in zip(prompts, sps, specs)]
        while any(not h.done() for h in handles):
            if not sched.step():
                break
        return [h.result(timeout=0) for h in handles]

    want = drive(JScheduler(jengine(jparams), overlap=False),
                 lambda s, p, sp, spec: s.submit(p, _jsp(sp),
                                                 speculation=None if spec is None else _jspec(spec)))
    sched = ContinuousBatchingScheduler(engine(params))
    got = drive(sched, lambda s, p, sp, spec: s.submit(p, sp, speculation=spec))
    assert got == want
    assert sched.spec_stats.windows > 0
    assert sched.spec_stats.accepted <= sched.spec_stats.proposed > 0


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_speculative_streams_match_jax_under_preemption(both_params, temperature):
    """Five usable blocks of 8 for two speculating sequences that need
    three each: the window cap drains step_k, then the scheduler preempts
    by recompute — on both packages alike, so the streams (greedy and
    seeded) are the JAX scheduler's; the allocator drains to the blocks
    the prefix cache holds (the stashed KV of the preempted sequence)."""
    jparams, params = both_params
    p1, p2 = [1, 2, 3, 4, 5, 6, 7], [9, 10, 11, 12, 13, 14, 15, 16]
    sp = SamplingParams(max_new_tokens=16, temperature=temperature, top_k=20, seed=7)
    spec = SpeculationConfig(k=3)
    geom = dict(num_layers=2, num_heads=4, head_dim=8, num_blocks=6, block_size=BLOCK)
    from flexflow_tpu.generation import CacheConfig as JCacheConfig

    jsched = JScheduler(jengine(jparams, slots=2, cache_config=JCacheConfig(**geom)),
                        overlap=False)
    jh = [jsched.submit(p, _jsp(sp), speculation=_jspec(spec)) for p in (p1, p2)]
    while any(not h.done() for h in jh):
        if not jsched.step():
            break
    tight = engine(params, slots=2, cache_config=CacheConfig(**geom))
    sched = ContinuousBatchingScheduler(tight)
    th = [sched.submit(p, sp, speculation=spec) for p in (p1, p2)]
    while any(not h.done() for h in th):
        if not sched.step():
            break
    assert [h.result(timeout=0) for h in th] == [h.result(timeout=0) for h in jh]
    assert sched.preemptions > 0 and sched.preemptions == jsched.preemptions
    assert tight.allocator.num_total - tight.allocator.num_free == (
        tight.prefix_cache.resident_blocks)


def test_verify_step_signature_runs_once_whatever_k(both_params):
    """Adaptive k, per-request k, batch recomposition and k clamping ride
    ONE verify signature (one graph on the card)."""
    _, params = both_params
    eng = engine(params)
    prompts = [[1, 2, 3, 1, 2, 3], [5] * 10, [9, 8, 7], [4, 5] * 6]
    for k in (1, 2, 4, 64):  # 64 clamps to the engine window
        eng.generate(prompts, SamplingParams(max_new_tokens=9),
                     speculation=SpeculationConfig(k=k, adaptive=(k % 2 == 0)))
    assert eng.trace_counts["verify"] == 1 and eng.trace_counts["decode"] == 1
    assert eng.recompiles() == {}


def test_mid_window_eos_truncates_exactly(both_params):
    _, params = both_params
    prompt = [1, 2, 3, 1, 2, 3]
    plain = engine(params).generate([prompt], SamplingParams(max_new_tokens=20))[0]
    eos = plain[7]
    ref = plain[: plain.index(eos) + 1]
    out = engine(params).generate([prompt], SamplingParams(max_new_tokens=20, eos_id=eos),
                                  speculation=SpeculationConfig(k=4))[0]
    assert out == ref and out.count(eos) == 1 and out[-1] == eos


def test_partial_acceptance_block_accounting_and_draft_model(both_params):
    """Windows across block edges with partial acceptance and a
    temperature mix leave the allocator exactly drained (to the blocks the
    prefix cache holds); a (wrong) draft model drafter changes no greedy
    token."""
    jparams, params = both_params
    eng = engine(params, block=4)
    sched = ContinuousBatchingScheduler(eng)
    rs = np.random.RandomState(2)
    handles = []
    for i in range(7):
        prompt = rs.randint(0, 50, rs.randint(3, 18)).tolist()
        sp = SamplingParams(max_new_tokens=int(rs.randint(1, 18)),
                            temperature=float(rs.choice([0.0, 0.9])), seed=i)
        spec = SpeculationConfig(k=int(rs.randint(1, 5))) if i % 3 else None
        handles.append(sched.submit(prompt, sp, speculation=spec))
    while any(not h.done() for h in handles):
        if not sched.step():
            break
    assert all(1 <= len(h.result(timeout=0)) <= 18 for h in handles)
    assert eng.allocator.num_total - eng.allocator.num_free == eng.prefix_cache.resident_blocks
    assert sched.spec_stats.accepted <= sched.spec_stats.proposed
    assert sched.spec_stats.emitted >= sched.spec_stats.accepted

    _, draft = _params(99)
    prompts = [[1, 2, 3, 4, 5, 6, 7, 8, 9], [10, 11, 12]]
    sp = SamplingParams(max_new_tokens=15)
    plain = engine(params).generate(prompts, sp)
    dsched = ContinuousBatchingScheduler(engine(params), draft_params=draft)
    hs = [dsched.submit(p, sp, speculation=SpeculationConfig(k=3, method="draft_model"))
          for p in prompts]
    while any(not h.done() for h in hs):
        if not dsched.step():
            break
    assert [h.result(timeout=0) for h in hs] == plain
    with pytest.raises(ValueError, match="draft params"):
        ContinuousBatchingScheduler(engine(params)).submit(
            [1, 2], SamplingParams(), speculation=SpeculationConfig(method="draft_model"))
