"""The port's cross-request prefix cache against the JAX package.

The JAX prefix-cache tests (``tests/test_prefix_cache.py``) at their own
small config, through both packages on the same converted weights:
streams with the cache on equal the JAX engine's and the port's own with
the cache off (greedy, seeded temperature, speculative), and the port's
``PrefixCache`` counters equal JAX's after each schedule. Then the
pieces: copy-on-write immutability, tier conservation over a randomized
admit / preempt / evict / swap schedule, the offload round trip, a
corrupted host copy detected and recomputed, the preemption stash,
``probe``, the disabled cache, the serving roofline the swap decision
reads, and the suffix-prefill step body run eagerly against the JAX
engine's ``_prefix_prefill_impl`` (token equal, logits within 1e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import FakeClock
from flexflow_tpu.generation import CacheConfig as JCacheConfig
from flexflow_tpu.generation import GenerationEngine as JGenerationEngine
from flexflow_tpu.generation import SamplingParams as JSamplingParams
from flexflow_tpu.generation import SpeculationConfig as JSpeculationConfig
from flexflow_tpu.generation import decoder as jdec
from flexflow_tpu.generation import init_decoder_params as jinit_decoder_params
from flexflow_tpu.generation.prefix import _crc as jcrc
from flexflow_tpu.generation.scheduler import ContinuousBatchingScheduler as JScheduler
from flexflow_tpu.models.transformer import TransformerConfig as JTransformerConfig
from flexflow_tpu.obs.capacity import ServingFlops as JServingFlops
from flexflow_tpu.search.calibration import chip_spec_for as jchip_spec_for
from flexflow_tpu_torch.generation import (
    CacheConfig,
    ContinuousBatchingScheduler,
    GenerationEngine,
    PackedBlock,
    SamplingParams,
    SpeculationConfig,
    decoder_params_from_numpy,
)
from flexflow_tpu_torch.models.transformer import TransformerConfig
from flexflow_tpu_torch.obs.capacity import CHIP_PRESETS, ServingFlops, chip_spec_for

pytestmark = pytest.mark.torch_port

CFG_KW = dict(
    num_layers=2, hidden_size=32, num_heads=4, ff_size=64,
    seq_length=64, vocab_size=50, causal=True,
)
BLOCK = 8
BUCKETS = (8, 16, 32, 64)
LOGITS_ATOL = 1e-5
COUNTERS = ("hits", "tokens_reused_total", "blocks_reused_total", "cow_copies_total",
            "swaps_in_total", "swaps_out_total")


@pytest.fixture(scope="module")
def both_params():
    jparams = jinit_decoder_params(jax.random.key(0), JTransformerConfig(**CFG_KW))
    return jparams, decoder_params_from_numpy(jax.tree.map(np.asarray, jparams))


def _geom(num_blocks, block_size):
    return dict(num_layers=CFG_KW["num_layers"], num_heads=CFG_KW["num_heads"],
                head_dim=CFG_KW["hidden_size"] // CFG_KW["num_heads"],
                num_blocks=num_blocks, block_size=block_size)


def engines(both_params, *, enabled=True, num_blocks=None, block_size=BLOCK, slots=3,
            host_bytes=None, spec_k=3):
    """(JAX engine, port engine) of the JAX test's make_engine."""
    jparams, params = both_params
    jcache = cache = None
    if num_blocks is not None:
        jcache = JCacheConfig(**_geom(num_blocks, block_size))
        cache = CacheConfig(**_geom(num_blocks, block_size))
    kw = dict(max_batch_slots=slots, block_size=block_size, prompt_buckets=BUCKETS,
              max_spec_tokens=spec_k, prefix_cache=enabled, host_cache_bytes=host_bytes)
    return (JGenerationEngine(jparams, JTransformerConfig(**CFG_KW), cache_config=jcache, **kw),
            GenerationEngine(params, TransformerConfig(**CFG_KW), cache_config=cache,
                             device="cpu", **kw))


def _jsp(sp):
    return JSamplingParams(max_new_tokens=sp.max_new_tokens, temperature=sp.temperature,
                           top_k=sp.top_k, eos_id=sp.eos_id, seed=sp.seed)


def jgenerate(jeng, prompts, sp, spec=None):
    return jeng.generate(prompts, _jsp(sp), overlap=False,
                         speculation=None if spec is None else JSpeculationConfig(
                             k=spec.k, method=spec.method))


def assert_counters_equal(jeng, eng):
    jsnap, snap = jeng.prefix_cache.snapshot(), eng.prefix_cache.snapshot()
    assert {k: snap[k] for k in COUNTERS} == {k: jsnap[k] for k in COUNTERS}, (snap, jsnap)
    for k in ("resident_blocks", "offloaded_blocks", "host_bytes", "recompute_fallbacks",
              "swap_in_failures", "registered_total", "evicted_total", "lookups"):
        assert snap[k] == jsnap[k], (k, snap, jsnap)


def assert_blocks_conserved(engine):
    """Every block out of the free list is owned by the prefix index."""
    used = engine.allocator.num_total - engine.allocator.num_free
    assert used == engine.prefix_cache.resident_blocks, (used, engine.prefix_cache.snapshot())


def assert_tiers_conserved(sched):
    rep = sched.cache_report()
    blocks, pc = rep["blocks"], rep["prefix_cache"]
    assert blocks["used"] + blocks["free"] == blocks["total"], blocks
    private = sum(r["blocks"] - r["shared_blocks"] for r in rep["residency"])
    assert private + pc["resident_blocks"] == blocks["used"], rep
    assert pc["shared_blocks"] <= pc["resident_blocks"]
    assert pc["offloaded_blocks"] * rep["config"]["bytes_per_block"] == pc["host_bytes"], pc
    assert pc["host_bytes"] <= pc["host_budget_bytes"] or pc["offloaded_blocks"] == 0


TEMPLATE = list(range(1, 18))  # 17 tokens: 2 full blocks + a partial


def _matrix_prompts():
    """Shared-template prompts crossing block (8) and bucket (8/16/32)
    boundaries, exact-cover repeats (the COW path) and a one-token
    divergence inside the boundary block."""
    return [
        TEMPLATE + [30, 31, 32],
        TEMPLATE + [33],
        list(TEMPLATE),
        list(TEMPLATE),
        TEMPLATE[:8] + [40, 41],
        TEMPLATE[:8],
        TEMPLATE[:16] + [42] * 17,
        [7, 7, 7],
    ]


SAMPLINGS = {
    "greedy": SamplingParams(max_new_tokens=9),
    "seeded_temperature": SamplingParams(max_new_tokens=9, temperature=0.8, top_k=10, seed=42),
}


@pytest.mark.parametrize("mode", ["greedy", "seeded_temperature", "speculative"])
def test_exactness_matrix_on_off(both_params, mode):
    """Streams with the cache on equal the port's with it off and the JAX
    engine's with it on; reuse happened, and the counters are JAX's."""
    spec = SpeculationConfig(k=3) if mode == "speculative" else None
    sp = SAMPLINGS.get(mode, SAMPLINGS["greedy"])
    prompts = _matrix_prompts()
    jon, on = engines(both_params, enabled=True)
    _, off = engines(both_params, enabled=False)
    want = jgenerate(jon, prompts, sp, spec)
    assert off.generate(prompts, sp, speculation=spec) == want
    assert on.generate(prompts, sp, speculation=spec) == want
    pc = on.prefix_cache
    assert pc.hits >= 4 and pc.tokens_reused_total > 0 and pc.cow_copies_total >= 1
    assert_counters_equal(jon, on)
    assert on.trace_counts["decode"] == 1
    if mode == "speculative":
        assert on.trace_counts["verify"] == 1
    # one signature per suffix bucket, as the JAX engine traces one program each
    assert {k: v for k, v in on.trace_counts.items() if k.startswith("prefix_prefill")} == {
        k: v for k, v in jon.trace_counts.items() if k.startswith("prefix_prefill")}
    assert_blocks_conserved(on)


def test_cow_keeps_shared_block_immutable(both_params):
    """A fully covered prompt (16 tokens: reuse stops at 15, inside the
    second block) copies the boundary block; the shared original keeps
    its content over three repeats, and the references drain."""
    jeng, eng = engines(both_params)
    sp = SamplingParams(max_new_tokens=6)
    prompt = TEMPLATE[:16]
    outs = []
    for i in range(3):
        outs.append(eng.generate([list(prompt)], sp)[0])
        assert outs[-1] == jgenerate(jeng, [list(prompt)], sp)[0]
        assert eng.prefix_cache.cow_copies_total == i
        if i == 0:
            shared = {e.block: (eng.cache.k[:, e.block].clone(), eng.cache.v[:, e.block].clone())
                      for e in eng.prefix_cache._by_id.values()}
    assert outs[0] == outs[1] == outs[2]
    for block, (k, v) in shared.items():  # the shared blocks were never written
        assert torch.equal(eng.cache.k[:, block], k) and torch.equal(eng.cache.v[:, block], v)
    assert eng.prefix_cache.snapshot()["shared_blocks"] == 0
    assert_counters_equal(jeng, eng)
    assert_blocks_conserved(eng)


def _random_schedule(sched, submit, seed):
    """The JAX test's randomized shared-template schedule over a tiny
    cache; returns the handles and checks ``each_step`` after every step."""
    rs = np.random.RandomState(seed)
    templates = [list(range(1, 13)), list(range(20, 32))]
    handles = []
    for _ in range(140):
        if len(handles) < 12 and rs.rand() < 0.4:
            template = templates[len(handles) % 2]
            prompt = template[: int(rs.choice([8, 12, 12]))] + rs.randint(
                0, CFG_KW["vocab_size"], int(rs.randint(1, 4))).tolist()
            handles.append(submit(prompt, SamplingParams(max_new_tokens=int(rs.randint(1, 8))),
                                  rs.rand() < 0.4))
        yield
        sched.step()
    for _ in range(400):
        if all(h.done() for h in handles):
            break
        yield
        if not sched.step():
            break
    assert all(h.done() for h in handles)
    return [h.result(timeout=0) for h in handles]


def _drive(gen, each_step=lambda: None):
    try:
        while True:
            next(gen)
            each_step()
    except StopIteration as stop:
        return stop.value


def test_conservation_with_tiers_randomized(both_params):
    """Admit, preempt, evict to the host, swap in and copy under pressure:
    private + resident + free account for every block and the host bytes
    for every offloaded block at every step; the streams and counters are
    the JAX scheduler's on the same schedule."""
    jeng, eng = engines(both_params, num_blocks=8, block_size=4)
    for e in (jeng, eng):
        e.prefix_cache.swap_overhead_s = 0.0  # transfer always beats recompute
    spec = SpeculationConfig(k=2)
    jspec = JSpeculationConfig(k=2)
    jsched = JScheduler(jeng, overlap=False, clock=FakeClock())
    want = _drive(_random_schedule(jsched, lambda p, sp, s: jsched.submit(
        p, _jsp(sp), speculation=jspec if s else None), 11))
    sched = ContinuousBatchingScheduler(eng, clock=FakeClock())
    got = _drive(_random_schedule(sched, lambda p, sp, s: sched.submit(
        p, sp, speculation=spec if s else None), 11), lambda: assert_tiers_conserved(sched))
    assert got == want
    snap = eng.prefix_cache.snapshot()
    assert snap["swaps_out_total"] > 0 and snap["swaps_in_total"] > 0 and snap["hits"] > 0
    assert sched.preemptions == jsched.preemptions
    assert_counters_equal(jeng, eng)
    assert_tiers_conserved(sched)
    assert_blocks_conserved(eng)
    alloc = eng.allocator
    assert alloc.total_allocated == alloc.total_freed + eng.prefix_cache.resident_blocks


def test_offload_swap_in_roundtrip_exact(both_params):
    """Blocks evicted to the host swap back in (the transfer beats the
    recompute) and the stream is the uncached one."""
    sp = SamplingParams(max_new_tokens=6)
    _, off = engines(both_params, enabled=False)
    ref = off.generate([TEMPLATE[:16] + [30]], sp)
    jeng, eng = engines(both_params)
    for e in (jeng, eng):
        e.prefix_cache.swap_overhead_s = 0.0
    eng.generate([TEMPLATE[:16] + [20]], sp)  # warm: 2 blocks registered
    jgenerate(jeng, [TEMPLATE[:16] + [20]], sp)
    assert eng.prefix_cache.resident_blocks == 2
    k_before = eng.cache.k.data_ptr()
    assert eng.reclaim_cached(2) == 2 and jeng.reclaim_cached(2) == 2
    pc = eng.prefix_cache
    assert pc.offloaded_blocks == 2 and pc.resident_blocks == 0
    assert pc.host_bytes == 2 * eng.cache_config.bytes_per_block
    tiers = [{k: r[k] for k in ("depth", "tier", "block", "refs")} for r in pc.tier_residency()]
    assert tiers == [{k: r[k] for k in ("depth", "tier", "block", "refs")}
                     for r in jeng.prefix_cache.tier_residency()]
    assert [r["tier"] for r in tiers] == ["host", "host"]
    assert eng.generate([TEMPLATE[:16] + [30]], sp) == ref
    assert jgenerate(jeng, [TEMPLATE[:16] + [30]], sp) == ref
    assert [r["tier"] for r in pc.tier_residency()] == ["device"] * 2
    assert pc.swaps_in_total == 2
    assert eng.cache.k.data_ptr() == k_before  # written in place
    assert_counters_equal(jeng, eng)


def test_corrupted_host_block_detected_and_recomputed(both_params):
    """A host copy whose bytes were flipped fails its CRC at swap-in: the
    entry is dropped and the suffix recomputed — the uncached stream,
    never garbage — on both packages alike."""
    sp = SamplingParams(max_new_tokens=6)
    _, off = engines(both_params, enabled=False)
    ref = off.generate([TEMPLATE[:16] + [30]], sp)
    jeng, eng = engines(both_params)
    for e in (jeng, eng):
        e.prefix_cache.swap_overhead_s = 0.0
    eng.generate([TEMPLATE[:16] + [20]], sp)
    jgenerate(jeng, [TEMPLATE[:16] + [20]], sp)
    eng.reclaim_cached(2)
    jeng.reclaim_cached(2)
    victim = next(e for e in eng.prefix_cache._by_id.values() if not e.resident)
    jvictim = next(e for e in jeng.prefix_cache._by_id.values() if not e.resident)
    assert victim.depth == jvictim.depth
    victim.host.host_k = victim.host.host_k.copy()
    victim.host.host_k.flat[0] += 1.0
    jvictim.host_k = jvictim.host_k.copy()
    jvictim.host_k.flat[0] += 1.0
    assert not victim.host.verify()
    assert eng.generate([TEMPLATE[:16] + [30]], sp) == ref
    assert jgenerate(jeng, [TEMPLATE[:16] + [30]], sp) == ref
    assert eng.prefix_cache.swap_in_failures >= 1
    assert victim.host is None  # the corrupt copy is dropped, not retried
    assert_counters_equal(jeng, eng)


def test_packed_block_crc_is_the_jax_crc():
    rs = np.random.RandomState(0)
    k = rs.randn(2, 8, 4, 8).astype(np.float32)
    v = rs.randn(2, 8, 4, 8).astype(np.float32)
    packed = PackedBlock(k, v)
    assert packed.crc == jcrc(k, v) and packed.verify()
    packed.host_v = v.copy()
    packed.host_v.view(np.uint32).flat[5] ^= 1  # one flipped bit
    assert not packed.verify()


def test_preempt_resume_reuses_stashed_blocks(both_params):
    """A preempted sequence's computed blocks (prompt and generated) are
    stashed in the index; its re-admission reuses them, and the resumed
    stream is the uncached one."""
    sp = SamplingParams(max_new_tokens=12, temperature=0.8, top_k=10, seed=3)
    _, big = engines(both_params, enabled=False, num_blocks=40, block_size=4)
    ref = big.generate([[1, 2, 3, 4, 5]], sp)[0]
    jeng, eng = engines(both_params, num_blocks=6, block_size=4)
    runs = []
    for e, sched_cls, conv in ((jeng, JScheduler, _jsp), (eng, ContinuousBatchingScheduler,
                                                          lambda s: s)):
        e.prefix_cache.swap_overhead_s = 0.0
        kw = {"overlap": False} if sched_cls is JScheduler else {}
        sched = sched_cls(e, clock=FakeClock(), **kw)
        h1 = sched.submit([1, 2, 3, 4, 5], conv(sp))
        h2 = sched.submit([9, 8, 7], conv(SamplingParams(max_new_tokens=12, seed=1)))
        for _ in range(300):
            if h1.done() and h2.done():
                break
            sched.step()
        runs.append((sched.preemptions, h1.result(0), h2.result(0)))
    assert runs[1] == runs[0] and runs[1][1] == ref and runs[1][0] > 0
    pc = eng.prefix_cache
    assert pc.registered_total > 0
    assert pc.tokens_reused_total > 0, "re-admission never reused stashed KV"
    assert_counters_equal(jeng, eng)


def test_router_probe_counts_cached_run(both_params):
    """probe() reports the cached full-block run capped at len - 1, as
    JAX's does, without counting as traffic."""
    jeng, eng = engines(both_params)
    sp = SamplingParams(max_new_tokens=2)
    eng.generate([TEMPLATE + [30]], sp)
    jgenerate(jeng, [TEMPLATE + [30]], sp)
    lookups = eng.prefix_cache.lookups
    for prompt, want in ((TEMPLATE + [31], 16), (list(TEMPLATE[:16]), 15), ([99, 98], 0),
                         (TEMPLATE[:9], 8), ([1], 0)):
        assert eng.prefix_cache.probe(prompt) == want == jeng.prefix_cache.probe(prompt)
    assert eng.prefix_cache.lookups == lookups


def test_disabled_prefix_cache_is_inert(both_params):
    """prefix_cache=False: no registration, no reuse, no index-owned
    blocks — the allocator drains to full."""
    _, eng = engines(both_params, enabled=False)
    sp = SamplingParams(max_new_tokens=4)
    eng.generate([list(TEMPLATE)], sp)
    eng.generate([list(TEMPLATE)], sp)
    snap = eng.prefix_cache.snapshot()
    assert snap["registered_total"] == 0 and snap["hits"] == 0 and snap["lookups"] == 0
    assert eng.allocator.num_free == eng.allocator.num_total
    assert not any(k.startswith("prefix_prefill") for k in eng.trace_counts)
    assert eng.reclaim_cached(4) == 0


def test_prefix_prefill_body_matches_jax_impl(both_params):
    """The suffix-prefill step run eagerly on the CPU, at suffix lengths
    across the 8/16/32 buckets and prefixes of one and two blocks: the
    token is the JAX engine's ``_prefix_prefill_impl``'s, the logits at
    the last real position within 1e-5 of the JAX verify forward's, and
    the cache holds the same K/V; one signature per suffix bucket."""
    jparams, _ = both_params
    jeng, eng = engines(both_params, enabled=False, slots=1)
    rs = np.random.RandomState(5)
    sp = SamplingParams(temperature=0.9, top_k=7, seed=11)
    mb = eng.max_blocks_per_seq
    for prefix_len, n_suffix in ((8, 1), (8, 7), (16, 9), (16, 17), (8, 40)):
        prompt = rs.randint(0, 50, prefix_len + n_suffix).tolist()
        blocks = eng.allocator.allocate(eng.cache_config.blocks_for(len(prompt) + 1))
        assert jeng.allocator.allocate(len(blocks)) == blocks
        # the prefix's K/V, written by a full prefill of the prefix alone
        assert eng.prefill_one(prompt[:prefix_len], blocks, sp, 0) == jeng.prefill_one(
            prompt[:prefix_len], blocks, _jsp(sp), jax.random.fold_in(jax.random.key(sp.seed), 0))
        snap = (jeng.cache.k, jeng.cache.v)
        token = eng.prefill_one(prompt, blocks, sp, sample_index=3, prefix_len=prefix_len)
        w = eng.bucket_for(n_suffix)
        tokens = np.zeros((1, w), np.int32)
        tokens[0, :n_suffix] = prompt[prefix_len:]
        table = np.zeros((mb,), np.int32)
        table[: len(blocks)] = blocks
        key = jax.random.fold_in(jax.random.key(sp.seed), 3)
        jtoken, jok, jk, jv = jeng._prefix_prefill_impl(
            jparams, jnp.asarray(tokens), jnp.int32(prefix_len), jnp.int32(n_suffix),
            snap[0], snap[1], jnp.asarray(table), jnp.float32(sp.temperature),
            jnp.int32(sp.top_k), key, jnp.zeros((CFG_KW["vocab_size"],), jnp.float32))
        assert token == int(jtoken) and eng.last_finite.tolist() == [bool(jok)] == [True]
        offs = np.arange(w)
        pos = np.where(offs < n_suffix, prefix_len + offs, -1)[None].astype(np.int32)
        jlogits, _, _ = jdec.verify_step(jparams, jnp.asarray(tokens), jnp.asarray(pos),
                                         snap[0], snap[1], jnp.asarray(table)[None])
        np.testing.assert_allclose(eng.last_logits.numpy(), np.asarray(jlogits)[0, n_suffix - 1],
                                   atol=LOGITS_ATOL, rtol=0)
        idx = np.asarray(blocks)
        np.testing.assert_allclose(eng.cache.k.numpy()[:, idx], np.asarray(jk)[:, idx],
                                   atol=LOGITS_ATOL, rtol=0)
        np.testing.assert_allclose(eng.cache.v.numpy()[:, idx], np.asarray(jv)[:, idx],
                                   atol=LOGITS_ATOL, rtol=0)
        jeng.cache.update(jk, jv)
        eng.allocator.free(blocks)
        jeng.allocator.free(blocks)
    assert {k: v for k, v in eng.trace_counts.items() if k.startswith("prefix_prefill")} == {
        "prefix_prefill[8]": 1, "prefix_prefill[16]": 1, "prefix_prefill[32]": 1,
        "prefix_prefill[64]": 1}


def test_serving_roofline_matches_jax():
    """The FLOPs and bytes model and the roofline prefix_plan reads equal
    the JAX package's for the CPU preset (so the two engines take the same
    swap-or-recompute decisions); the H100 preset holds its datasheet
    figures."""
    cfg = TransformerConfig(**CFG_KW)
    jcfg = JTransformerConfig(**CFG_KW)
    ours = ServingFlops.from_config(cfg, chip=chip_spec_for(torch.device("cpu")))
    theirs = JServingFlops.from_config(jcfg, chip=jchip_spec_for("cpu"))
    for n, ctx in ((1, 1), (17, 153), (64, 2080)):
        assert ours.prefill_flops(n) == theirs.prefill_flops(n)
        assert ours.decode_flops(n, ctx) == theirs.decode_flops(n, ctx)
        assert ours.verify_flops(n, ctx) == theirs.verify_flops(n, ctx)
        assert ours.prefill_bytes(n) == theirs.prefill_bytes(n)
        assert ours.decode_bytes(n, ctx) == theirs.decode_bytes(n, ctx)
        assert ours.verify_bytes(n, ctx) == theirs.verify_bytes(n, ctx)
        flops, nbytes = ours.verify_flops(n, ctx), ours.verify_bytes(n, ctx)
        assert ours.roofline_s(flops, nbytes) == pytest.approx(theirs.roofline_s(flops, nbytes),
                                                               rel=1e-12)
    h100 = CHIP_PRESETS["h100"]
    assert (h100.f32_flops, h100.hbm_bandwidth, h100.hbm_capacity) == (67e12, 3.35e12, 80e9)
    assert chip_spec_for(torch.device("cuda", 0)) is h100


def test_expected_prefix_sharing_sizes_the_cache_as_jax(both_params):
    jparams, params = both_params
    for sharing in (0.0, 0.5, 0.9):
        kw = dict(max_batch_slots=4, block_size=BLOCK, expected_prefix_sharing=sharing)
        jeng = JGenerationEngine(jparams, JTransformerConfig(**CFG_KW), **kw)
        eng = GenerationEngine(params, TransformerConfig(**CFG_KW), device="cpu", **kw)
        assert eng.cache_config.num_blocks == jeng.cache_config.num_blocks
        assert eng.prefix_cache.host_budget_bytes == jeng.prefix_cache.host_budget_bytes
    with pytest.raises(ValueError, match="expected_prefix_sharing"):
        GenerationEngine(params, TransformerConfig(**CFG_KW), device="cpu",
                         expected_prefix_sharing=1.0)


def test_non_finite_prefill_fails_the_request_and_registers_nothing(both_params):
    """A suffix prefill over a shared block holding NaN gives non-finite
    logits: the request fails, its private blocks and shared references
    are released, and none of its blocks join the index (the JAX
    scheduler's finiteness gate before ``register_prefix``)."""
    _, eng = engines(both_params)
    sp = SamplingParams(max_new_tokens=4)
    eng.generate([TEMPLATE + [20]], sp)  # registers 2 full blocks
    registered = eng.prefix_cache.registered_total
    first = min(eng.prefix_cache._by_id.values(), key=lambda e: e.depth)
    eng.cache.k[:, first.block] = float("nan")
    sched = ContinuousBatchingScheduler(eng, clock=FakeClock())
    h = sched.submit(TEMPLATE[:16] + list(range(30, 40)), sp)
    sched.step()
    with pytest.raises(FloatingPointError, match="non-finite"):
        h.result(timeout=0)
    assert sched.counts["failed"] == 1 and not sched.has_work()
    assert eng.prefix_cache.registered_total == registered
    assert eng.prefix_cache.snapshot()["shared_blocks"] == 0
    assert_blocks_conserved(eng)
