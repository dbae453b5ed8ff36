"""The port's generation engine and continuous-batching scheduler
against the JAX package.

Greedy streams through the port's engine are token-identical to the JAX
``GenerationEngine.generate`` on the same weights, prompts and buckets.
Seeded sampling draws JAX's threefry Gumbel noise (``prng.py``), so
seeded temperature/top-k streams are also identical to the JAX engine's,
with and without preemption. ``_sample`` itself is held against JAX's
``topk_scaled_logits`` + argmax on identical numpy noise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import FakeClock
from flexflow_tpu.generation import GenerationEngine as JGenerationEngine
from flexflow_tpu.generation import SamplingParams as JSamplingParams
from flexflow_tpu.generation import init_decoder_params as jinit_decoder_params
from flexflow_tpu.generation.engine import default_buckets as jdefault_buckets
from flexflow_tpu.generation.engine import topk_scaled_logits as jtopk_scaled_logits
from flexflow_tpu.models.transformer import TransformerConfig as JTransformerConfig
from flexflow_tpu_torch.generation import (
    CacheConfig,
    ContinuousBatchingScheduler,
    GenerationEngine,
    SamplingParams,
    decoder_params_from_numpy,
    default_buckets,
    forward_full,
)
from flexflow_tpu_torch.generation import prng
from flexflow_tpu_torch.generation.engine import _sample, derive_keys, topk_scaled_logits
from flexflow_tpu_torch.models.transformer import TransformerConfig
from flexflow_tpu_torch.serving.resilience import DeadlineExceededError, QueueFullError

pytestmark = pytest.mark.torch_port

CFG_KW = dict(
    num_layers=2, hidden_size=32, num_heads=4, ff_size=64,
    seq_length=64, vocab_size=50, causal=True,
)
CFG = TransformerConfig(**CFG_KW)
BUCKETS = (8, 16, 32, 64)
BLOCK = 8


@pytest.fixture(scope="module")
def jparams():
    return jinit_decoder_params(jax.random.key(0), JTransformerConfig(**CFG_KW))


@pytest.fixture(scope="module")
def params(jparams):
    return decoder_params_from_numpy(jax.tree.map(np.asarray, jparams))


def make_engine(params, num_blocks=30, slots=3):
    cc = CacheConfig(
        num_layers=CFG.num_layers, num_heads=CFG.num_heads,
        head_dim=CFG.hidden_size // CFG.num_heads, num_blocks=num_blocks, block_size=BLOCK,
    )
    return GenerationEngine(
        params, CFG, cache_config=cc, max_batch_slots=slots, prompt_buckets=BUCKETS,
        device="cpu",
    )


def naive_greedy(params, prompt, n):
    seq = list(prompt)
    for _ in range(n):
        logits = forward_full(params, torch.tensor([seq], dtype=torch.int32))
        seq.append(int(torch.argmax(logits[0, -1])))
    return seq[len(prompt):]


def run(sched, handles, steps=400):
    for _ in range(steps):
        if all(h.done() for h in handles):
            return
        sched.step()
    raise AssertionError("requests did not finish")


# ---------------------------------------------------------------------------
# greedy streams: token-identical to the JAX engine
# ---------------------------------------------------------------------------


def test_engine_greedy_streams_match_jax_engine(jparams, params):
    """Mixed prompt lengths across the 8/16/32 bucket boundaries, more
    prompts than slots (so requests join mid-flight), one with EOS."""
    rs = np.random.RandomState(5)
    prompts = [rs.randint(0, 50, n).tolist() for n in (3, 8, 9, 17, 31, 5)]
    jeng = JGenerationEngine(
        jparams, JTransformerConfig(**CFG_KW), max_batch_slots=3,
        block_size=BLOCK, prompt_buckets=BUCKETS,
    )
    ref = jeng.generate(prompts, JSamplingParams(max_new_tokens=7))
    eng = GenerationEngine(
        params, CFG, max_batch_slots=3, block_size=BLOCK, prompt_buckets=BUCKETS,
        device="cpu",
    )
    assert eng.generate(prompts, SamplingParams(max_new_tokens=7)) == ref
    eos = ref[0][2]
    jout = jeng.generate(prompts[:1], JSamplingParams(max_new_tokens=7, eos_id=eos))
    out = eng.generate(prompts[:1], SamplingParams(max_new_tokens=7, eos_id=eos))
    assert out == jout and out[0][-1] == eos
    # one decode shape however the batch recomposed; one per prefill bucket
    assert eng.trace_counts["decode"] == 1
    assert eng.recompiles() == {}
    assert eng.step_counts["prefill"] == 7


@pytest.mark.parametrize("prompt_len", [7, 9, 17])
def test_engine_greedy_matches_naive(params, prompt_len):
    eng = make_engine(params)
    prompt = np.random.RandomState(100 + prompt_len).randint(0, 50, prompt_len).tolist()
    (out,) = eng.generate([prompt], SamplingParams(max_new_tokens=5))
    assert out == naive_greedy(params, prompt, 5)


def test_default_buckets_match_jax():
    for n in (64, 100, 1024):
        assert default_buckets(n) == jdefault_buckets(n)


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_matches_jax_on_identical_noise(seed):
    """Greedy rows, temperature rows, top-k rows (with exact ties at the
    threshold: every tied logit survives) and top_k > V, on the same
    numpy Gumbel noise through both packages."""
    rs = np.random.RandomState(seed)
    b, v = 6, 40
    logits = rs.randn(b, v).astype(np.float32)
    logits[3, :5] = logits[3].max()  # ties at the top-k threshold
    temps = np.asarray([0.0, 0.8, 1.3, 0.7, -1.0, 0.5], np.float32)
    top_ks = np.asarray([0, 0, 5, 3, 4, 100], np.int32)
    noise = rs.gumbel(size=(b, v)).astype(np.float32)
    jmasked = jtopk_scaled_logits(jnp.asarray(logits), jnp.asarray(temps), jnp.asarray(top_ks))
    tmasked = topk_scaled_logits(*map(torch.from_numpy, (logits, temps, top_ks)))
    np.testing.assert_array_equal(tmasked.numpy(), np.asarray(jmasked))
    jtok = np.where(
        temps <= 0, np.argmax(logits, -1), np.asarray(jnp.argmax(jmasked + noise, axis=-1))
    )
    out = _sample(*map(torch.from_numpy, (logits, temps, top_ks, noise)))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), jtok)


def test_gumbel_noise_is_seeded_by_seed_and_count():
    def noise(seed, count):
        return prng.gumbel(derive_keys(torch.tensor([seed]), torch.tensor([count])), (50,))[0]

    a = noise(42, 3)
    assert torch.equal(a, noise(42, 3))
    assert not torch.equal(a, noise(42, 4))
    assert not torch.equal(a, noise(43, 3))
    assert torch.equal(noise(2**32 + 42, 3), a)  # 32-bit seeds
    assert torch.isfinite(a).all()
    # no two tokens of one stream share a key
    k1, k2 = derive_keys(torch.full((5000,), 7), torch.arange(5000))
    assert len(set(zip(k1.tolist(), k2.tolist()))) == 5000


def test_seeded_streams_are_reproducible(params):
    sp = SamplingParams(max_new_tokens=8, temperature=0.9, top_k=10, seed=11)
    a = make_engine(params).generate([[1, 2, 3]], sp)
    b = make_engine(params).generate([[1, 2, 3]], sp)
    c = make_engine(params).generate(
        [[1, 2, 3]], SamplingParams(max_new_tokens=8, temperature=0.9, top_k=10, seed=12)
    )
    assert a == b and a != c


SEEDED = [
    SamplingParams(max_new_tokens=10, temperature=0.8, top_k=10, seed=42),
    SamplingParams(max_new_tokens=10, temperature=1.3, top_k=0, seed=2**31 - 1),
]


def _jsampling(sp):
    return JSamplingParams(
        max_new_tokens=sp.max_new_tokens, temperature=sp.temperature, top_k=sp.top_k,
        seed=sp.seed,
    )


@pytest.mark.parametrize("sp", SEEDED, ids=["topk", "temperature"])
def test_seeded_streams_match_jax_engine(jparams, params, sp):
    """Seeded temperature/top-k streams from the same weights are the
    JAX engine's token for token: the Gumbel noise is JAX's threefry
    bits, keyed by (seed, generated-token count)."""
    prompts = [[1, 2, 3, 4, 5], [9, 8, 7], list(range(10, 27))]
    jeng = JGenerationEngine(
        jparams, JTransformerConfig(**CFG_KW), max_batch_slots=3,
        block_size=BLOCK, prompt_buckets=BUCKETS,
    )
    ref = jeng.generate(prompts, _jsampling(sp))
    assert make_engine(params).generate(prompts, sp) == ref


def test_seeded_streams_match_jax_engine_under_preemption(jparams, params):
    """A cache too small for both requests preempts one by recompute; the
    resumed streams still equal the JAX engine's unpreempted streams."""
    jeng = JGenerationEngine(
        jparams, JTransformerConfig(**CFG_KW), max_batch_slots=3,
        block_size=BLOCK, prompt_buckets=BUCKETS,
    )
    sp1, sp2 = SEEDED
    ref1 = jeng.generate([[1, 2, 3, 4, 5]], _jsampling(sp1))[0]
    ref2 = jeng.generate([[9, 8, 7]], _jsampling(sp2))[0]
    small = make_engine(params, num_blocks=4)  # 24 usable positions
    sched = ContinuousBatchingScheduler(small, clock=FakeClock())
    h1 = sched.submit([1, 2, 3, 4, 5], sp1)
    h2 = sched.submit([9, 8, 7], sp2)
    run(sched, [h1, h2])
    assert sched.preemptions > 0
    assert h1.result(0) == ref1
    assert h2.result(0) == ref2


# ---------------------------------------------------------------------------
# continuous batching
# ---------------------------------------------------------------------------


def test_scheduler_join_mid_flight(params):
    """A request submitted while another is decoding joins the running
    batch at the next step; both outputs match solo runs."""
    eng = make_engine(params)
    solo_a = naive_greedy(params, [1, 2, 3], 8)
    solo_b = naive_greedy(params, [9, 8, 7, 6], 4)
    sched = ContinuousBatchingScheduler(eng, clock=FakeClock())
    ha = sched.submit([1, 2, 3], SamplingParams(max_new_tokens=8))
    for _ in range(3):
        sched.step()
    assert 0 < len(ha._request.generated) < 8
    hb = sched.submit([9, 8, 7, 6], SamplingParams(max_new_tokens=4))
    sched.step()  # B admitted mid-flight...
    assert len(hb._request.generated) >= 1  # ...and already producing
    assert not ha.done()
    run(sched, [ha, hb])
    assert ha.result(0) == solo_a
    assert hb.result(0) == solo_b
    assert list(hb.tokens(timeout=0)) == solo_b


def test_scheduler_free_on_finish(params):
    """Blocks return to the allocator the step a sequence finishes."""
    eng = make_engine(params, slots=2)
    sched = ContinuousBatchingScheduler(eng, clock=FakeClock())
    free0 = eng.allocator.num_free
    h = sched.submit([1, 2, 3, 4, 5], SamplingParams(max_new_tokens=3))
    sched.step()
    assert eng.allocator.num_free < free0
    run(sched, [h])
    assert eng.allocator.num_free == free0
    assert not sched.has_work()


@pytest.mark.parametrize(
    "sp1,sp2",
    [
        (SamplingParams(max_new_tokens=10), SamplingParams(max_new_tokens=10)),
        (
            SamplingParams(max_new_tokens=10, temperature=0.8, top_k=10, seed=42),
            SamplingParams(max_new_tokens=10, temperature=0.7, top_k=8, seed=7),
        ),
    ],
    ids=["greedy", "seeded"],
)
def test_scheduler_preempt_on_full_recomputes_exactly(params, sp1, sp2):
    """Cache exhaustion preempts the youngest sequence by recompute; the
    token streams continue exactly where they left off."""
    big = make_engine(params, num_blocks=40)
    ref1 = big.generate([[1, 2, 3, 4, 5]], sp1)[0]
    ref2 = big.generate([[9, 8, 7]], sp2)[0]
    small = make_engine(params, num_blocks=4)  # 24 usable positions
    sched = ContinuousBatchingScheduler(small, clock=FakeClock())
    h1 = sched.submit([1, 2, 3, 4, 5], sp1)
    h2 = sched.submit([9, 8, 7], sp2)
    run(sched, [h1, h2])
    assert sched.preemptions > 0
    assert h1.result(0) == ref1
    assert h2.result(0) == ref2
    # no leak: every block out of the free list is the prefix cache's
    # (the preempted sequence's stashed blocks, reusable KV)
    used = small.allocator.num_total - small.allocator.num_free
    assert used == small.prefix_cache.resident_blocks


def test_scheduler_deadline_and_queue_bounds(params):
    eng = make_engine(params, slots=1)
    clock = FakeClock()
    sched = ContinuousBatchingScheduler(eng, clock=clock, max_queue=2)
    with pytest.raises(DeadlineExceededError):
        sched.submit([1, 2], SamplingParams(), deadline_s=0)
    h = sched.submit([1, 2], SamplingParams(max_new_tokens=50), deadline_s=5.0)
    queued = sched.submit([3, 4], SamplingParams(), deadline_s=1.0)
    with pytest.raises(QueueFullError):
        sched.submit([5, 6], SamplingParams())
    sched.step()  # h admitted; `queued` waits for the only slot
    assert len(h._request.generated) >= 1
    clock.advance(2.0)
    sched.step()  # `queued` expires while queued
    with pytest.raises(DeadlineExceededError):
        queued.result(0)
    clock.advance(10.0)
    sched.step()  # h expires mid-generation, its blocks freed
    with pytest.raises(DeadlineExceededError):
        h.result(0)
    assert eng.allocator.num_free == eng.allocator.num_total
    with pytest.raises(ValueError):
        sched.submit([1] * 64, SamplingParams())  # fills max_seq_len


def test_scheduler_cancel_frees_blocks(params):
    eng = make_engine(params)
    sched = ContinuousBatchingScheduler(eng, clock=FakeClock())
    h = sched.submit([1, 2, 3], SamplingParams(max_new_tokens=20))
    sched.step()
    h.cancel()
    sched.step()
    assert h.done() and sched.stats.get("cancelled") == 1
    assert eng.allocator.num_free == eng.allocator.num_total


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def test_entry_point_defaults_to_cuda_and_raises_without_it(params):
    """device=None means CUDA; where no GPU is present that is an error,
    never a silent run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GenerationEngine(params, CFG, max_batch_slots=2, prompt_buckets=BUCKETS)
    with pytest.raises(RuntimeError):
        GenerationEngine(params, CFG, max_batch_slots=2, prompt_buckets=BUCKETS, device="cuda")
    eng = GenerationEngine(
        params, CFG, max_batch_slots=2, prompt_buckets=BUCKETS, device="cpu"
    )
    assert eng.device.type == "cpu" and eng.cache.k.device.type == "cpu"


def test_engine_cache_sizing_matches_jax_engine(jparams, params):
    """Slot sizing (the default) and byte-budget sizing give the JAX
    engine's cache geometry, table width and buckets."""
    jcfg = JTransformerConfig(**CFG_KW)
    for kw in ({}, {"cache_budget_bytes": 1 << 16}):
        jeng = JGenerationEngine(jparams, jcfg, max_batch_slots=3, block_size=BLOCK, **kw)
        eng = GenerationEngine(
            params, CFG, max_batch_slots=3, block_size=BLOCK, device="cpu", **kw
        )
        assert eng.cache_config.num_blocks == jeng.cache_config.num_blocks
        assert eng.max_blocks_per_seq == jeng.max_blocks_per_seq
        assert eng.buckets == jeng.buckets
        assert tuple(eng.cache.k.shape) == tuple(jeng.cache.k.shape)
