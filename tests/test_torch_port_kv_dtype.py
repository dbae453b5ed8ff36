"""Serving from a bfloat16 or float16 KV cache: the port against the JAX
package on the CPU.

The weights, q, the logits and the sampler stay float32 in both
packages; only the cache holds K and V in 2 bytes. Each package computes
K and V in float32 and rounds them to the cache's dtype when it writes
them, and both paged attention paths widen them back to float32 exactly.

Tolerances:

* The plain paged versions (single-pass and split) against the JAX
  Pallas kernel in interpret mode, on identical 2-byte caches (the same
  bits, handed over as uint16 views): float32 arithmetic in another
  summation order, atol 1e-5 on outputs of O(1).
* A decode step over identical cache bits: the same float32 model in
  another summation order, atol 1e-5 on logits of O(1).
* A decode step over each package's own cache. The K/V each package
  rounds come from float32 projections summed in different orders, so
  an element close to a rounding boundary can round one unit apart (the
  test counts such elements: fewer than 1%, each exactly one unit, so
  by less than 2^-7 of its magnitude in bf16 and 2^-10 in fp16). A unit
  in one K or V element moves a logit, to first order, by at most that
  relative share of its magnitude; the gate is the unit roundoff u of
  the cache dtype (2^-8 bf16, 2^-11 fp16) times the largest logit, plus
  the summation-order 1e-5.
* Greedy and seeded streams, the host tier's counters and its
  swap-or-recompute decisions, the serving roofline's predictions and
  the host tier's CRCs: equal, no tolerance.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import torch_port_chaos as chaos
from flexflow_tpu.core.types import DataType as JDataType
from flexflow_tpu.generation import GenerationEngine as JGenerationEngine
from flexflow_tpu.generation import SamplingParams as JSamplingParams
from flexflow_tpu.generation import decoder as jdecoder
from flexflow_tpu.generation import init_decoder_params as jinit_decoder_params
from flexflow_tpu.generation.cache import CacheConfig as JCacheConfig
from flexflow_tpu.generation.prefix import SWAP_OVERHEAD_S as JSWAP_OVERHEAD_S
from flexflow_tpu.models.transformer import TransformerConfig as JTransformerConfig
from flexflow_tpu.obs.capacity import ServingFlops as JServingFlops
from flexflow_tpu.ops.kernels import decode_attention as jda
from flexflow_tpu.search.calibration import chip_spec_for as jchip_spec_for
from flexflow_tpu_torch.core.types import DataType
from flexflow_tpu_torch.generation import (
    CacheConfig,
    GenerationEngine,
    SamplingParams,
    decoder_params_from_numpy,
)
from flexflow_tpu_torch.generation import decoder as tdecoder
from flexflow_tpu_torch.generation.prefix import SWAP_OVERHEAD_S, PackedBlock, from_host, to_host
from flexflow_tpu_torch.models.transformer import TransformerConfig
from flexflow_tpu_torch.obs.capacity import CHIP_PRESETS, ServingFlops, chip_spec_for
from flexflow_tpu_torch.ops.kernels import decode_attention as tda

pytestmark = pytest.mark.torch_port

ATOL = 1e-5
TWO_BYTE = ["BFLOAT16", "HALF"]
TORCH_DTYPE = {"BFLOAT16": torch.bfloat16, "HALF": torch.float16}
JNP_DTYPE = {"BFLOAT16": jnp.bfloat16, "HALF": jnp.float16}
UNIT_ROUNDOFF = {"BFLOAT16": 2.0 ** -8, "HALF": 2.0 ** -11}
CFG_KW = dict(num_layers=2, hidden_size=32, num_heads=4, ff_size=64,
              seq_length=64, vocab_size=50, causal=True)
BUCKETS = (8, 16, 32, 64)
BLOCK = 8


@pytest.fixture(scope="module")
def jparams():
    return jinit_decoder_params(jax.random.key(0), JTransformerConfig(**CFG_KW))


@pytest.fixture(scope="module")
def params(jparams):
    return decoder_params_from_numpy(jax.tree.map(np.asarray, jparams))


def _bits(x: np.ndarray, name: str) -> np.ndarray:
    """float32 ``x`` rounded to the 2-byte dtype, as its uint16 bits."""
    return to_host(torch.from_numpy(x).to(TORCH_DTYPE[name]))


def _jax_cache(bits: np.ndarray, name: str) -> jax.Array:
    return jax.lax.bitcast_convert_type(jnp.asarray(bits.view(np.int16)), JNP_DTYPE[name])


def _torch_cache(bits: np.ndarray, name: str) -> torch.Tensor:
    return from_host(bits.view(np.uint16) if name == "BFLOAT16" else bits.view(np.float16),
                     TORCH_DTYPE[name])


# ---------------------------------------------------------------------------
# the paged kernels' plain versions against the Pallas kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", TWO_BYTE)
@pytest.mark.parametrize("kv_splits", [1, 3, 12])
@pytest.mark.parametrize("w", [1, 5])
def test_plain_paged_versions_match_the_pallas_kernel_on_two_byte_caches(name, kv_splits, w):
    """Single-pass (splits 1) and split-KV partials + combine (3, and one
    split per table column) over the same cache bits as the JAX kernel
    in interpret mode, with padding queries, a scratch entry in a live
    range and a padding-only sequence: float32 out, exact zeros for
    padding."""
    rs = np.random.RandomState(kv_splits * 10 + w)
    nb, bs, h, d, mb, b = 33, 8, 4, 64, 12, 3
    kb = _bits(rs.randn(nb, bs, h, d).astype(np.float32), name)
    vb = _bits(rs.randn(nb, bs, h, d).astype(np.float32), name)
    q = rs.randn(b, w, h, d).astype(np.float32)
    tables = rs.randint(1, nb, (b, mb)).astype(np.int32)
    tables[0, 0] = 0
    base = rs.randint(0, mb * bs - w, (b, 1))
    qpos = (base + np.arange(w)[None, :]).astype(np.int32)
    qpos[rs.rand(b, w) < 0.2] = -1
    qpos[-1] = -1
    want = np.asarray(jda.paged_append_attention(
        jnp.asarray(q), _jax_cache(kb, name), _jax_cache(vb, name), jnp.asarray(tables),
        jnp.asarray(qpos), interpret=True, kv_splits=kv_splits))
    k, v = _torch_cache(kb, name), _torch_cache(vb, name)
    assert k.dtype == TORCH_DTYPE[name]
    got = tda.paged_append_attention(torch.from_numpy(q), k, v, torch.from_numpy(tables),
                                     torch.from_numpy(qpos), kv_splits=kv_splits)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    assert np.all(got.numpy()[qpos < 0] == 0.0)


def test_kernel_input_checks_take_two_byte_caches():
    """The CUDA wrapper's checks take float32, bfloat16 and float16 caches
    of one dtype under a float32 q, and refuse a 2-byte q, mismatched
    caches and a float64 cache (no fallback: a CUDA tensor then raises)."""
    q = torch.zeros(2, 3, 4, 16)
    kc = torch.zeros(9, 8, 4, 16)
    bt = torch.zeros(2, 4, dtype=torch.int32)
    qp = torch.zeros(2, 3, dtype=torch.int32)
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        tda._check_kernel_inputs(q, kc.to(dt), kc.to(dt), bt, qp)
    for bad in ((q.bfloat16(), kc.bfloat16(), kc.bfloat16()),
                (q.half(), kc.half(), kc.half()),
                (q, kc.bfloat16(), kc.half()),
                (q, kc, kc.bfloat16()),
                (q, kc.double(), kc.double())):
        with pytest.raises(TypeError):
            tda._check_kernel_inputs(*bad, bt, qp)


# ---------------------------------------------------------------------------
# the model's steps over a 2-byte cache
# ---------------------------------------------------------------------------


_jprefill = jax.jit(jdecoder.prefill)
_jdecode_step = jax.jit(jdecoder.decode_step)


def _prefilled_caches(jparams, params, name, lens, rs):
    """Both packages prefill the same prompts and write their K/V, each
    rounded to the cache dtype, into caches of their own (as their
    engines' prefill steps do). Returns (JAX caches, port caches,
    tables)."""
    L, nb, h, d = CFG_KW["num_layers"], 30, CFG_KW["num_heads"], 8
    tables = np.zeros((len(lens), 8), np.int32)
    nxt = 1
    for i, n in enumerate(lens):
        blocks = -(-(n + 1) // BLOCK)
        tables[i, :blocks] = np.arange(nxt, nxt + blocks)
        nxt += blocks
    jk = jnp.zeros((L, nb * BLOCK, h, d), JNP_DTYPE[name])
    jv = jnp.zeros_like(jk)
    tk = torch.zeros((L, nb, BLOCK, h, d), dtype=TORCH_DTYPE[name])
    tv = torch.zeros_like(tk)
    for i, n in enumerate(lens):
        tokens = np.zeros((1, 32), np.int32)
        tokens[0, :n] = rs.randint(0, CFG_KW["vocab_size"], n)
        _, ks, vs = _jprefill(jparams, jnp.asarray(tokens), jnp.full((1,), n, jnp.int32))
        _, tks, tvs = tdecoder.prefill(params, torch.from_numpy(tokens),
                                       torch.full((1,), n, dtype=torch.int32))
        pos = np.arange(n)
        slots = tables[i, pos // BLOCK] * BLOCK + pos % BLOCK
        jk = jk.at[:, slots].set(ks[:, 0, :n].astype(jk.dtype))
        jv = jv.at[:, slots].set(vs[:, 0, :n].astype(jv.dtype))
        tk.view(L, -1, h, d)[:, torch.from_numpy(slots)] = tks[:, 0, :n].to(tk.dtype)
        tv.view(L, -1, h, d)[:, torch.from_numpy(slots)] = tvs[:, 0, :n].to(tv.dtype)
    shape = (L, nb, BLOCK, h, d)
    return (jk.reshape(shape), jv.reshape(shape)), (tk, tv), tables


def _units_apart(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """How many representable values of the 2-byte dtype lie between the
    elements of two same-sign arrays of its bits (as int16)."""
    return np.abs(a.astype(np.int32) - b.astype(np.int32))


@pytest.mark.parametrize("name", TWO_BYTE)
def test_decode_step_logits_over_two_byte_caches_match_jax(jparams, params, name):
    """A decode step of three sequences over a 2-byte cache. Over
    identical cache bits the logits agree to the summation order (1e-5);
    over each package's own cache the rounded K/V differ in under 1% of
    the elements, each by one unit, and the logits within u x the
    largest logit (module docstring)."""
    rs = np.random.RandomState(3)
    lens = [5, 13, 30]
    (jk, jv), (tk, tv), tables = _prefilled_caches(jparams, params, name, lens, rs)
    for jc, tc in ((jk, tk), (jv, tv)):
        jbits = np.asarray(jax.lax.bitcast_convert_type(jc, jnp.int16))
        tbits = tc.view(torch.int16).numpy()
        apart = _units_apart(jbits, tbits)
        assert apart.max() <= 1 and apart.sum() < 0.01 * apart.size
    tokens = np.asarray([7, 8, 9], np.int32)
    positions = np.asarray(lens, np.int32)
    jlogits = np.asarray(_jdecode_step(
        jparams, jnp.asarray(tokens), jnp.asarray(positions), jk, jv, jnp.asarray(tables),
        jnp.asarray(positions + 1))[0])
    args = (torch.from_numpy(tokens), torch.from_numpy(positions))
    rest = (torch.from_numpy(tables), torch.from_numpy(positions + 1))
    # the same bits: JAX's cache read as the port's dtype
    same = [from_host(np.array(jax.lax.bitcast_convert_type(c, jnp.int16)), TORCH_DTYPE[name])
            for c in (jk, jv)]
    logits = tdecoder.decode_step(params, *args, *same, *rest)[0].numpy()
    np.testing.assert_allclose(logits, jlogits, atol=ATOL, rtol=0)
    own = tdecoder.decode_step(params, *args, tk, tv, *rest)[0].numpy()
    bound = UNIT_ROUNDOFF[name] * np.abs(jlogits).max() + ATOL
    assert np.abs(own - jlogits).max() <= bound
    assert (own.argmax(-1) == jlogits.argmax(-1)).all()


def _engines(jparams, params, name, num_blocks=30):
    cc = dict(num_layers=CFG_KW["num_layers"], num_heads=CFG_KW["num_heads"], head_dim=8,
              num_blocks=num_blocks, block_size=BLOCK)
    jeng = JGenerationEngine(jparams, JTransformerConfig(**CFG_KW),
                             cache_config=JCacheConfig(**cc, dtype=JDataType[name]),
                             max_batch_slots=3, prompt_buckets=BUCKETS)
    eng = GenerationEngine(params, TransformerConfig(**CFG_KW),
                           cache_config=CacheConfig(**cc, dtype=DataType[name]),
                           max_batch_slots=3, prompt_buckets=BUCKETS, device="cpu")
    return jeng, eng


@pytest.mark.parametrize("name", TWO_BYTE)
def test_engine_streams_over_two_byte_caches_equal_jax(jparams, params, name):
    """``GenerationEngine.generate`` over a bf16 or fp16 cache: greedy and
    seeded temperature/top-k streams identical to the JAX engine's, and
    the cache holds the dtype (2 bytes an element in its block size)."""
    jeng, eng = _engines(jparams, params, name)
    assert eng.cache.k.dtype == eng.cache.v.dtype == TORCH_DTYPE[name]
    assert eng.cache_config.bytes_per_block == jeng.cache_config.bytes_per_block == (
        2 * CFG_KW["num_layers"] * BLOCK * CFG_KW["num_heads"] * 8 * 2)
    rs = np.random.RandomState(5)
    prompts = [rs.randint(0, CFG_KW["vocab_size"], n).tolist() for n in (5, 13, 30, 9)]
    for sp in (dict(max_new_tokens=12),
               dict(max_new_tokens=12, temperature=0.8, top_k=20, seed=7)):
        want = jeng.generate(prompts, JSamplingParams(**sp))
        assert eng.generate(prompts, SamplingParams(**sp)) == want


@pytest.mark.parametrize("name", TWO_BYTE)
@pytest.mark.parametrize("overlap", [False, True])
def test_scheduler_streams_over_two_byte_caches_equal_jax(name, overlap):
    """Both continuous-batching schedulers (pipeline on and off) over a
    2-byte cache small enough to preempt: streams, preemptions and
    pipeline counters equal (tests/torch_port_chaos.py)."""
    rs = np.random.RandomState(9)
    prompts = [rs.randint(0, 64, n).tolist() for n in (5, 20, 11, 30)]
    sampling = [dict(max_new_tokens=10), dict(max_new_tokens=10, temperature=0.8, top_k=20,
                                              seed=3)] * 2
    outcomes, counters, eng, _ = chaos.both(prompts, sampling, overlap=overlap,
                                            num_blocks=12, kv_dtype=name)
    assert eng.cache.k.dtype == TORCH_DTYPE[name]
    assert all(isinstance(o, list) and len(o) == 10 for o in outcomes)


# ---------------------------------------------------------------------------
# the host tier and the serving roofline
# ---------------------------------------------------------------------------

SHARED = list(range(1, 17))  # two full blocks of 8


def _host_tier_cycle(overhead):
    """Finish a request, evict its two cached blocks to the host tier,
    then admit one sharing them: the swap-in (``overhead`` 0) or the
    recompute (the default per-swap overhead outweighs two blocks'
    recompute on the CPU preset) is the roofline's decision."""
    def steer(side, sched, handles):
        chaos.drive(sched, handles)
        eng = sched.engine
        eng.prefix_cache.swap_overhead_s = overhead  # the JAX engine is reused: always set
        assert eng.reclaim_cached(2) == 2
        handles.append(sched.submit(SHARED + [30], side.SamplingParams(max_new_tokens=6)))
        chaos.drive(sched, handles)
    return steer


@pytest.mark.parametrize("name", TWO_BYTE)
@pytest.mark.parametrize("overhead", [0.0, SWAP_OVERHEAD_S])
def test_host_tier_over_two_byte_caches_decides_as_jax(name, overhead):
    """A host-tier cycle through both schedulers over a 2-byte cache: the
    prefix counters (swaps out and in, recompute fallbacks, hits) and
    the streams equal JAX's, and the streams equal a run with the
    prefix cache off."""
    assert SWAP_OVERHEAD_S == JSWAP_OVERHEAD_S
    outcomes, counters, eng, _ = chaos.both(
        [SHARED + [20]], dict(max_new_tokens=6), overlap=False, prefix_cache=True,
        kv_dtype=name, steer=_host_tier_cycle(overhead))
    prefix = counters["prefix"]
    assert prefix["swaps_out_total"] == 2
    if overhead == 0.0:
        assert prefix["swaps_in_total"] == 2 and prefix["recompute_fallbacks"] == 0
    else:
        assert prefix["swaps_in_total"] == 0 and prefix["recompute_fallbacks"] == 1
    plain, _, _, _ = chaos.run(chaos.PORT, [SHARED + [20], SHARED + [30]],
                               dict(max_new_tokens=6), overlap=False, kv_dtype=name)
    assert outcomes == plain


@pytest.mark.parametrize("name", ["FLOAT"] + TWO_BYTE)
def test_packed_block_crcs_equal_jax(jparams, params, name):
    """The same block content written into both engines' caches and read
    back for the host tier: the same bytes (bf16 as uint16 bits, fp16 and
    fp32 as themselves) and so the same CRC as the JAX engine's packed
    block."""
    jeng, eng = _engines(jparams, params, name)
    rs = np.random.RandomState(17)
    shape = (CFG_KW["num_layers"], BLOCK, CFG_KW["num_heads"], 8)
    k, v = (rs.randn(*shape).astype(np.float32) for _ in range(2))
    if name == "FLOAT":
        hk, hv, jk, jv = k, v, k, v
    else:
        hk, hv = _bits(k, name), _bits(v, name)
        np_dtype = ml_dtypes.bfloat16 if name == "BFLOAT16" else np.float16
        jk, jv = hk.view(np_dtype), hv.view(np_dtype)
    jeng.import_kv_block(5, jk, jv)
    want = jeng.pack_kv_blocks([5], BLOCK).blocks[0]
    eng._write_block(5, hk, hv)
    got = PackedBlock(*eng._read_block(5))
    assert got.host_k.dtype == {"FLOAT": np.float32, "BFLOAT16": np.uint16,
                                "HALF": np.float16}[name]
    assert got.host_k.tobytes() == np.asarray(want.host_k).tobytes()
    assert got.crc == want.crc
    assert got.verify()


@pytest.mark.parametrize("name", ["FLOAT"] + TWO_BYTE)
def test_serving_roofline_by_cache_dtype_matches_jax(name):
    """``ServingFlops`` at each cache dtype equals the JAX package's on the
    CPU preset (2 bytes and the bf16 peak for a 2-byte cache); the port's
    engine hands it its cache's dtype, and the H100 preset prices a
    2-byte cache at the dense bf16 rate."""
    cfg, jcfg = TransformerConfig(**CFG_KW), JTransformerConfig(**CFG_KW)
    ours = ServingFlops.from_config(cfg, dtype=DataType[name],
                                    chip=chip_spec_for(torch.device("cpu")))
    theirs = JServingFlops.from_config(jcfg, dtype=JDataType[name], chip=jchip_spec_for("cpu"))
    assert (ours.dtype_bytes, ours.peak_flops, ours.param_bytes, ours.kv_bytes_per_pos) == (
        theirs.dtype_bytes, theirs.peak_flops, theirs.param_bytes, theirs.kv_bytes_per_pos)
    for n, ctx in ((1, 1), (17, 153), (64, 2080)):
        assert ours.prefill_bytes(n) == theirs.prefill_bytes(n)
        assert ours.decode_bytes(n, ctx) == theirs.decode_bytes(n, ctx)
        assert ours.verify_bytes(n, ctx) == theirs.verify_bytes(n, ctx)
        flops, nbytes = ours.verify_flops(n, ctx), ours.verify_bytes(n, ctx)
        assert ours.roofline_s(flops, nbytes) == pytest.approx(theirs.roofline_s(flops, nbytes),
                                                               rel=1e-12)
    h100 = ServingFlops.from_config(cfg, dtype=DataType[name], chip=CHIP_PRESETS["h100"])
    assert h100.peak_flops == (67e12 if name == "FLOAT" else 989e12)
    cc = CacheConfig(num_layers=2, num_heads=4, head_dim=8, num_blocks=4, dtype=DataType[name])
    eng = GenerationEngine(decoder_params_from_numpy(
        jax.tree.map(np.asarray, jinit_decoder_params(jax.random.key(0),
                                                      JTransformerConfig(**CFG_KW)))),
        cfg, cache_config=cc, max_batch_slots=1, prompt_buckets=BUCKETS, device="cpu")
    assert eng.flops_model.dtype_bytes == ours.dtype_bytes
    assert eng.flops_model.peak_flops == ours.peak_flops
