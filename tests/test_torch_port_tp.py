"""Tensor-parallel serving in the port (``generation/sharding.py``,
``parallel/distributed.py``, ``search/serving_strategy.py``) held against
the JAX package's mesh engine (``tests/test_mesh_generation.py``'s cases).

The port's tp = N engine is N processes over gloo on the CPU (rank 0 in
this process, ranks 1..N-1 spawned by the engine); JAX's tp=2 engine
shards over 2 of the 8 host devices ``conftest.py`` gives JAX, and the
port's tp=4 streams are held against JAX's tp=1 engine, which JAX's own
matrix holds byte-identical to its tp=4 one. Every engine is built once
(module scope) and ``reset()`` between cases. Streams are compared token for token, recovery counters
field for field, search scores at rel 1e-12.
"""
import dataclasses
import itertools

import jax
import numpy as np
import pytest
import torch

from flexflow_tpu.generation import ContinuousBatchingScheduler as JScheduler
from flexflow_tpu.generation import GenerationEngine as JEngine
from flexflow_tpu.generation import RecoveryPolicy as JRecoveryPolicy
from flexflow_tpu.generation import SamplingParams as JSamplingParams
from flexflow_tpu.generation import SpeculationConfig as JSpeculationConfig
from flexflow_tpu.generation import init_decoder_params as jinit_decoder_params
from flexflow_tpu.generation import sharding as jsharding
from flexflow_tpu.generation.cache import CacheConfig as JCacheConfig
from flexflow_tpu.models.transformer import TransformerConfig as JTransformerConfig
from flexflow_tpu.ops.kernels import decode_attention as jda
from flexflow_tpu.runtime import faults as jfaults
from flexflow_tpu.search import calibration as jcal
from flexflow_tpu.search import serving_strategy as jss
from flexflow_tpu.serving.generation import GenerationModel as JGenerationModel
from flexflow_tpu_torch.generation import (
    ContinuousBatchingScheduler,
    GenerationEngine,
    RecoveryPolicy,
    SamplingParams,
    SpeculationConfig,
    decoder_params_from_numpy,
)
from flexflow_tpu_torch.generation import sharding
from flexflow_tpu_torch.generation.cache import CacheConfig
from flexflow_tpu_torch.models.transformer import TransformerConfig
from flexflow_tpu_torch.obs import capacity
from flexflow_tpu_torch.ops.kernels import decode_attention as da
from flexflow_tpu_torch.parallel.mesh import serving_mesh
from flexflow_tpu_torch.runtime import faults
from flexflow_tpu_torch.search import calibration as tcal
from flexflow_tpu_torch.search import serving_strategy as tss
from flexflow_tpu_torch.serving.generation import GenerationModel

pytestmark = [pytest.mark.torch_port, pytest.mark.mesh]

# tests/test_mesh_generation.py's geometry
CFG_KW = dict(num_layers=2, hidden_size=32, num_heads=4, ff_size=64, seq_length=64,
              vocab_size=61, causal=True)
JCFG, TCFG = JTransformerConfig(**CFG_KW), TransformerConfig(**CFG_KW)
ENGINE_KW = dict(max_batch_slots=2, block_size=8, max_spec_tokens=3)
PROMPTS = [[1, 2, 3, 4, 5, 6, 7], [9, 8, 7, 6, 5], list(range(1, 20))]
MODES = {
    "greedy": dict(max_new_tokens=8),
    "temp": dict(max_new_tokens=8, temperature=0.8, seed=11),
    "topk": dict(max_new_tokens=8, temperature=1.0, top_k=7, seed=5),
}
RECOVERY_FIELDS = ("recoveries", "step_retries", "replayed_tokens", "quarantined",
                   "watchdog_trips", "engine_failures")
DEGREES = (2, 4)


def close(a, b, rel=1e-12):
    return a == b or abs(a - b) <= rel * max(abs(a), abs(b))


@pytest.fixture(scope="module")
def params():
    jp = jinit_decoder_params(jax.random.key(0), JCFG)
    return jp, decoder_params_from_numpy(jax.tree.map(np.asarray, jp))


class Engines:
    """One engine per (package, degree), built at first use and reset
    before each reuse; the port's are closed at the module's end."""

    def __init__(self, params):
        self.jp, self.tp = params
        self._built = {}

    def get(self, side, tp):
        eng = self._built.get((side, tp))
        if eng is None:
            if side == "jax":
                eng = JEngine(self.jp, JCFG, tp_degree=tp, **ENGINE_KW)
            else:
                eng = GenerationEngine(self.tp, TCFG, tp_degree=tp, device="cpu", **ENGINE_KW)
            self._built[(side, tp)] = eng
        else:
            eng.reset()
        return eng

    def reference(self, tp):
        """The JAX engine a port tp=N engine's streams are held against:
        JAX's tp=2 engine at N = 2; at N = 4 its tp=1 engine, which JAX's
        own matrix holds byte-identical to its tp=4 one
        (``tests/test_mesh_generation.py``), at a third of the compile
        time."""
        return self.get("jax", 2 if tp == 2 else 1)

    def close(self):
        for (side, _), eng in self._built.items():
            if side == "port":
                eng.close()


@pytest.fixture(scope="module")
def engines(params):
    e = Engines(params)
    yield e
    e.close()


def run_sched(side, eng, prompts, samp, *, overlap=False, plan=None, spec=None):
    Sched = JScheduler if side == "jax" else ContinuousBatchingScheduler
    Policy = JRecoveryPolicy if side == "jax" else RecoveryPolicy
    SP = JSamplingParams if side == "jax" else SamplingParams
    sched = Sched(eng, recovery=Policy(sleep=lambda _s: None), overlap=overlap)
    ctx = plan.active() if plan is not None else _null()
    with ctx:
        hs = [sched.submit(list(p), SP(**samp), speculation=spec) for p in prompts]
        for _ in range(2000):
            if all(h.done() for h in hs) or not sched.step():
                break
    return [h.result(timeout=0) for h in hs], sched


class _null:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


# ------------------------------------------------------------------ units
@pytest.mark.parametrize("kv_shards", [3, 0])
def test_from_budget_refusals_read_as_jaxs(kv_shards):
    """The repair: the port's refusals are the JAX package's, word for
    word (``validate_kv_shards``)."""
    msgs = []
    for C in (JCacheConfig, CacheConfig):
        with pytest.raises(ValueError) as e:
            C.from_budget(1 << 20, num_layers=2, num_heads=4, head_dim=8, block_size=16,
                          kv_shards=kv_shards)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    with pytest.raises(ValueError) as e:
        sharding.validate_kv_shards(4, kv_shards)
    assert str(e.value) == msgs[0]
    sharded = CacheConfig.from_budget(1 << 20, num_layers=2, num_heads=4, head_dim=8,
                                      block_size=16, kv_shards=4)
    base = CacheConfig.from_budget(1 << 20, num_layers=2, num_heads=4, head_dim=8,
                                   block_size=16)
    assert sharded.num_blocks == base.num_blocks * 4  # the same per-device budget


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_layout_describe_equals_jax(tp):
    j = jsharding.ServingLayout.build(num_heads=4, tp_degree=tp).describe()
    t = sharding.ServingLayout.build(num_heads=4, tp_degree=tp, devices=["cpu"] * tp)
    assert t.describe() == j
    with pytest.raises(ValueError, match="num_kv_heads % tp_degree"):
        sharding.ServingLayout.build(num_heads=4, tp_degree=3, devices=["cpu"] * 3)


def test_serving_mesh_transport_is_explicit():
    m = serving_mesh(2, ["cpu", "cpu"])
    assert (m.size, m.backend, m.shape) == (2, "gloo", {"model": 2})
    with pytest.raises(ValueError, match="serving mesh needs 3 devices, have 2"):
        serving_mesh(3, ["cpu", "cpu"])
    with pytest.raises(ValueError, match="needs CUDA devices"):
        serving_mesh(2, ["cpu", "cpu"], backend="nccl")
    # two ranks on one GPU: the caller must name gloo (never a quiet swap)
    with pytest.raises(ValueError, match="backend='gloo'"):
        serving_mesh(2, ["cuda:0", "cuda:0"])
    shared = serving_mesh(2, ["cuda:0", "cuda:0"], backend="gloo")
    assert shared.backend == "gloo" and shared.devices[1] == torch.device("cuda", 0)
    assert serving_mesh(2, ["cuda:0", "cuda:1"]).backend == "nccl"


def test_no_cpu_rank_unless_asked(monkeypatch, params):
    """The default ranks are GPUs: without one, a mesh or an engine asked
    for tp > 1 raises; CPU ranks only where the caller lists the CPU
    (``device="cpu"``)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="serving mesh needs 2 devices, have 0"):
        serving_mesh(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GenerationEngine(params[1], TCFG, tp_degree=2, **ENGINE_KW)


@pytest.mark.parametrize("heads,mesh", [(4, 4), (4, 3), (6, 8), (12, 2), (1, 8)])
def test_tp_candidates_equal_jax(heads, mesh):
    assert tss.tp_candidates(heads, mesh) == jss.tp_candidates(heads, mesh)


def _choice(c):
    return dataclasses.asdict(c)


def _same_choice(t, j):
    t, j = _choice(t), _choice(j)
    for key in ("prefill_s", "decode_s"):
        assert close(t.pop(key), j.pop(key)), key
    tc, jc = t.pop("candidates"), j.pop("candidates")
    assert t == j
    assert [c["tp_degree"] for c in tc] == [c["tp_degree"] for c in jc]
    for a, b in zip(tc, jc):
        for k in ("prefill_s", "decode_s", "blend_s"):
            assert close(a[k], b[k]), (a, b)


@pytest.mark.parametrize("pinned", [None, 2, 4])
def test_choose_serving_strategy_equals_jax(pinned):
    kw = dict(mesh_devices=4, max_batch_slots=4, pinned_tp=pinned)
    _same_choice(tss.choose_serving_strategy(TCFG, **kw), jss.choose_serving_strategy(JCFG, **kw))
    msgs = []
    for mod, cfg in ((jss, JCFG), (tss, TCFG)):
        with pytest.raises(ValueError, match="not a valid candidate") as e:
            mod.choose_serving_strategy(cfg, mesh_devices=4, pinned_tp=3)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("pins", [(None, None), (2, 1), (4, 2)])
def test_choose_pool_strategies_equals_jax(pins):
    kw = dict(mesh_devices=4, max_batch_slots=4, pinned_prefill_tp=pins[0],
              pinned_decode_tp=pins[1])
    t, j = tss.choose_pool_strategies(TCFG, **kw), jss.choose_pool_strategies(JCFG, **kw)
    assert set(t) == set(j) == {"prefill", "decode"}
    for pool in t:
        _same_choice(t[pool], j[pool])
    msgs = []
    for mod, cfg in ((jss, JCFG), (tss, TCFG)):
        with pytest.raises(ValueError) as e:
            mod.choose_pool_strategies(cfg, mesh_devices=2, pinned_decode_tp=3)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("kind", ["cpu", "TPU v5e", "NVIDIA H100 80GB HBM3"])
def test_chip_spec_at_mesh_geometry_equals_jax(kind):
    for n in (1, 2, 4):
        mk = tcal.mesh_device_kind(kind, n)
        assert mk == jcal.mesh_device_kind(kind, n)
        if "H100" not in kind:
            assert dataclasses.asdict(tcal.chip_spec_for(mk)) == dataclasses.asdict(
                jcal.chip_spec_for(mk))
    # the engine's serving roofline chip: peaks and capacity x the degree
    one, four = capacity.chip_spec_for(torch.device("cpu")), capacity.chip_spec_for(
        torch.device("cpu"), 4)
    assert four.name == "cpu x4"
    assert (four.f32_flops, four.bf16_flops, four.hbm_bandwidth, four.hbm_capacity) == (
        one.f32_flops * 4, one.bf16_flops * 4, one.hbm_bandwidth * 4, one.hbm_capacity * 4)


# ------------------------------------------------------------ the weights
def _jax_shards(jp, tp, cfg):
    lay = jsharding.ServingLayout.build(num_heads=cfg.num_heads, tp_degree=tp)
    return lay.shard_params(jp)


@pytest.mark.parametrize("tp,ff", [(2, 64), (4, 64), (4, 66)])
def test_rank_shards_equal_jaxs_addressable_shards(tp, ff):
    """Rank r's slice of every leaf JAX shards is JAX's addressable shard
    r, bit for bit; ``ff1_b`` (replicated in JAX, sliced by GSPMD in the
    computation) is the matching slice of JAX's bias; every replicated
    leaf is JAX's whole leaf. At ff 66 over 4 ranks the FFN stays whole."""
    kw = dict(CFG_KW, ff_size=ff)
    jcfg = JTransformerConfig(**kw)
    jp = jinit_decoder_params(jax.random.key(1), jcfg)
    tparams = decoder_params_from_numpy(jax.tree.map(np.asarray, jp))
    jsh = _jax_shards(jp, tp, jcfg)
    lay = sharding.ServingLayout.build(num_heads=4, tp_degree=tp, devices=["cpu"] * tp)
    ffn_split = ff % tp == 0
    assert lay.ffn_sharded(ff) == ffn_split
    for r in range(tp):
        mine = lay.shard_params(tparams, r)
        for name in ("tok_embed", "pos_embed", "final_ln_g", "final_ln_b", "lm_head"):
            assert np.array_equal(mine[name].numpy(), np.asarray(jp[name]))
        for li, (tl, jl) in enumerate(zip(mine["layers"], jsh["layers"])):
            split = {"wq", "wk", "wv", "wo"} | ({"ff1", "ff2"} if ffn_split else set())
            for name, leaf in jl.items():
                if name in split:
                    shard = next(s for s in leaf.addressable_shards
                                 if s.device == lay_device(leaf, r))
                    assert np.array_equal(tl[name].numpy(), np.asarray(shard.data)), name
                elif name == "ff1_b" and ffn_split:
                    n = ff // tp
                    assert np.array_equal(tl[name].numpy(),
                                          np.asarray(leaf)[r * n:(r + 1) * n])
                else:
                    assert np.array_equal(tl[name].numpy(), np.asarray(leaf)), name
                    assert tl[name].shape == tuple(leaf.shape)


def lay_device(leaf, r):
    """The device of rank r's shard in a JAX "model" mesh leaf."""
    return leaf.sharding.mesh.devices.reshape(-1)[r]


# ---------------------------------------------------- the sharded wrapper
def _kernel_inputs():
    # tests/test_mesh_generation.py's
    rs = np.random.RandomState(0)
    q = rs.randn(3, 4, 64).astype(np.float32)
    kc = rs.randn(6, 8, 4, 64).astype(np.float32)
    vc = rs.randn(6, 8, 4, 64).astype(np.float32)
    bt = rs.randint(0, 6, (3, 4)).astype(np.int32)
    cl = np.array([5, 17, 30], np.int32)
    return q, kc, vc, bt, cl


def test_sharded_decode_wrapper_equals_jax():
    from jax.sharding import Mesh

    q, kc, vc, bt, cl = _kernel_inputs()
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("model",))
    ref = jda.sharded_paged_decode_attention(*map(jax.numpy.asarray, (q, kc, vc, bt, cl)),
                                             mesh, interpret=True)
    t = [torch.from_numpy(a) for a in (q, kc, vc, bt, cl)]
    got = da.sharded_paged_decode_attention(*t, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5, rtol=0)
    # each rank's call over its own heads is its slice of the whole
    for r in range(4):
        heads = slice(r, r + 1)
        mine = da.sharded_paged_decode_attention(
            t[0][:, heads].contiguous(), t[1][:, :, heads].contiguous(),
            t[2][:, :, heads].contiguous(), t[3], t[4], 4, rank=r)
        assert torch.equal(mine, got[:, heads])


def test_sharded_append_wrapper_equals_jax():
    from jax.sharding import Mesh

    q, kc, vc, bt, cl = _kernel_inputs()
    rs = np.random.RandomState(1)
    qw = rs.randn(3, 5, 4, 64).astype(np.float32)
    # a 5-token window ending at each sequence's last position, one padding query
    pos = (cl[:, None] - 5 + np.arange(5)[None, :]).astype(np.int32)
    pos[0, 0] = -1
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("model",))
    ref = jda.sharded_paged_append_attention(*map(jax.numpy.asarray, (qw, kc, vc, bt, pos)),
                                             mesh, interpret=True)
    got = da.sharded_paged_append_attention(*(torch.from_numpy(a) for a in (qw, kc, vc, bt, pos)),
                                            2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5, rtol=0)


# ---------------------------------------------------------- the engines
def test_one_device_mesh_bit_for_bit(engines, params):
    """tp_degree=1 is the single-device engine, bit for bit (JAX's anchor);
    its streams are the JAX tp=1 engine's."""
    jp, tp_ = params
    legacy = GenerationEngine(tp_, TCFG, device="cpu", **ENGINE_KW)
    meshed = GenerationEngine(tp_, TCFG, device="cpu", tp_degree=1, **ENGINE_KW)
    jeng = engines.get("jax", 1)
    for mode in ("greedy", "temp"):
        a = legacy.generate(PROMPTS, SamplingParams(**MODES[mode]))
        b = meshed.generate(PROMPTS, SamplingParams(**MODES[mode]))
        assert a == b == jeng.generate(PROMPTS, JSamplingParams(**MODES[mode]))
        assert torch.equal(legacy.last_logits, meshed.last_logits)
    assert meshed.recompiles() == {} and meshed.trace_counts.get("decode", 0) == 1
    assert (meshed.tp_degree, meshed.mesh_devices, meshed._group) == (1, 1, None)


def test_strategy_in_ledger_as_jaxs(params):
    jp, tp_ = params
    sides = [JEngine(jp, JCFG, tp_degree=1, **ENGINE_KW),
             GenerationEngine(tp_, TCFG, device="cpu", tp_degree=1, **ENGINE_KW)]
    for eng, SP in zip(sides, (JSamplingParams, SamplingParams)):
        eng.generate([[1, 2, 3, 4]], SP(max_new_tokens=6))
        by_key = {e["key"]: e for e in eng.ledger.report()["entries"]}
        for key in ("serving_strategy:prefill", "serving_strategy:decode"):
            assert key in by_key and by_key[key]["alarm_enabled"] is False
        assert by_key["serving_strategy:decode"]["pairs"] >= 1
    pairs = [{e["key"]: e["pairs"] for e in eng.ledger.report()["entries"]
              if e["key"].startswith("serving_strategy")} for eng in sides]
    assert pairs[0] == pairs[1]


def test_collective_site_registered_and_inert_at_tp1(params):
    _, tp_ = params
    assert faults.GENERATION_COLLECTIVE == jfaults.GENERATION_COLLECTIVE
    assert faults.GENERATION_COLLECTIVE in faults.SITES
    eng = GenerationEngine(tp_, TCFG, device="cpu", tp_degree=1, **ENGINE_KW)
    plan = faults.FaultPlan(seed=0)
    plan.on(faults.GENERATION_COLLECTIVE, mode="error", error=RuntimeError("boom"), every=1)
    with plan.active():
        out = eng.generate([[1, 2, 3]], SamplingParams(max_new_tokens=4))
    assert len(out[0]) == 4 and plan.fired(faults.GENERATION_COLLECTIVE) == 0


@pytest.mark.parametrize("tp", [1, 2])
def test_gauges_and_metadata_equal_jaxs(engines, tp):
    jeng, teng = engines.get("jax", tp), engines.get("port", tp)
    jm, tm = JGenerationModel(jeng, name="lm"), GenerationModel(teng, name="lm")
    keys = ("mesh_devices", "tp_degree", "cache_shard_bytes", "cache_shard_heads")
    jg, tg = jm.stats.gauge_values(), tm.stats.gauge_values()
    assert {k: tg[k] for k in keys} == {k: jg[k] for k in keys}
    assert tg["cache_shard_heads"] == 4 // tp
    js, ts = jm.metadata()["serving_strategy"], tm.metadata()["serving_strategy"]
    assert ts["layout"] == js["layout"]
    assert {k: ts[k] for k in ("tp_degree", "mesh_devices")} == {
        k: js[k] for k in ("tp_degree", "mesh_devices")}
    assert ts["transport"] == "gloo" and ts["devices"] == ["cpu"] * tp
    assert ts["graphs"] is False  # the CPU's eager steps, at any degree
    tsearch, jsearch = dict(ts["search"]), dict(js["search"])
    for k in ("predicted_prefill_s", "predicted_decode_s"):
        assert close(tsearch.pop(k), jsearch.pop(k))
    tc, jc = tsearch.pop("candidates"), jsearch.pop("candidates")
    assert tsearch == jsearch and [c["tp_degree"] for c in tc] == [c["tp_degree"] for c in jc]


@pytest.mark.parametrize("tp", DEGREES)
def test_sampling_streams_equal_jax_tp(engines, tp):
    jeng, teng = engines.reference(tp), engines.get("port", tp)
    for mode, kw in MODES.items():
        want = jeng.generate(PROMPTS, JSamplingParams(**kw))
        assert teng.generate(PROMPTS, SamplingParams(**kw)) == want, mode
    assert teng.recompiles() == {}


@pytest.mark.parametrize("tp", DEGREES)
def test_speculation_equals_jax_tp(engines, tp):
    motif = [5, 9, 2]
    sp = [(motif * 8)[:17], (motif * 8)[:11]]
    g = MODES["greedy"]
    want = engines.reference(tp).generate(
        sp, JSamplingParams(**g), speculation=JSpeculationConfig(k=3, method="ngram"))
    teng = engines.get("port", tp)
    got = teng.generate(sp, SamplingParams(**g), speculation=SpeculationConfig(k=3, method="ngram"))
    assert got == want
    assert teng.step_counts["verify"] > 0 and teng.recompiles() == {}


@pytest.mark.parametrize("tp", DEGREES)
def test_prefix_cache_equals_jax_tp(engines, tp):
    tpl = [int(x) for x in np.random.RandomState(0).randint(1, 60, 24)]
    pp = [tpl + [7, 8], tpl + [9, 10, 11]]
    jeng, teng = engines.reference(tp), engines.get("port", tp)
    j0, t0 = jeng.prefix_cache.hits, teng.prefix_cache.hits
    want = jeng.generate(pp, JSamplingParams(**MODES["greedy"]))
    assert teng.generate(pp, SamplingParams(**MODES["greedy"])) == want
    assert teng.prefix_cache.hits - t0 == jeng.prefix_cache.hits - j0 >= 1


@pytest.mark.parametrize("tp", DEGREES)
def test_overlap_pipeline_equals_jax_tp(engines, tp):
    want, jsched = run_sched("jax", engines.reference(tp), PROMPTS, MODES["greedy"],
                             overlap=True)
    got, sched = run_sched("port", engines.get("port", tp), PROMPTS, MODES["greedy"],
                           overlap=True)
    assert got == want and sched.pipe_dispatches > 0
    assert sched.pipe_dispatches == jsched.pipe_dispatches


@pytest.mark.parametrize("nth", [(2,), (2, 3)], ids=["retry", "restart"])
@pytest.mark.parametrize("tp", DEGREES)
def test_collective_faults_recover_as_jax_tp(engines, tp, nth):
    """A failed collective at the 2nd step (retry) and at the 2nd and 3rd
    (restart + journal replay over every rank's shard): the streams are
    the fault-free run's and the recovery counters are JAX's tp=2
    engine's (its site fires only at tp > 1; the counters do not depend
    on the degree)."""
    g = MODES["greedy"]
    ref, _ = run_sched("port", engines.get("port", tp), PROMPTS, g)
    outs, stats = [], []
    for side, fmod in (("jax", jfaults), ("port", faults)):
        plan = fmod.FaultPlan(seed=0)
        plan.on(fmod.GENERATION_COLLECTIVE, mode="error",
                error=RuntimeError("collective down"), nth=nth)
        eng = engines.get("jax", 2) if side == "jax" else engines.get("port", tp)
        got, sched = run_sched(side, eng, PROMPTS, g, plan=plan)
        outs.append(got)
        stats.append(({f: getattr(sched.recovery_stats, f) for f in RECOVERY_FIELDS},
                      plan.fired(fmod.GENERATION_COLLECTIVE)))
    assert outs[0] == outs[1] == ref
    assert stats[0] == stats[1]
    if len(nth) == 2:
        assert stats[1][0]["recoveries"] >= 1


@pytest.mark.parametrize("tp", DEGREES)
def test_each_rank_holds_its_heads(engines, tp):
    teng = engines.get("port", tp)
    teng.reset_rank_counters()
    teng.generate(PROMPTS[:1], SamplingParams(max_new_tokens=3))
    info = teng.rank_info()
    assert [i["rank"] for i in info] == list(range(tp))
    for i in info:
        assert i["cache_heads"] == i["wq_heads"] == 4 // tp
        assert i["ff1_cols"] == 64 // tp
        # two reduces a layer, every step, on every rank
        assert i["collectives"]["all_reduce"] == info[0]["collectives"]["all_reduce"] > 0
    assert teng.cache.k.shape[3] == 4 // tp


@pytest.mark.parametrize("kv_dtype", ["FLOAT", "BFLOAT16"])
def test_wire_blocks_cross_the_ranks(engines, params, kv_dtype):
    """The handoff's wire keeps full-head blocks: an import scatters each
    rank its heads, a pack gathers them back, byte for byte (fp32, and a
    bf16 cache's uint16 bits); every rank's cache holds exactly its slice
    of each block, the swap-in and swap-out block programs agree, and a
    reset zeroes every rank's heads."""
    from flexflow_tpu_torch.core.types import DataType
    from flexflow_tpu_torch.generation.prefix import PackedBlock

    if kv_dtype == "FLOAT":
        eng = engines.get("port", 2)
    else:
        cc = CacheConfig(num_layers=2, num_heads=4, head_dim=8, num_blocks=12, block_size=8,
                         dtype=DataType.BFLOAT16)
        eng = GenerationEngine(params[1], TCFG, cache_config=cc, tp_degree=2, device="cpu",
                               **ENGINE_KW)
    try:
        rs = np.random.default_rng(0)
        shape = (2, 8, 4, 8)  # [L, block, H, D]
        dt = eng.cache.k.dtype
        blocks = []
        for _ in range(3):
            k, v = (torch.from_numpy(rs.standard_normal(shape).astype(np.float32)).to(dt)
                    for _ in range(2))
            blocks.append(PackedBlock(*(t.view(torch.int16).numpy().view(np.uint16)
                                        if dt == torch.bfloat16 else t.numpy()
                                        for t in (k, v))))
        eng.import_kv_blocks([3, 7, 5], blocks)
        payload = eng.pack_kv_blocks([3, 7, 5], 3 * 8)
        for sent, got in zip(blocks, payload.blocks):
            assert sent.host_k.tobytes() == got.host_k.tobytes()
            assert sent.host_v.tobytes() == got.host_v.tobytes()
        # rank 0's own cache: its two heads of block 7
        want = blocks[1].host_k[:, :, :2]
        mine = eng.cache.k[:, 7]
        mine = mine.view(torch.int16).numpy().view(np.uint16) if dt == torch.bfloat16 \
            else mine.numpy()
        assert np.array_equal(mine, want)
        # the host tier's single-block programs: swap-out read, swap-in write
        hk, hv = eng._read_block(5)
        assert hk.tobytes() == blocks[2].host_k.tobytes()
        eng._write_block(9, hk, hv)
        assert eng._read_block(9)[1].tobytes() == blocks[2].host_v.tobytes()
        eng._copy_block(9, 10)
        assert eng._read_block(10)[0].tobytes() == blocks[2].host_k.tobytes()
        info = eng.rank_info()
        assert [i["collectives"]["scatter"] > 0 and i["collectives"]["gather"] > 0
                for i in info] == [True, True]
        # reset zeroes every rank's shard, not rank 0's alone
        eng.reset()
        assert not eng._read_block(10)[0].any() and not eng._read_block(7)[1].any()
    finally:
        if kv_dtype != "FLOAT":
            eng.close()


def test_layout_search_takes_no_guid():
    """The search's proxy graphs give their guids back: a model built
    after an engine with mesh arguments gets the guids (and so the
    dropout keys) it would have got without it."""
    from flexflow_tpu_torch.core.graph import PCGraph

    before = next(PCGraph._guid_counter)
    PCGraph._guid_counter = itertools.count(before)
    tss.choose_serving_strategy(TCFG, mesh_devices=4, pinned_tp=2)
    assert next(PCGraph._guid_counter) == before
