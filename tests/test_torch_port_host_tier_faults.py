"""The prefix cache's fault sites and the host tier's truth-ledger pairs,
through the port and the JAX package on the CPU.

``generation.prefix_lookup`` fires before each radix lookup at admission
(a fault degrades it to a miss) and ``generation.kv_offload`` around each
host-tier block swap: ``("out", 1)`` before a swap-out read (a fault
drops the block instead of offloading it) and ``("in", 1)`` before a
swap-in write (a fault recomputes instead). Each case runs one host-tier
cycle through both schedulers under the same ``FaultPlan``
(``tests/torch_port_chaos.py``): a request registers two full prompt
blocks, they are evicted to the host tier, and a second request sharing
them is admitted. The port's streams, the plan's calls and fires per site
and the ``PrefixCache.snapshot()`` counters must equal the JAX engine's,
and every stream must equal the fault-free one (the faults are
byte-exact by design). Then the ``kv_swap_in`` pairs of the truth ledger
after such a cycle, against a fresh JAX engine's.
"""
import jax
import numpy as np
import pytest

import torch_port_chaos as chaos
from flexflow_tpu.generation import GenerationEngine as JEngine
from flexflow_tpu.generation.cache import CacheConfig as JCacheConfig
from flexflow_tpu.models.transformer import TransformerConfig as JTransformerConfig
from flexflow_tpu_torch.generation import CacheConfig, GenerationEngine, decoder_params_from_numpy
from flexflow_tpu_torch.models.transformer import TransformerConfig
from flexflow_tpu_torch.runtime import faults

pytestmark = pytest.mark.torch_port

SHARED = list(range(1, 17))  # two full blocks of 8
PROMPTS = [SHARED + [20], SHARED + [30]]
SAMPLING = dict(max_new_tokens=6)


def _cycle(side, sched, handles):
    """Finish the first request, evict its two cached blocks to the host
    tier, then admit the second (which shares them) and finish it."""
    chaos.drive(sched, handles)
    eng = sched.engine
    eng.prefix_cache.swap_overhead_s = 0.0  # the swap-in beats recomputing two blocks
    assert eng.reclaim_cached(2) == 2
    handles.append(sched.submit(PROMPTS[1], side.SamplingParams(**SAMPLING)))
    chaos.drive(sched, handles)


def _case(plan=None):
    return chaos.both(PROMPTS[:1], SAMPLING, overlap=False, plan=plan, steer=_cycle,
                      prefix_cache=True)


def _swaps(direction):
    return lambda value: value[0] == direction


@pytest.fixture(scope="module")
def fault_free():
    outcomes, counters, _, _ = _case()
    assert counters["prefix"]["swaps_out_total"] == 2
    assert counters["prefix"]["swaps_in_total"] == 2
    return outcomes


@pytest.mark.parametrize("case", ["lookup", "swap_out", "swap_in"])
def test_prefix_fault_sites_fire_as_in_jax(fault_free, case):
    site, kw, counter = {
        "lookup": (faults.GENERATION_PREFIX_LOOKUP, dict(nth=(1,)), "recompute_fallbacks"),
        "swap_out": (faults.GENERATION_KV_OFFLOAD, dict(when=_swaps("out"), max_fires=1),
                     "evicted_total"),
        "swap_in": (faults.GENERATION_KV_OFFLOAD, dict(when=_swaps("in")), "swap_in_failures"),
    }[case]
    assert site in faults.SITES

    def plan(side):
        return side.faults.FaultPlan(seed=0).on(site, error=RuntimeError(case), **kw)

    outcomes, counters, _, _ = _case(plan)
    assert outcomes == fault_free  # the same tokens, faults or not
    assert counters["sites"][site]["fires"] >= 1
    assert counters["prefix"][counter] >= 1
    if case == "lookup":  # the failed lookup is a miss: nothing reused
        assert counters["prefix"]["hits"] == 0
    elif case == "swap_out":  # one block dropped, one offloaded
        assert counters["prefix"]["swaps_out_total"] == 1
    else:
        assert counters["prefix"]["swaps_in_total"] == 0


def test_swap_ins_pair_in_the_truth_ledger_as_in_jax():
    """After a host-tier cycle (two cycles of two swap-ins), both engines'
    ledgers hold ``kv_swap_in`` with JAX's label and provenance and the
    same number of pairs: the first block write is the JAX engine's
    compile, kept out of its ledger, and the port keeps it out too."""
    cfg = dict(chaos.CFG_KW)
    jeng = JEngine(chaos.jparams(cfg=cfg), JTransformerConfig(**cfg),
                   cache_config=JCacheConfig(num_layers=1, num_heads=2, head_dim=16,
                                             block_size=chaos.BLOCK, num_blocks=40),
                   max_batch_slots=3, prompt_buckets=chaos.BUCKETS, prefix_cache=True)
    eng = GenerationEngine(decoder_params_from_numpy(jax.tree.map(np.asarray, chaos.jparams())),
                           TransformerConfig(**cfg),
                           cache_config=CacheConfig(num_layers=1, num_heads=2, head_dim=16,
                                                    block_size=chaos.BLOCK, num_blocks=40),
                           max_batch_slots=3, prompt_buckets=chaos.BUCKETS, prefix_cache=True,
                           device="cpu")
    reports = []
    for side, engine in ((chaos.JAX, jeng), (chaos.PORT, eng)):
        engine.prefix_cache.swap_overhead_s = 0.0
        sched = side.Scheduler(engine, overlap=False, recovery=side.no_sleep(),
                               clock=chaos.FakeClock())
        for tail in (20, 30, 40):
            h = sched.submit(SHARED + [tail], side.SamplingParams(**SAMPLING))
            chaos.drive(sched, [h])
            h.result(timeout=0)
            if tail != 40:
                assert engine.reclaim_cached(2) == 2
        assert engine.prefix_cache.swaps_in_total == 4
        reports.append({e["key"]: e for e in engine.ledger.report()["entries"]})
    jrep, rep = reports
    want = jrep["kv_swap_in"]
    got = rep["kv_swap_in"]
    assert (got["label"], got["provenance"], got["pairs"]) == (
        want["label"], want["provenance"], want["pairs"]) == (
        "kv_swap_in (host tier)", "host-tier transfer model (link bytes/s)", 3)
    assert got["predicted_s"] == pytest.approx(want["predicted_s"], rel=1e-12)
