"""Shared harness of the port's overlap and recovery tests: one case
(prompts, sampling, a fault plan, scheduler options, how to step it) run
through the JAX package's scheduler and through the port's, so a test
can hold the port's streams AND counters (engine resets, recovery
stats, pipeline dispatches/drains/discards, fault-site calls and fires)
against the reference's under the same plan.

The JAX engines are built once per geometry and reused (``reset()``
between runs, counted out of ``resets``): a JAX engine's first run
compiles its programs, a reused one's takes milliseconds. The port's
engines are built per run (on the CPU that costs nothing).
"""
import contextlib

import jax
import numpy as np

from conftest import FakeClock
from flexflow_tpu.generation import ContinuousBatchingScheduler as JScheduler
from flexflow_tpu.generation import GenerationEngine as JEngine
from flexflow_tpu.generation import SamplingParams as JSamplingParams
from flexflow_tpu.generation import SpeculationConfig as JSpeculationConfig
from flexflow_tpu.generation import init_decoder_params as jinit_decoder_params
from flexflow_tpu.generation import recovery as jrecovery
from flexflow_tpu.core.types import DataType as JDataType
from flexflow_tpu.generation.cache import CacheConfig as JCacheConfig
from flexflow_tpu.models.transformer import TransformerConfig as JTransformerConfig
from flexflow_tpu.runtime import faults as jfaults
from flexflow_tpu.serving import resilience as jresilience
from flexflow_tpu_torch.core.types import DataType
from flexflow_tpu_torch.generation import (
    CacheConfig,
    ContinuousBatchingScheduler,
    GenerationEngine,
    SamplingParams,
    SpeculationConfig,
    decoder_params_from_numpy,
)
from flexflow_tpu_torch.generation import recovery
from flexflow_tpu_torch.models.transformer import TransformerConfig
from flexflow_tpu_torch.runtime import faults
from flexflow_tpu_torch.serving import resilience

CFG_KW = dict(
    num_layers=1, hidden_size=32, num_heads=2, ff_size=128,
    seq_length=64, vocab_size=64, causal=True,
)
BLOCK = 8
BUCKETS = (8, 16, 32, 64)
RECOVERY_FIELDS = ("recoveries", "step_retries", "replayed_tokens", "quarantined",
                   "watchdog_trips", "engine_failures")
# the scheduler's constrained-decoding counters (the grammar cache's live
# on the cache's own stats object)
CONSTRAINED_FIELDS = ("masked_steps", "dead_end_failures")
# PrefixCache.snapshot(): the cumulative counters (a reused JAX engine
# carries its earlier runs' in them, so a run counts their growth) and
# the gauges of the index at the end of the run
PREFIX_TOTALS = ("lookups", "hits", "tokens_reused_total", "blocks_reused_total",
                 "cow_copies_total", "swaps_in_total", "swaps_out_total", "swap_in_failures",
                 "recompute_fallbacks", "registered_total", "evicted_total")
PREFIX_GAUGES = ("enabled", "resident_blocks", "offloaded_blocks", "shared_blocks", "host_bytes")


class Side:
    """One package's classes, so a case is written once for both."""

    def __init__(self, name, scheduler, sampling, speculation, faults_mod, resilience_mod,
                 recovery_mod):
        self.name = name
        self.Scheduler = scheduler
        self.SamplingParams = sampling
        self.SpeculationConfig = speculation
        self.faults = faults_mod
        self.resilience = resilience_mod
        self.recovery = recovery_mod

    def no_sleep(self, **kw):
        return self.recovery.RecoveryPolicy(sleep=lambda _s: None, **kw)


JAX = Side("jax", JScheduler, JSamplingParams, JSpeculationConfig, jfaults, jresilience,
           jrecovery)
PORT = Side("port", ContinuousBatchingScheduler, SamplingParams, SpeculationConfig, faults,
            resilience, recovery)

_JPARAMS = {}
_JENGINES = {}


def jparams(nan: bool = False, cfg=None):
    """The JAX parameters of ``cfg`` (TransformerConfig kwargs; default
    ``CFG_KW``) from ``jax.random.key(0)``, NaN everywhere with ``nan``."""
    cfg = cfg or CFG_KW
    key = tuple(sorted(cfg.items()))
    if key not in _JPARAMS:
        _JPARAMS[key] = jinit_decoder_params(jax.random.key(0), JTransformerConfig(**cfg))
    p = _JPARAMS[key]
    if nan:
        return jax.tree_util.tree_map(lambda a: np.asarray(a) * np.nan, p)
    return p


def engine(side: Side, *, slots=3, num_blocks=40, prefix_cache=False, donate=None,
           nan=False, cfg=None, kv_dtype="FLOAT"):
    """An engine of the tiny config (``cfg``: other TransformerConfig
    kwargs) over a KV cache of ``kv_dtype`` (a DataType member's name,
    the same in both packages) and its ``resets`` before the run."""
    cfg = cfg or CFG_KW
    if side is JAX:
        key = (slots, num_blocks, prefix_cache, donate, nan, tuple(sorted(cfg.items())),
               kv_dtype)
        eng = _JENGINES.get(key)
        if eng is None:
            cc = JCacheConfig(num_layers=cfg["num_layers"], num_heads=cfg["num_heads"],
                              head_dim=cfg["hidden_size"] // cfg["num_heads"],
                              block_size=BLOCK, num_blocks=num_blocks,
                              dtype=JDataType[kv_dtype])
            eng = _JENGINES[key] = JEngine(
                jparams(nan, cfg), JTransformerConfig(**cfg), cache_config=cc,
                max_batch_slots=slots, prompt_buckets=BUCKETS, prefix_cache=prefix_cache,
                donate_cache=donate,
            )
        else:
            eng.reset()  # a fresh cache, allocator and prefix index
        return eng, eng.resets
    cc = CacheConfig(num_layers=cfg["num_layers"], num_heads=cfg["num_heads"],
                     head_dim=cfg["hidden_size"] // cfg["num_heads"],
                     block_size=BLOCK, num_blocks=num_blocks, dtype=DataType[kv_dtype])
    params = decoder_params_from_numpy(jax.tree.map(np.asarray, jparams(nan, cfg)))
    eng = GenerationEngine(params, TransformerConfig(**cfg), cache_config=cc,
                           max_batch_slots=slots, prompt_buckets=BUCKETS,
                           prefix_cache=prefix_cache, device="cpu", donate=donate)
    return eng, 0


def outcome(handle):
    """A request's tokens, or its failure as (type name, step, reason)."""
    try:
        return handle.result(timeout=0)
    except Exception as e:  # noqa: BLE001 - the failure IS the outcome
        return (type(e).__name__, getattr(e, "step", None), getattr(e, "reason", None))


def drive(sched, handles, steps=2000):
    for _ in range(steps):
        if all(h.done() for h in handles):
            return
        if not sched.step():
            return


def run(side: Side, prompts, sampling, *, overlap, spec=None, plan=None, sched_kw=None,
        steer=None, submit=None, **engine_kw):
    """Run one case on ``side``. ``sampling``: SamplingParams kwargs (one
    dict, or one per prompt); ``spec``: SpeculationConfig kwargs;
    ``plan(side)`` builds the FaultPlan; ``sched_kw(side, clock)`` the
    extra scheduler kwargs (``clock`` is the run's virtual clock);
    ``steer(side, sched, handles)`` replaces the run-to-completion loop;
    ``submit(side, sched, i, prompt, sampling)`` replaces the plain
    submit. Returns (outcomes, counters, engine, scheduler)."""
    eng, r0 = engine(side, **engine_kw)
    prefix0 = eng.prefix_cache.snapshot()
    clock = FakeClock()
    kw = {"recovery": side.no_sleep(), "clock": clock}
    kw.update(sched_kw(side, clock) if sched_kw else {})
    sched = side.Scheduler(eng, overlap=overlap, **kw)
    samplings = sampling if isinstance(sampling, list) else [sampling] * len(prompts)
    fp = plan(side) if plan is not None else None
    speculation = side.SpeculationConfig(**spec) if spec is not None else None
    with (fp.active() if fp is not None else contextlib.nullcontext()):
        handles = []
        for i, (p, s) in enumerate(zip(prompts, samplings)):
            sp = side.SamplingParams(**s)
            if submit is not None:
                handles.append(submit(side, sched, i, p, sp))
            else:
                handles.append(sched.submit(p, sp, speculation=speculation))
        if steer is not None:
            steer(side, sched, handles)
        else:
            drive(sched, handles)
    counters = {
        "resets": eng.resets - r0,
        "recovery": {f: getattr(sched.recovery_stats, f) for f in RECOVERY_FIELDS},
        "constrained": {f: getattr(sched.constrained_stats, f) for f in CONSTRAINED_FIELDS},
        "pipe_dispatches": sched.pipe_dispatches,
        "pipe_drains": dict(sched.pipe_drains),
        "pipe_discards": sched.pipe_discards,
        "preemptions": sched.preemptions,
        "prefix": _prefix_counters(prefix0, eng.prefix_cache.snapshot()),
        # the sites the port fires (the overload admission site included)
        "sites": {k: v for k, v in (fp.site_counters() if fp is not None else {}).items()
                  if k in faults.SITES},
    }
    return [outcome(h) for h in handles], counters, eng, sched


def _prefix_counters(before, after):
    return {**{k: after[k] - before[k] for k in PREFIX_TOTALS},
            **{k: after[k] for k in PREFIX_GAUGES}}


def both(prompts, sampling, *, overlap, **kw):
    """The case on both sides; asserts the port's outcomes and counters
    equal JAX's and returns (outcomes, counters, port engine, port
    scheduler)."""
    j_out, j_cnt, _, _ = run(JAX, prompts, sampling, overlap=overlap, **kw)
    p_out, p_cnt, eng, sched = run(PORT, prompts, sampling, overlap=overlap, **kw)
    assert p_out == j_out
    assert p_cnt == j_cnt, {k: (p_cnt[k], j_cnt[k]) for k in p_cnt if p_cnt[k] != j_cnt[k]}
    return p_out, p_cnt, eng, sched
