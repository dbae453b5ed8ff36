"""Shared harness of the port's fleet tests: one case written once over a
:class:`FleetSide` (one package's fleet, scheduler, fault and serving
classes) runs through the JAX package's fleet and through the port's, so
a test can hold the port's streams, counters, router decisions, replica
states and reports against the reference's under the same plan.

Geometry: ``tests/test_fleet.py``'s (1 layer, hidden 16, vocab 40, 3
slots, blocks of 8, buckets 8/32/64, the default cache sizing). Both
packages take the same weights (the JAX ``jax.random.key(0)`` init,
converted for the port). A JAX fleet needs a distinct engine per replica,
and a fresh JAX engine compiles for seconds, so the JAX factories draw
from a pool kept per geometry: a :class:`Session` (one per test) hands
out pool engines in order, each ``reset()`` before reuse, so no two live
replicas of one test share an engine. The port builds fresh CPU engines.
"""
import jax
import numpy as np

from conftest import FakeClock
from flexflow_tpu.core.types import DataType as JDataType
from flexflow_tpu.generation import GenerationEngine as JEngine
from flexflow_tpu.generation import SamplingParams as JSamplingParams
from flexflow_tpu.generation import SpeculationConfig as JSpeculationConfig
from flexflow_tpu.generation import recovery as jrecovery
from flexflow_tpu.generation.cache import CacheConfig as JCacheConfig
from flexflow_tpu.models.transformer import TransformerConfig as JTransformerConfig
from flexflow_tpu.obs import prom as jprom
from flexflow_tpu.runtime import faults as jfaults
from flexflow_tpu.serving import InferenceServer as JInferenceServer
from flexflow_tpu.serving import fleet as jfleet
from flexflow_tpu.serving import resilience as jresilience
from flexflow_tpu.serving.generation import GenerationModel as JGenerationModel
from flexflow_tpu_torch.core.types import DataType
from flexflow_tpu_torch.generation import (
    CacheConfig,
    GenerationEngine,
    SamplingParams,
    SpeculationConfig,
    decoder_params_from_numpy,
)
from flexflow_tpu_torch.generation import recovery
from flexflow_tpu_torch.models.transformer import TransformerConfig
from flexflow_tpu_torch.obs import prom
from flexflow_tpu_torch.runtime import faults
from flexflow_tpu_torch.serving import InferenceServer
from flexflow_tpu_torch.serving import fleet
from flexflow_tpu_torch.serving import resilience
from flexflow_tpu_torch.serving.generation import GenerationModel
from torch_port_chaos import jparams

# tests/test_fleet.py's geometry
CFG = dict(num_layers=1, hidden_size=16, num_heads=2, ff_size=32, seq_length=64,
           vocab_size=40, causal=True)
BUCKETS = (8, 32, 64)
BLOCK = 8
PROMPTS = [[1, 2, 3], [4, 5, 6, 7], [9, 8, 7, 6, 5], [1, 2, 3, 4, 4]]


class FleetSide:
    """One package's classes, so a case is written once for both."""

    def __init__(self, name, fleet_mod, sampling, speculation, recovery_mod, faults_mod,
                 resilience_mod, model_cls, server_cls, prom_mod):
        self.name = name
        self.fleet = fleet_mod
        self.Fleet = fleet_mod.Fleet
        self.DisaggregatedFleet = fleet_mod.DisaggregatedFleet
        self.ReplicaState = fleet_mod.ReplicaState
        self.SamplingParams = sampling
        self.SpeculationConfig = speculation
        self.recovery = recovery_mod
        self.faults = faults_mod
        self.resilience = resilience_mod
        self.GenerationModel = model_cls
        self.InferenceServer = server_cls
        self.prom = prom_mod

    def policy(self, **kw):
        return self.recovery.RecoveryPolicy(sleep=lambda _s: None, **kw)

    def greedy(self, n=12):
        return self.SamplingParams(max_new_tokens=n)


JAX = FleetSide("jax", jfleet, JSamplingParams, JSpeculationConfig, jrecovery, jfaults,
                jresilience, JGenerationModel, JInferenceServer, jprom)
PORT = FleetSide("port", fleet, SamplingParams, SpeculationConfig, recovery, faults,
                 resilience, GenerationModel, InferenceServer, prom)

_POOLS = {}
_PORT_PARAMS = {}


def _engine_kwargs(side, slots, cfg, kw):
    """The engine's constructor kwargs: the geometry's, then ``kw``
    (``kv_dtype``: a DataType member's name for the cache, with the
    default sizing's 25 blocks)."""
    out = dict(max_batch_slots=slots, block_size=BLOCK, prompt_buckets=BUCKETS)
    kw = dict(kw)
    kv_dtype = kw.pop("kv_dtype", None)
    if kv_dtype is not None:
        cc, dt = (JCacheConfig, JDataType) if side is JAX else (CacheConfig, DataType)
        out["cache_config"] = cc(num_layers=cfg["num_layers"], num_heads=cfg["num_heads"],
                                 head_dim=cfg["hidden_size"] // cfg["num_heads"],
                                 block_size=BLOCK, num_blocks=25, dtype=dt[kv_dtype])
    out.update(kw)
    return out


class Session:
    """Engine factories for one test on one side (see the module doc)."""

    def __init__(self, side: FleetSide):
        self.side = side
        self.taken = {}

    def engine(self, slots=3, cfg=None, **kw):
        cfg = cfg or CFG
        key = (slots, tuple(sorted(cfg.items())), tuple(sorted(kw.items())))
        if self.side is JAX:
            pool = _POOLS.setdefault(key, [])
            i = self.taken.get(key, 0)
            self.taken[key] = i + 1
            if i < len(pool):
                pool[i].reset()
                return pool[i]
            eng = JEngine(jparams(cfg=cfg), JTransformerConfig(**cfg),
                          **_engine_kwargs(JAX, slots, cfg, kw))
            pool.append(eng)
            return eng
        pkey = tuple(sorted(cfg.items()))
        if pkey not in _PORT_PARAMS:
            _PORT_PARAMS[pkey] = decoder_params_from_numpy(
                jax.tree.map(np.asarray, jparams(cfg=cfg)))
        return GenerationEngine(_PORT_PARAMS[pkey], TransformerConfig(**cfg),
                                **_engine_kwargs(PORT, slots, cfg, kw), device="cpu")

    def factory(self, slots=3, cfg=None, **kw):
        return lambda: self.engine(slots, cfg, **kw)


def make_disagg(side, sess, *, clock=None, engine_kw=None, **kw):
    """``tests/test_disagg.py``'s make_disagg on ``side``: 1+1 pools, no
    handoff backoff (retries come due at once on a frozen clock)."""
    kw.setdefault("scheduler_kwargs", dict(recovery=side.policy()))
    kw.setdefault("handoff_backoff_s", 0.0)
    return side.DisaggregatedFleet(sess.factory(**(engine_kw or {})), n_prefill=1,
                                   n_decode=1, clock=clock or FakeClock(), **kw)


def make_fleet(side, sess, n=2, *, recovery=None, clock=None, slots=3, **fleet_kwargs):
    """``tests/test_fleet.py``'s make_fleet on ``side``."""
    clock = clock or FakeClock()
    kwargs = dict(fleet_kwargs.pop("scheduler_kwargs", {}))
    kwargs.setdefault("recovery", recovery if recovery is not None else side.policy())
    return side.Fleet(sess.factory(slots=slots), n, clock=clock, scheduler_kwargs=kwargs,
                      **fleet_kwargs)


def drive(stepper, handles, steps=500):
    for _ in range(steps):
        if all(h.done() for h in handles):
            return
        stepper()


def outcome(handle):
    """A request's tokens, or its failure's type name."""
    try:
        return handle.result(timeout=0)
    except Exception as e:  # noqa: BLE001 - the failure IS the outcome
        return type(e).__name__


def solo_reference(side, sess, prompts, samplings, speculation=None):
    """Fault-free per-request streams on one bare engine of ``side``."""
    eng = sess.engine()
    return [eng.generate([list(p)], s, speculation=speculation)[0]
            for p, s in zip(prompts, samplings)]


def fleet_view(f):
    """What a case holds equal between the packages about a fleet: its
    counters and router decisions, states, and each replica's id, state,
    queue depth, residents and recovery counters."""
    return {
        "stats": f.fleet_stats.snapshot(),
        "states": f.states(),
        "pending": len(f._pending),
        "replicas": [
            (r.id, r.state, len(r.scheduler._queue), len(r.scheduler._running),
             r.engine.allocator.num_free,
             {k: getattr(r.scheduler.recovery_stats, k)
              for k in ("recoveries", "replayed_tokens", "quarantined", "engine_failures",
                        "kv_imports", "kv_imports_rejected")})
            for r in f.replicas
        ],
    }


# flight-event and report fields that carry a process clock, a process-wide
# id or a random id (they differ between any two runs)
_VOLATILE = {"t", "seq", "request_id", "t_wall", "error", "journey_id"}


def scrub(obj):
    """``obj`` without its volatile fields (see ``_VOLATILE``), recursively."""
    if isinstance(obj, dict):
        return {k: scrub(v) for k, v in obj.items() if k not in _VOLATILE}
    if isinstance(obj, (list, tuple)):
        return [scrub(v) for v in obj]
    return obj


def both(case, *args, **kwargs):
    """Run ``case(side, sess, ...)`` on both sides; assert the port's
    result equals JAX's and return it."""
    j = case(JAX, Session(JAX), *args, **kwargs)
    p = case(PORT, Session(PORT), *args, **kwargs)
    assert p == j, _diff(p, j)
    return p


def _diff(p, j, path="$"):
    if isinstance(p, dict) and isinstance(j, dict):
        for k in sorted(set(p) | set(j), key=str):
            if p.get(k) != j.get(k):
                return _diff(p.get(k), j.get(k), f"{path}.{k}")
    if isinstance(p, list) and isinstance(j, list) and len(p) == len(j):
        for i, (a, b) in enumerate(zip(p, j)):
            if a != b:
                return _diff(a, b, f"{path}[{i}]")
    return f"{path}: port {p!r} != jax {j!r}"
