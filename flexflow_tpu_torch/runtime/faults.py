"""Deterministic fault injection for chaos testing the generation stack
(the port's copy of ``flexflow_tpu/runtime/faults.py``).

Named injection sites are threaded through the hot paths, and a seedable
:class:`FaultPlan` decides, deterministically, which calls to a site
fail, stall, get delayed or get NaN-poisoned.

* **Zero cost when disabled.** ``inject(site, value)`` is one function
  call guarded by a module-global ``None`` check.
* **Deterministic under a fixed seed.** Probability triggers draw from a
  per-rule ``random.Random`` seeded from ``(plan seed, site, rule
  index)`` through string seeding (stable across processes). Call
  counting is per site and lock-protected, so a given single-threaded
  call sequence always fires the same faults.

Production call sites name a site by its module constant
(``faults.GENERATION_DECODE_STEP``), never by a raw string. The site
names are the JAX package's, so one plan description drives both
packages; the port fires the sites of :data:`SITES`.

**Scopes**: rules registered with ``scope=`` fire only inside
``with scope(name):`` and count their ``nth``/``every`` triggers per
(site, scope). A fleet replica's scheduler steps inside its replica id's
scope, so :func:`replica_kill` murders one replica deterministically.

Usage::

    plan = FaultPlan(seed=0)
    plan.on(GENERATION_DECODE_STEP, mode="error",
            error=TransientDeviceError("preempted"), nth=(0,))
    with plan.active():
        ...  # the first decode step raises, later ones succeed
    assert plan.fired(GENERATION_DECODE_STEP) == 1
"""
from __future__ import annotations

import contextlib
import dataclasses
import random
import threading
import time
from types import MappingProxyType
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

# --------------------------------------------------------------- registry
# the JAX package's site names, so a plan targets the same site in both
EXECUTOR_TRAIN_BATCH = "executor.train_batch"
EXECUTOR_PREDICT = "executor.predict"
ELASTIC_STEP = "elastic.step"
SERVING_MODEL_INFER = "serving.model.infer"
SERVING_BATCHER_DISPATCH = "serving.batcher.dispatch"
SERVING_ADMISSION = "serving.admission"
SERVING_REPOSITORY_LOAD = "serving.repository.load"
CHECKPOINT_SAVE = "checkpoint.save"
GENERATION_PREFILL = "generation.prefill"
GENERATION_DECODE_STEP = "generation.decode_step"
GENERATION_VERIFY = "generation.verify"
GENERATION_JOURNAL_REPLAY = "generation.journal_replay"
GENERATION_ASYNC_READBACK = "generation.async_readback"
GENERATION_COLLECTIVE = "generation.collective"
GENERATION_PREFIX_LOOKUP = "generation.prefix_lookup"
GENERATION_KV_OFFLOAD = "generation.kv_offload"
FLEET_ROUTE = "fleet.route"
FLEET_REPLICA_SPAWN = "fleet.replica_spawn"
FLEET_KV_HANDOFF = "fleet.kv_handoff"
GENERATION_KV_IMPORT = "generation.kv_import"
GENERATION_MASK_BUILD = "generation.mask_build"
GENERATION_MASK_ADVANCE = "generation.mask_advance"
SERVING_WAL_APPEND = "serving.wal_append"
SERVING_WAL_FSYNC = "serving.wal_fsync"
SERVING_WAL_REPLAY = "serving.wal_replay"

# the sites the port fires -> where (read-only)
SITES = MappingProxyType({
    EXECUTOR_TRAIN_BATCH: "before each train dispatch (value: inputs)",
    EXECUTOR_PREDICT: "around forward outputs (value: outputs)",
    ELASTIC_STEP: "top of each `ElasticTrainer` step",
    SERVING_MODEL_INFER: "before a served model's device call (value: inputs)",
    SERVING_BATCHER_DISPATCH: "before the batcher runs a device batch",
    SERVING_REPOSITORY_LOAD: "before a repository model load",
    CHECKPOINT_SAVE: "top of `save_checkpoint`",
    GENERATION_PREFILL: "before a generation prefill (value: prompt tokens)",
    GENERATION_DECODE_STEP: (
        "before each batched decode step (value: (slot tokens, per-slot "
        "logit bias); the tokens are None for a pipelined step whose tokens "
        "ride on the device; `nan` mode poisons the bias, per slot with "
        "`select`)"
    ),
    GENERATION_VERIFY: (
        "before each speculative verification step (value: (window tokens, "
        "per-slot logit bias))"
    ),
    GENERATION_JOURNAL_REPLAY: (
        "top of each supervisor journal-replay restart (an error here is a "
        "double fault)"
    ),
    GENERATION_ASYNC_READBACK: (
        "before the overlap pipeline consumes an in-flight decode step "
        "(value: ('decode', n_states)); an error discards the frontier and "
        "re-runs the step sequentially under the supervisor"
    ),
    GENERATION_COLLECTIVE: (
        "on rank 0 of a tensor-parallel (tp_degree > 1) engine, before each "
        "decode/verify step's command goes to the ranks (value: (step kind, "
        "tp_degree)); an error or stall here models a failed or wedged "
        "collective and routes through the supervisor's retry -> restart "
        "ladder with byte-exact journal replay (never fires at tp 1)"
    ),
    GENERATION_PREFIX_LOOKUP: (
        "before each radix prefix-index lookup at admission (value: prompt "
        "tokens); an error degrades to a cache miss — full recompute, "
        "byte-exact output"
    ),
    GENERATION_KV_OFFLOAD: (
        "around host-tier KV block swaps (value: ('in'|'out', n_blocks)); an "
        "error on swap-in falls back to recompute, on swap-out drops the "
        "block instead of offloading"
    ),
    GENERATION_MASK_BUILD: (
        "before a response_format grammar compiles into the per-model "
        "cache (value: the canonical spec key); an error fails the ONE "
        "submitting request with a typed 400, never the batch"
    ),
    GENERATION_MASK_ADVANCE: (
        "before each constrained-stream automaton advance over an emitted "
        "token — including journal-replay re-advances (value: (grammar "
        "state, token)); an error quarantines the one constrained request "
        "while the rest of the batch keeps streaming"
    ),
    FLEET_ROUTE: (
        "before each fleet routing decision (value: (prompt tokens, "
        "candidate replica ids))"
    ),
    FLEET_REPLICA_SPAWN: (
        "before a fleet replica is built/warmed (value: the new replica id); "
        "an error here is a failed replacement spawn"
    ),
    FLEET_KV_HANDOFF: (
        "around each per-block prefill->decode KV transfer (value: (host_k, "
        "host_v) wire arrays); `nan` mode corrupts the block in flight (CRC "
        "catches it on arrival), an error fails the attempt into bounded "
        "retry, a stall wedges the transfer until the deadline expires — "
        "every path terminates in decode-pool journal replay, byte-exact"
    ),
    GENERATION_KV_IMPORT: (
        "before the decode-side unpack of an imported KV payload (value: "
        "(request id, n_blocks)); an error rejects the import and the "
        "stream falls back to recompute-prefill on the decode replica"
    ),
    SERVING_ADMISSION: (
        "inside the generation scheduler's submit, before the overload "
        "gates (value: (priority, queue depth)); an error here is a forced "
        "admission failure, so chaos plans can drive the limiter/shed "
        "paths deterministically"
    ),
    SERVING_WAL_APPEND: (
        "before a durable-journal record is framed into the WAL buffer "
        "(value: the record type); an error degrades the ONE appending "
        "stream to non-durable with a counted warning — the decode hot "
        "path never blocks on the log"
    ),
    SERVING_WAL_FSYNC: (
        "around every WAL fsync — a paced background commit cycle or a "
        "blocking sync() (value: the commit frontier); an error is "
        "absorbed and counted — the next commit cycle retries and no "
        "caller ever sees it"
    ),
    SERVING_WAL_REPLAY: (
        "top of a warm restart's WAL replay, after the fingerprint check "
        "(value: unfinished streams found); an error fails the restart "
        "typed before any stream is re-admitted"
    ),
})


class FaultInjected(RuntimeError):
    """Generic injected failure (non-retryable poison)."""


class TransientDeviceError(RuntimeError):
    """Injected analog of a recoverable device fault (preemption,
    transport hiccup); retry policies treat this as retryable."""


# Module-global active plan. ``inject`` reads this exactly once per call;
# when no plan is installed the call is a no-op returning its value.
_PLAN: Optional["FaultPlan"] = None

# thread-local injection scope; only scoped rules read it
_SCOPE = threading.local()


class scope:
    """Tag injections on this thread with a label:
    ``with faults.scope("r1"): ...``. Rules with a matching ``scope``
    fire only inside; nesting restores the previous label on exit."""

    __slots__ = ("name", "_prev")

    def __init__(self, name: Optional[str]):
        self.name = name

    def __enter__(self) -> "scope":
        self._prev = getattr(_SCOPE, "name", None)
        _SCOPE.name = self.name
        return self

    def __exit__(self, *exc) -> None:
        _SCOPE.name = self._prev


def current_scope() -> Optional[str]:
    return getattr(_SCOPE, "name", None)


def replica_kill(
    plan: "FaultPlan",
    replica: str,
    *,
    site: str = GENERATION_DECODE_STEP,
    mode: str = "error",
    error: Any = None,
    gate: Optional[threading.Event] = None,
    nth=None,
    every: Optional[int] = None,
    max_fires: Optional[int] = None,
) -> "FaultPlan":
    """Chaos helper: deterministically murder ONE fleet replica
    mid-step. Registers a scoped rule on ``site`` (default: the batched
    decode step) that fires only for ``replica``'s own calls, with
    ``nth``/``every`` counted per replica — ``replica_kill(plan, "r1",
    every=1)`` fails every one of r1's decode steps until its restart
    budget exhausts and the fleet fails its streams over."""
    if error is None and mode == "error":
        error = RuntimeError(f"injected kill of replica {replica}")
    return plan.on(
        site, mode=mode, error=error, gate=gate, nth=nth, every=every,
        max_fires=max_fires, scope=replica,
    )


def inject(site: str, value: Any = None) -> Any:
    """Injection-site hook. Returns ``value`` (possibly poisoned), or
    raises / stalls per the active plan's rules for ``site``."""
    plan = _PLAN
    if plan is None:  # zero-cost no-op guard (hot path)
        return value
    return plan._fire(site, value)


def active_plan() -> Optional["FaultPlan"]:
    return _PLAN


def site_counters() -> Dict[str, Dict[str, int]]:
    """Per-site hit counters of the ACTIVE plan ({} when none is
    installed): ``{site: {"calls": times reached, "fires": rules
    fired}}``. Rendered on ``GET /metrics`` so chaos runs are visible to
    the same scrape as the serving counters they perturb."""
    plan = _PLAN
    if plan is None:
        return {}
    return plan.site_counters()


def _poison(value: Any, mask: Any = None) -> Any:
    """NaN-poison array-like leaves of ``value`` (lists/tuples of arrays,
    single arrays, dicts); non-float leaves pass through unchanged.
    ``mask`` (a bool array broadcastable against each float leaf, from a
    rule's ``select``) restricts the poison to the selected entries."""
    if isinstance(value, (list, tuple)):
        return type(value)(_poison(v, mask) for v in value)
    if isinstance(value, dict):
        return {k: _poison(v, mask) for k, v in value.items()}
    try:
        arr = np.asarray(value)
    except Exception:
        return value
    if arr.dtype.kind != "f":
        return value
    if mask is None:
        return np.full_like(arr, np.nan)
    m = np.asarray(mask, bool)
    # a select over higher-rank site data (a [B, W] verify-window mask
    # against the [B] bias leaf) collapses trailing dims: any hit in a
    # row poisons that row's slot
    while m.ndim > arr.ndim:
        m = m.any(axis=-1)
    return np.where(m, np.full_like(arr, np.nan), arr)


@dataclasses.dataclass(eq=False)  # identity equality: two identically
# configured rules must stay DISTINCT so each gets its own rng seed
class FaultRule:
    """One trigger at one site. All specified conditions must hold for
    the rule to fire on a given call."""

    site: str
    mode: str = "error"  # error | latency | nan | stall
    error: Any = None  # exception instance or class (error mode)
    latency_s: float = 0.01  # latency mode
    gate: Optional[threading.Event] = None  # stall mode: wait for this
    nth: Optional[Tuple[int, ...]] = None  # fire on these 0-based calls
    every: Optional[int] = None  # fire on every k-th call (1-based)
    probability: Optional[float] = None  # seeded coin flip
    when: Optional[Callable[[Any], bool]] = None  # predicate on value
    select: Optional[Callable[[Any], Any]] = None  # nan mode: per-entry mask
    scope: Optional[str] = None  # fire only inside with scope(name)
    max_fires: Optional[int] = None
    fires: int = 0


class FaultPlan:
    """A seedable registry of fault rules, installable as the process'
    active plan. Thread-safe: sites may be hit from several threads."""

    def __init__(self, seed: int = 0, sleep: Callable[[float], None] = time.sleep):
        self.seed = seed
        self._sleep = sleep
        self._rules: Dict[str, List[FaultRule]] = {}
        self._counts: Dict[str, int] = {}
        self._scope_counts: Dict[Tuple[str, str], int] = {}
        self._rngs: Dict[int, random.Random] = {}
        self._lock = threading.Lock()
        self.events: List[Tuple[str, int, str]] = []  # (site, call, mode)

    # ------------------------------------------------------------- config
    def on(
        self,
        site: str,
        mode: str = "error",
        *,
        error: Any = None,
        latency_s: float = 0.01,
        gate: Optional[threading.Event] = None,
        nth=None,
        every: Optional[int] = None,
        probability: Optional[float] = None,
        when: Optional[Callable[[Any], bool]] = None,
        select: Optional[Callable[[Any], Any]] = None,
        scope: Optional[str] = None,
        max_fires: Optional[int] = None,
    ) -> "FaultPlan":
        if mode not in ("error", "latency", "nan", "stall"):
            raise ValueError(f"unknown fault mode {mode!r}")
        if mode == "stall" and gate is None:
            raise ValueError("stall mode requires a gate Event")
        if select is not None and mode != "nan":
            raise ValueError("select only applies to nan mode")
        rule = FaultRule(
            site=site, mode=mode, error=error, latency_s=latency_s, gate=gate,
            nth=tuple(nth) if nth is not None else None, every=every,
            probability=probability, when=when, select=select, scope=scope,
            max_fires=max_fires,
        )
        self._rules.setdefault(site, []).append(rule)
        return self

    # ---------------------------------------------------------- lifecycle
    def install(self) -> "FaultPlan":
        global _PLAN
        _PLAN = self
        return self

    def remove(self) -> None:
        global _PLAN
        if _PLAN is self:
            _PLAN = None

    @contextlib.contextmanager
    def active(self):
        global _PLAN
        prev = _PLAN
        _PLAN = self
        try:
            yield self
        finally:
            _PLAN = prev

    # ------------------------------------------------------ observability
    def calls(self, site: str) -> int:
        """How many times ``site`` was reached (fired or not)."""
        with self._lock:
            return self._counts.get(site, 0)

    def fired(self, site: str) -> int:
        with self._lock:
            return sum(1 for s, _, _ in self.events if s == site)

    def site_counters(self) -> Dict[str, Dict[str, int]]:
        """Every site this plan has seen or configured: calls (reached)
        and fires (a rule actually triggered)."""
        with self._lock:
            sites = set(self._counts) | set(self._rules)
            fires: Dict[str, int] = {}
            for s, _, _ in self.events:
                fires[s] = fires.get(s, 0) + 1
            return {
                site: {"calls": self._counts.get(site, 0), "fires": fires.get(site, 0)}
                for site in sorted(sites)
            }

    # ------------------------------------------------------------- firing
    def _rng_for(self, rule: FaultRule) -> random.Random:
        key = id(rule)
        rng = self._rngs.get(key)
        if rng is None:
            # string seeding goes through the stable sha512 path
            rng = random.Random(f"{self.seed}|{rule.site}|{self._rules[rule.site].index(rule)}")
            self._rngs[key] = rng
        return rng

    def _matches(self, rule: FaultRule, call: int, value: Any) -> bool:
        if rule.max_fires is not None and rule.fires >= rule.max_fires:
            return False
        if rule.nth is not None and call not in rule.nth:
            return False
        if rule.every is not None and (call + 1) % rule.every != 0:
            return False
        if rule.probability is not None and not (
            self._rng_for(rule).random() < rule.probability
        ):
            return False
        if rule.when is not None and not rule.when(value):
            return False
        return True

    def _fire(self, site: str, value: Any) -> Any:
        sc = current_scope()
        with self._lock:
            call = self._counts.get(site, 0)
            self._counts[site] = call + 1
            scall = None
            if sc is not None:
                scall = self._scope_counts.get((site, sc), 0)
                self._scope_counts[(site, sc)] = scall + 1
            hits = []
            for r in self._rules.get(site, ()):
                if r.scope is not None:
                    # scoped rule: fires only inside its scope, with
                    # nth/every counted against the per-scope counter
                    if r.scope != sc:
                        continue
                    idx = scall
                else:
                    idx = call
                if self._matches(r, idx, value):
                    hits.append(r)
            for r in hits:
                r.fires += 1
                self.events.append((site, call, r.mode))
        # apply OUTSIDE the lock: latency/stall must not serialize other sites
        for r in hits:
            if r.mode == "error":
                err = r.error
                if err is None:
                    err = FaultInjected(f"injected fault at {site} (call {call})")
                elif isinstance(err, type):
                    err = err(f"injected {err.__name__} at {site} (call {call})")
                raise err
            if r.mode == "latency":
                self._sleep(r.latency_s)
            elif r.mode == "stall":
                r.gate.wait(timeout=30.0)  # bounded: a leaked gate must not hang tests
            elif r.mode == "nan":
                value = _poison(value, r.select(value) if r.select else None)
        return value
