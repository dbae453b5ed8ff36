"""Capacity and compute observability (port of
``flexflow_tpu/obs/capacity.py``):

* :class:`CacheTelemetry` — KV-cache block accounting beyond the
  occupancy gauge: per-request block residency (built on demand from the
  scheduler's slot state), internal fragmentation, preempt-reclaim and
  trim counters, time-at-pressure on the scheduler's injectable clock,
  and admission-wait blame threaded into request traces
  (``GET /v2/debug/cache``, the ``flexflow_serving_cache_*`` families);
* :class:`ServingFlops` — the serving FLOPs and bytes model and its
  roofline: the prefix cache's swap-in-or-recompute decision
  (:meth:`~flexflow_tpu_torch.generation.engine.GenerationEngine.prefix_plan`),
  MFU, and the truth ledger's predicted step times;
* :class:`ProgramRegistry` — the engine's step programs (one captured
  CUDA graph per step signature on a GPU, one eager signature on the
  CPU) with their input signatures, capture counts and capture wall
  times; a new signature of a known program carries a blame string
  (``GET /v2/debug/programs``); :data:`GLOBAL_PROGRAMS` is the
  process-wide one the executors register under ``executor[n].*``.

The derates are the JAX package's search cost model's
(``flexflow_tpu/search/cost_model.py``), copied so the two engines take
the same decisions from the same sizes. The chip presets: ``cpu`` holds
the JAX package's nominal CPU peaks (so the port's CPU engine decides as
the JAX CPU engine does), ``h100`` the H100 SXM's datasheet figures.
"""
from __future__ import annotations

import dataclasses
import math
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence

import torch

from ..core.types import DataType

# utilization derates: achievable fraction of peak (the JAX search cost
# model's constants)
MXU_EFFICIENCY = 0.55
HBM_EFFICIENCY = 0.8
KERNEL_OVERHEAD = 2e-6  # fixed per-step launch overhead (s)


# --------------------------------------------------------------------------
# KV-cache block telemetry
# --------------------------------------------------------------------------


class CacheTelemetry:
    """Block-level cache accounting for one continuous-batching
    scheduler.

    The scheduler calls the ``note_*`` hooks from its loop thread only
    (plain int arithmetic, no locks needed under the GIL); ``report``
    builds the residency table on demand from the live slot states, so
    steady-state steps never touch per-request dicts.

    ``pressure_threshold``: the free-block fraction at or below which
    the cache counts as "under pressure"; :meth:`tick` integrates the
    time spent there on the scheduler's (possibly virtual) clock.
    """

    def __init__(
        self,
        allocator,
        clock: Callable[[], float] = time.monotonic,
        pressure_threshold: float = 0.10,
        enabled: bool = True,
        reclaimable: Optional[Callable[[], int]] = None,
    ):
        self.allocator = allocator
        self.clock = clock
        self.enabled = enabled
        self.pressure_threshold = pressure_threshold
        # blocks reclaimable on demand (unreferenced cached prefixes —
        # generation/prefix.py): available for admission, so a warm but
        # idle cache does not read as pressure
        self.reclaimable = reclaimable or (lambda: 0)
        # cumulative counters (loop-thread writes only)
        self.preempt_reclaimed_blocks = 0
        self.preempt_reclaims = 0
        self.trimmed_blocks = 0
        self.trims = 0
        self.admission_waits = 0  # distinct blocked->admitted episodes
        self.admission_wait_s = 0.0  # total time requests sat blocked on blocks
        self.last_wait_blame: Optional[str] = None
        self.time_at_pressure_s = 0.0
        self._last_tick: Optional[float] = None
        self._was_under = False

    @property
    def under_pressure(self) -> bool:
        """The most recent tick's pressure flag (free + reclaimable at
        or below the threshold) — the AdaptiveLimiter's cache-pressure
        input."""
        return self._was_under

    # ------------------------------------------------------------- hooks
    def tick(self) -> None:
        """Integrate time-at-pressure; called once per scheduler step."""
        if not self.enabled:
            return
        now = self.clock()
        if self._last_tick is not None and self._was_under:
            self.time_at_pressure_s += max(0.0, now - self._last_tick)
        total = self.allocator.num_total
        available = self.allocator.num_free + self.reclaimable()
        self._was_under = available <= total * self.pressure_threshold
        self._last_tick = now

    def note_preempt(self, n_blocks: int) -> None:
        if not self.enabled:
            return
        self.preempt_reclaims += 1
        self.preempt_reclaimed_blocks += n_blocks

    def note_trim(self, n_blocks: int) -> None:
        if not self.enabled:
            return
        self.trims += 1
        self.trimmed_blocks += n_blocks

    def note_admission_wait(self, wait_s: float, blocks_short: int) -> str:
        """One blocked->admitted episode completed; returns the blame
        string the scheduler attaches to the request's trace."""
        blame = (
            f"queued {wait_s * 1e3:.0f}ms waiting for "
            f"{max(1, blocks_short)} block(s)"
        )
        if not self.enabled:
            return blame
        self.admission_waits += 1
        self.admission_wait_s += max(0.0, wait_s)
        self.last_wait_blame = blame
        return blame

    # ------------------------------------------------------------ reports
    def fragmentation_slots(self, running: Sequence) -> int:
        """Internal fragmentation: token slots allocated but not holding
        live cache entries (lookahead + block rounding), summed over the
        running set."""
        bs = self.allocator.config.block_size
        return sum(max(0, len(s.blocks) * bs - s.cached_len) for s in running)

    def register_gauges(self, stats, running_fn: Callable[[], List]) -> None:
        """Prometheus series (``flexflow_serving_cache_*``): counters
        ride as gauges like the scheduler's other cumulative metrics."""
        alloc = self.allocator
        stats.add_gauge(
            "cache_frag_slots", lambda: self.fragmentation_slots(running_fn())
        )
        stats.add_gauge("cache_free_low_water", lambda: alloc.low_water)
        stats.add_gauge("cache_free_high_water", lambda: alloc.high_water)
        stats.add_gauge("cache_blocks_allocated_total", lambda: alloc.total_allocated)
        stats.add_gauge("cache_blocks_freed_total", lambda: alloc.total_freed)
        stats.add_gauge(
            "cache_preempt_reclaimed_blocks", lambda: self.preempt_reclaimed_blocks
        )
        stats.add_gauge("cache_trimmed_blocks", lambda: self.trimmed_blocks)
        stats.add_gauge("cache_pressure_time_s", lambda: self.time_at_pressure_s)
        stats.add_gauge("cache_admission_waits", lambda: self.admission_waits)
        stats.add_gauge("cache_admission_wait_s", lambda: self.admission_wait_s)

    def report(
        self, running: Sequence, queue_depth: int = 0, admitting=None,
        free: Optional[int] = None, prefix: Optional[Dict] = None,
    ) -> Dict:
        """The ``GET /v2/debug/cache`` payload: allocator state,
        watermarks, counters, and the per-request residency table.

        Residency invariant (tests/test_capacity.py): the table's
        PRIVATE block counts (``blocks - shared_blocks``) plus the
        prefix index's resident blocks sum to exactly ``used`` —
        shared blocks are counted once by the index however many
        sequences reference them. That includes an admission in
        flight — blocks are allocated BEFORE the prefill device call
        (seconds, on a cold compile), so ``admitting`` = (request,
        blocks) renders as a provisional ``"admitting": True`` row
        rather than a phantom block leak. Deduped by request id against
        ``running`` so a request is never counted twice. The invariant
        is exact whenever the loop thread is between transitions;
        callers racing the loop pass ``free`` read BEFORE snapshotting
        ``running`` so a request finishing mid-scrape makes the table
        at worst UNDERcount ``used`` by that one request's blocks
        (blocks counted used, row already gone) — never report freed
        blocks as still resident."""
        alloc = self.allocator
        cfg = alloc.config
        bs = cfg.block_size
        if free is None:
            free = alloc.num_free
        residency = []
        for s in sorted(running, key=lambda s: s.slot):
            allocated_slots = len(s.blocks) * bs
            # shared blocks are index-owned (prefix cache): counted in
            # the prefix tier's residency, not as this request's private
            # footprint — with sharing, per-row block counts can
            # legitimately sum past ``used``
            shared = len(getattr(s, "shared_idx", ()) or ())
            residency.append({
                "request_id": s.req.id,
                "slot": s.slot,
                "blocks": len(s.blocks),
                "shared_blocks": shared,
                "allocated_slots": allocated_slots,
                "live_tokens": s.cached_len,
                "frag_slots": max(0, allocated_slots - s.cached_len),
                "n_generated": s.req.n_generated,
                "preemptions": s.req.preemptions,
            })
        if admitting is not None:
            adm_req, adm_blocks = admitting
            if adm_req.id not in {r["request_id"] for r in residency}:
                allocated_slots = len(adm_blocks) * bs
                residency.append({
                    "request_id": adm_req.id,
                    "slot": None,
                    "blocks": len(adm_blocks),
                    "shared_blocks": 0,  # private (pre-prefill) blocks only
                    "allocated_slots": allocated_slots,
                    "live_tokens": 0,  # prefill still running
                    "frag_slots": allocated_slots,
                    "n_generated": adm_req.n_generated,
                    "preemptions": adm_req.preemptions,
                    "admitting": True,
                })
        total = alloc.num_total
        return {
            "config": {
                "num_blocks": cfg.num_blocks,
                "block_size": bs,
                "usable_tokens": cfg.usable_tokens,
                "bytes_per_block": cfg.bytes_per_block,
                "total_bytes": cfg.total_bytes,
            },
            "blocks": {
                "total": total,
                "free": free,
                "used": total - free,
                "low_water": alloc.low_water,
                "high_water": alloc.high_water,
                "allocated_total": alloc.total_allocated,
                "freed_total": alloc.total_freed,
                "reset_reclaimed_total": alloc.total_reset_reclaimed,
            },
            "fragmentation_slots": sum(r["frag_slots"] for r in residency),
            "occupancy": (total - free) / max(1, total),
            "pressure": {
                "threshold": self.pressure_threshold,
                "under_pressure": self._was_under,
                "time_at_pressure_s": self.time_at_pressure_s,
            },
            "counters": {
                "preempt_reclaims": self.preempt_reclaims,
                "preempt_reclaimed_blocks": self.preempt_reclaimed_blocks,
                "trims": self.trims,
                "trimmed_blocks": self.trimmed_blocks,
                "admission_waits": self.admission_waits,
                "admission_wait_s": self.admission_wait_s,
                "last_wait_blame": self.last_wait_blame,
            },
            "queue_depth": queue_depth,
            "residency": residency,
            # prefix-cache tiering (generation/prefix.py): the
            # conservation invariant becomes
            #   sum(row private blocks) + prefix resident == used
            # with host-tier bytes accounted separately from HBM
            "prefix_cache": prefix or {},
        }


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """Peak rates of one device, for the serving roofline."""

    name: str
    f32_flops: float  # FLOP/s
    hbm_bandwidth: float  # bytes/s
    hbm_capacity: float  # bytes
    bf16_flops: float  # FLOP/s, bf16 and fp16


CHIP_PRESETS = {
    # the JAX package's nominal CPU peaks (its calibration preset "cpu")
    "cpu": ChipSpec(name="cpu", f32_flops=1e11, hbm_bandwidth=2e10, hbm_capacity=16e9,
                    bf16_flops=5e10),
    # datasheet figures, H100 SXM: fp32 on the CUDA cores, the rate the
    # port's GEMMs run at (fp32, TF32 off); bf16 and fp16 dense on the
    # tensor cores
    "h100": ChipSpec(name="h100", f32_flops=67e12, hbm_bandwidth=3.35e12, hbm_capacity=80e9,
                     bf16_flops=989e12),
}

# the dtypes the roofline prices at 2 bytes and the chip's bf16 peak
_TWO_BYTE = (DataType.BFLOAT16, DataType.HALF)


def chip_spec_for(device: torch.device) -> ChipSpec:
    """The preset for the engine's device: ``cpu`` for the CPU, ``h100``
    for a CUDA device (the card the port is built for)."""
    return CHIP_PRESETS["cpu" if device.type == "cpu" else "h100"]


class ServingFlops:
    """Analytic per-step FLOPs and HBM bytes of the generation engine's
    steps, folded into per-token and per-context-position constants, at
    the KV cache's dtype: a bf16 or fp16 cache is priced at 2 bytes per
    element (weights and cache alike, as the JAX package's model does)
    and the chip's bf16 peak, a float32 cache at 4 bytes and the fp32
    peak.

    Per useful token (matmuls only, forward):
      qkv + out projections  8 * E^2          per layer
      FFN (two matmuls)      4 * E * F        per layer
      LM head                2 * E * V        once
    Per (token, live context position):
      QK^T + AV              4 * E            per layer
    """

    def __init__(
        self,
        num_layers: int,
        hidden_size: int,
        ff_size: int,
        vocab_size: int,
        dtype: DataType = DataType.FLOAT,
        chip: Optional[ChipSpec] = None,
    ):
        e, f, l, v = hidden_size, ff_size, num_layers, vocab_size
        self.per_token_flops = l * (8 * e * e + 4 * e * f) + 2 * e * v
        self.per_ctx_flops = l * 4 * e
        self.chip = chip or CHIP_PRESETS["h100"]
        two_byte = dtype in _TWO_BYTE
        self.peak_flops = self.chip.bf16_flops if two_byte else self.chip.f32_flops
        # each step streams the weights once and touches the KV cache per
        # live context position
        self.dtype_bytes = 2 if two_byte else 4
        self.param_count = 2 * v * e + l * (4 * e * e + 2 * e * f)
        self.param_bytes = self.param_count * self.dtype_bytes
        self.kv_bytes_per_pos = 2 * l * e * self.dtype_bytes  # k + v

    @classmethod
    def from_config(cls, cfg, dtype: DataType = DataType.FLOAT,
                    chip: Optional[ChipSpec] = None) -> "ServingFlops":
        """Build from a TransformerConfig (the engine's ``cfg``) and the
        KV cache's dtype."""
        return cls(
            num_layers=cfg.num_layers,
            hidden_size=cfg.hidden_size,
            ff_size=cfg.ff_size,
            vocab_size=cfg.vocab_size,
            dtype=dtype,
            chip=chip,
        )

    def prefill_flops(self, prompt_len: int) -> float:
        """One prompt of ``prompt_len`` true tokens; causal context sum
        n(n+1)/2."""
        n = max(0, prompt_len)
        return n * self.per_token_flops + self.per_ctx_flops * (n * (n + 1) // 2)

    def decode_flops(self, n_active: int, context_sum: int) -> float:
        """One decode step: ``n_active`` live tokens attending to
        ``context_sum`` live context positions in all."""
        return n_active * self.per_token_flops + self.per_ctx_flops * context_sum

    def verify_flops(self, n_tokens: int, context_sum: int) -> float:
        """One verify (or suffix prefill) step: ``n_tokens`` live window
        tokens attending to ``context_sum`` live positions in all."""
        return n_tokens * self.per_token_flops + self.per_ctx_flops * context_sum

    def prefill_bytes(self, prompt_len: int) -> float:
        n = max(0, prompt_len)
        return self.param_bytes + self.kv_bytes_per_pos * n

    def decode_bytes(self, n_active: int, context_sum: int) -> float:
        """Weights once, K/V read per live context position, K/V written
        per active token."""
        return self.param_bytes + self.kv_bytes_per_pos * (context_sum + n_active)

    def verify_bytes(self, n_tokens: int, context_sum: int) -> float:
        return self.param_bytes + self.kv_bytes_per_pos * (context_sum + n_tokens)

    def roofline_s(self, flops: float, bytes_hbm: float) -> float:
        """Predicted seconds of one step: the larger of the derated
        compute and memory times, plus the fixed overhead."""
        t_compute = flops / (self.peak_flops * MXU_EFFICIENCY)
        t_memory = bytes_hbm / (self.chip.hbm_bandwidth * HBM_EFFICIENCY)
        return max(t_compute, t_memory) + KERNEL_OVERHEAD


# --------------------------------------------------------------------------
# Step-program registry + new-signature blame
# --------------------------------------------------------------------------


@dataclasses.dataclass
class ProgramEntry:
    name: str
    signature: Dict[str, str]
    traces: int = 1
    compile_s: Optional[float] = None
    last_blame: Optional[str] = None


def _dtype_name(dt) -> str:
    """A dtype as the JAX package spells it: ``float32`` for numpy's and
    torch's alike (``torch.float32`` loses its module prefix)."""
    return str(dt).replace("torch.", "")


class _Scalar:
    shape = ()


def _leaves(x, nested: bool = False) -> list:
    """The array leaves of a nested dict / list / tuple; a number inside
    one counts as a 0-d leaf (the JAX package keeps such state, a step
    counter, as a 0-d array)."""
    if isinstance(x, dict):
        return [l for v in x.values() for l in _leaves(v, True)]
    if isinstance(x, (list, tuple)):
        return [l for v in x for l in _leaves(v, True)]
    if hasattr(x, "shape"):
        return [x]
    if nested and isinstance(x, (int, float)) and not isinstance(x, bool):
        return [_Scalar()]
    return []


def _summarize(x) -> str:
    """Compact signature for one step input: ``dtype[shape]`` for arrays
    and tensors, a leaf-count/element-count digest for nested dicts,
    lists and tuples of them, ``repr`` for scalars (the JAX package's
    spelling throughout)."""
    shape = getattr(x, "shape", None)
    if shape is not None:
        dt = _dtype_name(getattr(x, "dtype", "?"))
        return f"{dt}[{','.join(str(d) for d in shape)}]"
    leaves = _leaves(x)
    if leaves:
        elems = sum(math.prod(int(d) for d in l.shape) for l in leaves)
        return f"pytree({len(leaves)} leaves, {elems} elems)"
    return repr(x)[:40]


class ProgramRegistry:
    """Registry of the engine's and the executor's step programs with
    new-signature blame.

    ``note_trace(name, args)`` is called where the engine or the executor
    meets a step signature it has not run before (on a GPU the step that
    captures its CUDA graph). The first call registers the program's
    input signature; a later one diffs against it and produces a blame
    string naming the input that changed ("decode retraced: tables
    int32[4,8] -> int32[4,9]").

    ``on_retrace(name, blame)`` (optional) fires on every retrace; the
    scheduler points it at the flight recorder. Exceptions in the
    callback are swallowed: a logging hook must never break a step.
    """

    def __init__(self, max_retraces: int = 64,
                 clock: Callable[[], float] = time.time):
        # epoch clock for retrace-record stamps (operators correlate
        # them with logs); injectable so tests can pin it
        self._clock = clock
        self._lock = threading.Lock()
        self.entries: Dict[str, ProgramEntry] = {}  # guarded-by: _lock
        self.retraces: deque = deque(maxlen=max_retraces)  # guarded-by: _lock
        self.on_retrace: Optional[Callable[[str, str], None]] = None

    def note_trace(self, name: str, args: Dict[str, object]) -> Optional[str]:
        """Record one trace of ``name``; returns the blame string when
        this is a retrace, else None."""
        sig = {k: _summarize(v) for k, v in args.items()}
        with self._lock:
            entry = self.entries.get(name)
            if entry is None:
                self.entries[name] = ProgramEntry(name=name, signature=sig)
                return None
            entry.traces += 1
            diffs = []
            for k in sig:
                old = entry.signature.get(k)
                if old != sig[k]:
                    diffs.append(f"{k} {old if old is not None else '<absent>'} -> {sig[k]}")
            for k in entry.signature:
                if k not in sig:
                    diffs.append(f"{k} {entry.signature[k]} -> <absent>")
            if diffs:
                blame = f"{name} retraced: " + ", ".join(diffs)
            else:
                blame = f"{name} retraced: identical signature"
            entry.signature = sig
            entry.last_blame = blame
            self.retraces.append({
                "t": self._clock(),
                "program": name,
                "blame": blame,
                "traces": entry.traces,
            })
            cb = self.on_retrace
        if cb is not None:
            try:
                cb(name, blame)
            except Exception:
                pass  # observability must never break tracing
        return blame

    def set_compile_time(self, name: str, seconds: float) -> None:
        """Stamp the wall time of the host call that met the program's
        new signature: on a GPU the eager warm-up, the graph capture and
        the first replay."""
        with self._lock:
            entry = self.entries.get(name)
            if entry is not None:
                entry.compile_s = seconds

    def remove_namespace(self, prefix: str) -> None:
        """Drop every program named ``prefix`` or ``prefix.*`` (and its
        retrace records). Executors register under per-instance
        namespaces and evict them through a weakref finalizer, so a
        process that builds executors in a loop does not grow the global
        registry without bound."""
        dot = prefix + "."
        with self._lock:
            for name in [n for n in self.entries
                         if n == prefix or n.startswith(dot)]:
                del self.entries[name]
            kept = [r for r in self.retraces
                    if not (r["program"] == prefix or r["program"].startswith(dot))]
            self.retraces.clear()
            self.retraces.extend(kept)

    def snapshot(self) -> List[Dict]:
        with self._lock:
            return [
                {
                    "name": e.name,
                    "traces": e.traces,
                    "compile_s": e.compile_s,
                    "signature": dict(e.signature),
                    "last_blame": e.last_blame,
                }
                for e in sorted(self.entries.values(), key=lambda e: e.name)
            ]

    def recent_retraces(self) -> List[Dict]:
        with self._lock:
            return list(self.retraces)

    def trace_count(self, name: str) -> int:
        """Traces recorded for one program (0 if never traced) — callers
        compare before/after a host call to tell compiles from
        steady-state runs (the truth ledger excludes compile calls)."""
        with self._lock:
            entry = self.entries.get(name)
            return entry.traces if entry is not None else 0

    def total_retraces(self) -> int:
        with self._lock:
            return sum(max(0, e.traces - 1) for e in self.entries.values())


# Executor programs register here (runtime/executor.py); the server
# merges this registry into GET /v2/debug/programs under "executor".
GLOBAL_PROGRAMS = ProgramRegistry()
