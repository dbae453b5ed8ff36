"""GenerationModel: the servable generation engine (port of
``flexflow_tpu/serving/generation.py``).

A GenerationModel owns a ContinuousBatchingScheduler
(``generation/scheduler.py``): requests join the running decode batch at
iteration granularity and stream tokens back as they are produced. The
HTTP front end (``serving/server.py``) serves it on
``POST /v2/models/{name}/generate`` (JSON, or SSE when streaming) with the
typed status mapping of the scheduler's ResilienceErrors (backpressure
503 with ``Retry-After``, expired deadline 504, open breaker 503).

The scheduler is self-healing (``generation/recovery.py``), so
``ready()`` (``/v2/health/ready``, ``/v2/models/{name}/ready``) reflects
a hung or dead engine; the recovery, overload, SLO, constrained-decoding
and prefix-cache counters ride the model's block on ``GET /v2/stats``.
``response_format`` grammars compile through the model's
:class:`GrammarCache` against its vocabulary before the request is
queued. ``enable_durability`` attaches a crash-safe WAL journal
(``serving/durable.py``): every admission journals into the WAL,
``self.durable.warm_restart()`` replays a predecessor's journal from the
same directory, and ``GET /v2/generate/resume/{id}`` re-attaches
clients. The scheduler's journey recorder (and, with durability, the
journey spool) feed ``GET /v2/debug/journey/{id}``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from ..generation.constrained import (
    GrammarCache,
    GrammarError,
    default_vocabulary,
)
from ..generation.engine import GenerationEngine, SamplingParams
from ..generation.scheduler import ContinuousBatchingScheduler, GenerationHandle
from ..generation.speculative import SpeculationConfig


class GenerationModel:
    """One servable generation engine: name + scheduler + health view."""

    def __init__(
        self,
        engine: GenerationEngine,
        name: str = "generator",
        vocabulary: Optional[Sequence[str]] = None,
        **scheduler_kwargs,
    ):
        self.engine = engine
        self.name = name
        self.scheduler = ContinuousBatchingScheduler(engine, **scheduler_kwargs)
        # response_format grammars compile against THIS model's token
        # texts; no tokenizer ships with the engine, so the synthetic
        # default vocabulary stands in unless the deployment passes one
        self.vocabulary: List[str] = list(
            vocabulary
            if vocabulary is not None
            else default_vocabulary(engine.cfg.vocab_size)
        )
        self.grammar_cache = GrammarCache(
            self.vocabulary, stats=self.scheduler.constrained_stats
        )
        # durable serving: set by enable_durability()
        self.durable = None

    # --------------------------------------------------------- lifecycle
    def start(self) -> None:
        self.scheduler.start()

    def stop(self, drain: bool = True) -> None:
        self.scheduler.stop(drain=drain)
        if self.durable is not None:
            self.durable.close()

    def enable_durability(self, config) -> "Durability":  # noqa: F821
        """Attach a crash-safe WAL journal to this model's scheduler
        (``serving/durable.py``). Call before traffic; follow with
        ``self.durable.warm_restart()`` to replay a predecessor's journal
        from the same directory."""
        from .durable import Durability  # late: keeps the tier optional

        self.durable = Durability(self.scheduler, config, grammar_cache=self.grammar_cache)
        return self.durable

    def ready(self) -> bool:
        return self.scheduler.ready()

    @property
    def breaker(self):
        return self.scheduler.breaker

    @property
    def stats(self):
        return self.scheduler.stats

    @property
    def recovery_stats(self):
        return self.scheduler.recovery_stats

    @property
    def trace_ring(self):
        """Recently finished RequestTraces (GET /v2/debug/traces)."""
        return self.scheduler.trace_ring

    @property
    def journeys(self):
        """The scheduler's journey span recorder (None when journeys are
        off): one lane of the stitched timeline (GET /v2/debug/journey/{id})."""
        return self.scheduler.journeys

    @property
    def journey_spool(self):
        """The on-disk journey span ring (set by enable_durability)
        keeping pre-crash spans joinable after process death."""
        rec = self.scheduler.journeys
        return rec.spool if rec is not None else None

    def journey_recorders(self):
        """The recorders the server's journey index stitches."""
        rec = self.scheduler.journeys
        return [rec] if rec is not None else []

    def journey_spools(self):
        spool = self.journey_spool
        return [spool] if spool is not None else []

    @property
    def flight(self):
        """The engine flight recorder (GET /v2/debug/timeline)."""
        return self.scheduler.flight

    @property
    def capacity(self):
        """KV-cache block telemetry (GET /v2/debug/cache)."""
        return self.scheduler.capacity

    @property
    def anatomy(self):
        """The step-anatomy profiler: phase histograms, device-bubble
        accounting, overlap headroom, and the on-demand two-lane
        capture (GET /v2/debug/anatomy)."""
        return self.scheduler.anatomy

    @property
    def programs(self):
        """The engine's step-program registry (GET /v2/debug/programs)."""
        return self.engine.programs

    @property
    def slo(self):
        """The SLO burn-rate monitor (GET /v2/slo)."""
        return self.scheduler.slo

    @property
    def ledger(self):
        """Cost-model truth ledger: per-step (predicted, measured)
        pairs + drift alarms (GET /v2/debug/predictions)."""
        return self.engine.ledger

    @property
    def goodput(self):
        return self.scheduler.goodput

    @property
    def overload(self):
        """The overload controller: priority-aware admission, the AIMD
        concurrency limiter, and the degradation ladder
        (GET /v2/overload)."""
        return self.scheduler.overload

    def overload_report(self):
        return self.scheduler.overload.report()

    def cache_report(self):
        return self.scheduler.cache_report()

    def readiness_rationale(self) -> Dict:
        """Why (or why not) this model is ready: breaker state, watchdog
        evidence, and SLO burn — the three health inputs. A breaching
        SLO explains degradation in the rationale without flipping
        readiness (a latency regression is not an outage)."""
        rs = self.scheduler.recovery_stats
        return {
            "ready": self.ready(),
            "breaker": self.breaker.state,
            "draining": self.scheduler._draining,
            "watchdog_trips": rs.watchdog_trips,
            "engine_failures": rs.engine_failures,
            "slo_breaching": self.scheduler.slo.breaching(),
            # degraded-but-up: a nonzero ladder level explains reduced
            # QoS in the rationale without flipping readiness
            "degrade_level": self.scheduler.overload.ladder.level,
        }

    # --------------------------------------------------------------- run
    def submit(
        self,
        prompt: Sequence[int],
        sampling: Optional[SamplingParams] = None,
        deadline_s: Optional[float] = None,
        speculation: Optional[SpeculationConfig] = None,
        transport: Optional[str] = None,
        priority: Optional[str] = None,
        response_format: Optional[Dict] = None,
        journey=None,
    ) -> GenerationHandle:
        grammar = None
        if response_format is not None:
            # compiles (or cache-hits) BEFORE the request joins the
            # queue: a malformed grammar is the submitter's 400, it
            # never reaches the batch
            grammar = self.grammar_cache.get(response_format)
        handle = self.scheduler.submit(
            prompt, sampling, deadline_s=deadline_s, speculation=speculation,
            transport=transport, priority=priority,
            grammar=grammar, response_format=response_format,
            journey=journey,
        )
        if self.durable is not None:
            # the durable id is assigned at submit (admission journals
            # later), so the HTTP response carries the resume handle from
            # its first byte
            self.durable.track(handle._request)
        return handle

    def generate(
        self,
        prompt: Sequence[int],
        sampling: Optional[SamplingParams] = None,
        timeout: Optional[float] = None,
        speculation: Optional[SpeculationConfig] = None,
        response_format: Optional[Dict] = None,
    ) -> List[int]:
        """Blocking single-request generation (deadline = timeout)."""
        handle = self.submit(
            prompt, sampling, deadline_s=timeout, speculation=speculation,
            response_format=response_format,
        )
        return handle.result(timeout=timeout)

    @staticmethod
    def sampling_from(params: Dict) -> SamplingParams:
        """Build SamplingParams from a request-level dict (HTTP JSON body
        fields), ignoring unknown keys."""
        defaults = SamplingParams()
        eos = params.get("eos_id")
        return SamplingParams(
            max_new_tokens=int(params.get("max_new_tokens", defaults.max_new_tokens)),
            temperature=float(params.get("temperature", defaults.temperature)),
            top_k=int(params.get("top_k", defaults.top_k)),
            eos_id=None if eos is None else int(eos),
            seed=int(params.get("seed", defaults.seed)),
        )

    @staticmethod
    def speculation_from(params: Dict) -> Optional[SpeculationConfig]:
        """Build a SpeculationConfig from the request's ``speculation``
        block (HTTP JSON body), ignoring unknown keys. Absent block (or ``enabled: false``) -> None (the
        scheduler's default policy applies)."""
        block = params.get("speculation")
        if not isinstance(block, dict):
            return None
        if not bool(block.get("enabled", True)):
            return SpeculationConfig(enabled=False)
        defaults = SpeculationConfig()
        return SpeculationConfig(
            enabled=True,
            k=int(block.get("k", defaults.k)),
            method=str(block.get("method", defaults.method)),
            max_ngram=int(block.get("max_ngram", defaults.max_ngram)),
            min_ngram=int(block.get("min_ngram", defaults.min_ngram)),
            adaptive=bool(block.get("adaptive", defaults.adaptive)),
        )

    @staticmethod
    def response_format_from(params: Dict) -> Optional[Dict]:
        """Pull the request's ``response_format`` block (HTTP JSON body).
        Absent -> None (unconstrained). A present-but-malformed block
        raises :class:`GrammarError`, a ValueError: the front end maps it
        to 400."""
        block = params.get("response_format")
        if block is None:
            return None
        if not isinstance(block, dict):
            raise GrammarError(
                f"response_format must be an object, got {type(block).__name__}"
            )
        return block

    def metadata(self) -> Dict:
        cfg = self.engine.cfg
        cc = self.engine.cache_config
        sup = self.scheduler.supervisor
        wd = self.scheduler.watchdog
        return {
            "name": self.name,
            "platform": "flexflow_tpu_torch_generation",
            "recovery": {
                "max_restarts": sup.policy.max_restarts,
                "budget_window_s": sup.policy.budget_window_s,
                "watchdog_enabled": wd.policy.enabled,
                "stall_timeout_s": wd.policy.stall_timeout_s,
                "engine_resets": self.engine.resets,
            },
            "observability": {
                "enabled": self.scheduler.obs_enabled,
                "trace_ring": self.scheduler.trace_ring.capacity,
                "flight_capacity": self.scheduler.flight.capacity,
                "progress_every": self.scheduler.trace_progress_every,
                "anatomy": self.scheduler.anatomy.enabled,
                "journeys": self.scheduler.journeys is not None,
            },
            "compute": {
                "chip": self.engine.flops_model.chip.name,
                "peak_tflops": self.engine.flops_model.peak_flops / 1e12,
                "mfu": self.engine.mfu(),
                "model_tflops_total": self.engine.total_flops() / 1e12,
            },
            # one GPU until the tensor-parallel engine is ported
            "serving_strategy": self.engine.serving_strategy_block(),
            "slo": {
                "objectives": [o.name for o in self.scheduler.slo.objectives],
                "breaching": self.scheduler.slo.breaching(),
            },
            "max_batch_slots": self.engine.max_batch_slots,
            "max_spec_tokens": self.engine.max_spec_tokens,
            "max_seq_len": self.engine.max_seq_len,
            "prompt_buckets": list(self.engine.buckets),
            "vocab_size": cfg.vocab_size,
            "cache": {
                "num_blocks": cc.num_blocks,
                "block_size": cc.block_size,
                "usable_tokens": cc.usable_tokens,
                "bytes": cc.total_bytes,
            },
            "prefix_cache": {
                "enabled": self.engine.prefix_cache.enabled,
                "host_budget_bytes": self.engine.prefix_cache.host_budget_bytes,
            },
            "constrained": {
                "formats": ["json_schema", "regex"],
                "grammar_cache_entries": len(self.grammar_cache),
                "vocabulary_tokens": len(self.vocabulary),
            },
            "durable": {
                "enabled": self.durable is not None,
                "fingerprint": self.durable.fingerprint if self.durable is not None else None,
                "wal_segments": (
                    self.durable.wal.segment_count() if self.durable is not None else 0
                ),
            },
            "inputs": [{"name": "tokens", "shape": (-1,), "datatype": "INT32"}],
            "outputs": [{"name": "tokens", "shape": (-1,), "datatype": "INT32"}],
        }
