"""Serving observability of the port (port of ``flexflow_tpu/obs``):

* :mod:`trace` — per-request :class:`RequestTrace` (accept -> queue ->
  admit -> prefill -> decode progress -> finish/fail) feeding the
  queue_time / TTFT / TPOT windows, retained in a bounded
  :class:`TraceRing` (``GET /v2/debug/traces``);
* :mod:`flight` — the engine :class:`FlightRecorder`: a ring of per-step
  records and supervisor events, snapshotted into quarantine and restart
  errors and dumpable as chrome://tracing JSON (``GET /v2/debug/timeline``);
* :mod:`capacity` — KV-cache block telemetry (:class:`CacheTelemetry`),
  the serving FLOPs model (:class:`ServingFlops`) and the step-program
  registry (:class:`ProgramRegistry`, the executors' in
  :data:`GLOBAL_PROGRAMS`);
* :mod:`slo` — per-model objectives as multi-window burn rates
  (:class:`SLOMonitor`, ``GET /v2/slo``);
* :mod:`steptrace` — the :class:`StepAnatomy` profiler: host spans and
  the device execute span per scheduler iteration (``GET /v2/debug/anatomy``);
* :mod:`truth` — the :class:`PredictionLedger` of predicted vs measured
  step times (``GET /v2/debug/predictions``);
* :mod:`journey` — request journeys: a journey id minted (or joined
  from a W3C ``traceparent``) at ingress, one parent-linked span per hop
  in a :class:`JourneyRecorder` ring and, with durability on, in the
  on-disk :class:`JourneySpool` beside the WAL, stitched by a
  :class:`JourneyIndex` (``GET /v2/debug/journey/{id}``);
* :mod:`prom` — Prometheus text exposition (``GET /metrics``).
"""
from .capacity import (
    CHIP_PRESETS,
    CacheTelemetry,
    GLOBAL_PROGRAMS,
    ChipSpec,
    ProgramRegistry,
    ServingFlops,
    chip_spec_for,
)
from .flight import FlightRecorder
from .journey import (
    NULL_JOURNEY,
    JourneyContext,
    JourneyIndex,
    JourneyRecorder,
    JourneySpan,
    JourneySpool,
    JourneyStats,
    format_traceparent,
    new_journey_id,
    new_span_id,
    parse_traceparent,
    stitch,
)
from .journey import to_chrome_trace as journey_to_chrome_trace
from .journey import to_otlp as journey_to_otlp
from .prom import (
    escape_label_value,
    format_value,
    render_prometheus,
    sanitize_name,
    validate_exposition,
)
from .slo import DEFAULT_OBJECTIVES, SLObjective, SLOMonitor
from .steptrace import StepAnatomy
from .trace import NULL_TRACE, RequestTrace, TraceRing, next_request_id
from .truth import GLOBAL_LEDGER, PredictionLedger

__all__ = [
    "CHIP_PRESETS",
    "CacheTelemetry",
    "ChipSpec",
    "DEFAULT_OBJECTIVES",
    "FlightRecorder",
    "GLOBAL_LEDGER",
    "GLOBAL_PROGRAMS",
    "JourneyContext",
    "JourneyIndex",
    "JourneyRecorder",
    "JourneySpan",
    "JourneySpool",
    "JourneyStats",
    "NULL_JOURNEY",
    "NULL_TRACE",
    "PredictionLedger",
    "ProgramRegistry",
    "RequestTrace",
    "SLOMonitor",
    "SLObjective",
    "ServingFlops",
    "StepAnatomy",
    "TraceRing",
    "chip_spec_for",
    "escape_label_value",
    "format_traceparent",
    "format_value",
    "journey_to_chrome_trace",
    "journey_to_otlp",
    "new_journey_id",
    "new_span_id",
    "next_request_id",
    "parse_traceparent",
    "render_prometheus",
    "sanitize_name",
    "stitch",
    "validate_exposition",
]
