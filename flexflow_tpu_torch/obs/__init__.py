"""Serving observability of the port (port of ``flexflow_tpu/obs``
without request journeys, which wait for the fleet):

* :mod:`trace` — per-request :class:`RequestTrace` (accept -> queue ->
  admit -> prefill -> decode progress -> finish/fail) feeding the
  queue_time / TTFT / TPOT windows, retained in a bounded
  :class:`TraceRing` (``GET /v2/debug/traces``);
* :mod:`flight` — the engine :class:`FlightRecorder`: a ring of per-step
  records and supervisor events, snapshotted into quarantine and restart
  errors and dumpable as chrome://tracing JSON (``GET /v2/debug/timeline``);
* :mod:`capacity` — KV-cache block telemetry (:class:`CacheTelemetry`),
  the serving FLOPs model (:class:`ServingFlops`) and the step-program
  registry (:class:`ProgramRegistry`);
* :mod:`slo` — per-model objectives as multi-window burn rates
  (:class:`SLOMonitor`, ``GET /v2/slo``);
* :mod:`steptrace` — the :class:`StepAnatomy` profiler: host spans and
  the device execute span per scheduler iteration (``GET /v2/debug/anatomy``);
* :mod:`truth` — the :class:`PredictionLedger` of predicted vs measured
  step times (``GET /v2/debug/predictions``);
* :mod:`prom` — Prometheus text exposition (``GET /metrics``).
"""
from .capacity import (
    CHIP_PRESETS,
    CacheTelemetry,
    ChipSpec,
    ProgramRegistry,
    ServingFlops,
    chip_spec_for,
)
from .flight import FlightRecorder
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
    "format_value",
    "next_request_id",
    "render_prometheus",
    "sanitize_name",
    "validate_exposition",
]
