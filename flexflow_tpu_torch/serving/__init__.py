"""Serving (port of ``flexflow_tpu/serving``): typed
rejections, retry with backoff and the circuit breaker, the overload
controller and the fleet's autoscale advisor, the serving statistics,
the batched path (:class:`InferenceModel` behind a
:class:`DynamicBatcher`, the :class:`ModelRepository` with
``save_model`` / ``load_model``), durable serving (``durable.py``: the
WAL journal, warm restart and the resume index), the fleet tier
(``fleet.py``: :class:`Fleet` replicas behind the cache-aware router,
:class:`DisaggregatedFleet` prefill and decode pools joined by the KV
handoff), the HTTP front end (:class:`InferenceModel`,
:class:`GenerationModel` and either fleet behind :class:`InferenceServer`)
and the KServe v2 gRPC front end (:class:`GrpcInferenceServer`, which
needs grpcio and protobuf; it raises where they are not installed).

``GenerationModel``, the fleet classes, ``InferenceServer`` and the
batched path resolve lazily: they import the generation package or the
model, which import this package's resilience module.
"""
from .overload import (
    AdaptiveLimiter,
    AutoscaleAdvisor,
    DegradeLadder,
    OverloadConfig,
    OverloadController,
    Priority,
)
from .resilience import (
    CircuitBreaker,
    CircuitOpenError,
    DeadlineExceededError,
    InfeasibleError,
    OverloadedError,
    QueueFullError,
    ResilienceError,
    RetryPolicy,
    ShuttingDownError,
    http_status,
    retry_after_s,
)
from .stats import (
    ConstrainedStats,
    DurableStats,
    FleetStats,
    GoodputStats,
    Histogram,
    LatencyWindow,
    ServingStats,
    SpeculationStats,
    TokenRate,
)

__all__ = [
    "AdaptiveLimiter",
    "AutoscaleAdvisor",
    "CircuitBreaker",
    "CircuitOpenError",
    "ConstrainedStats",
    "DeadlineExceededError",
    "DegradeLadder",
    "DisaggregatedFleet",
    "DurableStats",
    "DynamicBatcher",
    "Fleet",
    "FleetRouter",
    "FleetStats",
    "GenerationModel",
    "GoodputStats",
    "GrpcInferenceServer",
    "Histogram",
    "InferenceModel",
    "InferenceServer",
    "InfeasibleError",
    "HandoffManager",
    "LatencyWindow",
    "ModelRepository",
    "OverloadConfig",
    "OverloadController",
    "OverloadedError",
    "Priority",
    "QueueFullError",
    "ReplicaState",
    "ResilienceError",
    "RetryPolicy",
    "ServingStats",
    "ShuttingDownError",
    "SpeculationStats",
    "TensorMeta",
    "TokenRate",
    "http_status",
    "load_model",
    "make_batcher",
    "retry_after_s",
    "save_model",
]

_LAZY = {
    "GenerationModel": "generation",
    "Fleet": "fleet",
    "FleetRouter": "fleet",
    "ReplicaState": "fleet",
    "HandoffManager": "fleet",
    "DisaggregatedFleet": "fleet",
    "InferenceServer": "server",
    "GrpcInferenceServer": "grpc_server",
    "InferenceModel": "model",
    "TensorMeta": "model",
    "DynamicBatcher": "batcher",
    "make_batcher": "batcher",
    "ModelRepository": "repository",
    "load_model": "repository",
    "save_model": "repository",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(f".{_LAZY[name]}", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
