"""Serving around the generation engine (port of ``flexflow_tpu/serving``
without the batched ``/infer`` path, the model repository, gRPC and the
fleet): typed rejections, retry with backoff and the circuit breaker, the
overload controller, the serving statistics, durable serving
(``durable.py``: the WAL journal, warm restart and the resume index), and
the HTTP front end — :class:`GenerationModel` behind
:class:`InferenceServer`.

``GenerationModel`` and ``InferenceServer`` resolve lazily: they import
the generation package, which imports this package's resilience module.
"""
from .overload import (
    AdaptiveLimiter,
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
    GoodputStats,
    Histogram,
    LatencyWindow,
    ServingStats,
    SpeculationStats,
    TokenRate,
)

__all__ = [
    "AdaptiveLimiter",
    "CircuitBreaker",
    "CircuitOpenError",
    "ConstrainedStats",
    "DeadlineExceededError",
    "DegradeLadder",
    "DurableStats",
    "GenerationModel",
    "GoodputStats",
    "Histogram",
    "InferenceServer",
    "InfeasibleError",
    "LatencyWindow",
    "OverloadConfig",
    "OverloadController",
    "OverloadedError",
    "Priority",
    "QueueFullError",
    "ResilienceError",
    "RetryPolicy",
    "ServingStats",
    "ShuttingDownError",
    "SpeculationStats",
    "TokenRate",
    "http_status",
    "retry_after_s",
]


def __getattr__(name):
    if name == "GenerationModel":
        from .generation import GenerationModel

        return GenerationModel
    if name == "InferenceServer":
        from .server import InferenceServer

        return InferenceServer
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
