"""Serving around the generation engine: typed rejections, retry with
backoff, the circuit breaker and the constrained-decoding counters."""
from .resilience import (
    CircuitBreaker,
    CircuitOpenError,
    DeadlineExceededError,
    QueueFullError,
    ResilienceError,
    RetryPolicy,
    ShuttingDownError,
)
from .stats import ConstrainedStats

__all__ = [
    "CircuitBreaker",
    "CircuitOpenError",
    "ConstrainedStats",
    "DeadlineExceededError",
    "QueueFullError",
    "ResilienceError",
    "RetryPolicy",
    "ShuttingDownError",
]
