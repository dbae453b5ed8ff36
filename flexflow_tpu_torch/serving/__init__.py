"""Serving around the generation engine: typed rejections, retry with
backoff and the circuit breaker."""
from .resilience import (
    CircuitBreaker,
    CircuitOpenError,
    DeadlineExceededError,
    QueueFullError,
    ResilienceError,
    RetryPolicy,
    ShuttingDownError,
)

__all__ = [
    "CircuitBreaker",
    "CircuitOpenError",
    "DeadlineExceededError",
    "QueueFullError",
    "ResilienceError",
    "RetryPolicy",
    "ShuttingDownError",
]
