"""Serving around the generation engine (slice 1: typed rejections)."""
from .resilience import (
    DeadlineExceededError,
    QueueFullError,
    ResilienceError,
    ShuttingDownError,
)

__all__ = [
    "DeadlineExceededError",
    "QueueFullError",
    "ResilienceError",
    "ShuttingDownError",
]
