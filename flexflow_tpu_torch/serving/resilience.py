"""Typed serving rejections (port of the errors of
``flexflow_tpu/serving/resilience.py`` that the generation scheduler
raises; retry and the circuit breaker come with the serving slice).

The errors map 1:1 onto protocol status codes, so transports can tell
backpressure from an expired deadline without string matching.
"""
from __future__ import annotations


class ResilienceError(RuntimeError):
    """Base for typed serving rejections (subclasses RuntimeError so
    catch-all handlers keep working)."""


class QueueFullError(ResilienceError):
    """Backpressure: the bounded request queue is full.
    HTTP 503 / gRPC RESOURCE_EXHAUSTED."""


class DeadlineExceededError(ResilienceError):
    """The request's deadline passed before it completed.
    HTTP 504 / gRPC DEADLINE_EXCEEDED."""


class ShuttingDownError(ResilienceError):
    """The request was cancelled or the server is draining.
    HTTP 503 / gRPC UNAVAILABLE."""
