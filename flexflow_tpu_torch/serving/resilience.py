"""Typed serving rejections, retry with backoff and the circuit breaker
(port of ``flexflow_tpu/serving/resilience.py``).

The errors map 1:1 onto protocol status codes, so transports can tell
backpressure from an expired deadline without string matching.
"""
from __future__ import annotations

import random
import threading
import time
from typing import Callable, Tuple, Type

from ..runtime.backoff import backoff_delay
from ..runtime.faults import TransientDeviceError


class ResilienceError(RuntimeError):
    """Base for typed serving rejections (subclasses RuntimeError so
    catch-all handlers keep working)."""


class QueueFullError(ResilienceError):
    """Backpressure: the bounded request queue is full.
    HTTP 503 / gRPC RESOURCE_EXHAUSTED."""


class OverloadedError(QueueFullError):
    """Priority-aware overload rejection (serving/overload.py): the
    admission layer refused this request BEFORE it consumed queue or
    device capacity. Subclasses :class:`QueueFullError` so every
    backpressure handler (HTTP 503, retry loops catching
    QueueFullError) keeps working; adds the structured fields clients need to back off
    intelligently:

      reason         why load was refused: "queue_full" (bounded queue,
                     possibly after a priority-ordered shed), "limiter"
                     (AdaptiveLimiter throttled admission before the
                     queue filled), "infeasible" (predicted TTFT already
                     exceeds the deadline), or "degraded" (the
                     degradation ladder is shedding this priority class)
      priority       the refused request's priority class
      retry_after_s  server-suggested backoff; rendered as the HTTP
                     ``Retry-After`` header
    """

    def __init__(
        self,
        msg: str,
        *,
        reason: str = "queue_full",
        priority: "str | None" = None,
        retry_after_s: "float | None" = None,
    ):
        super().__init__(msg)
        self.reason = reason
        self.priority = priority
        self.retry_after_s = retry_after_s


class InfeasibleError(OverloadedError):
    """Roofline-based infeasibility fast-fail: the request's predicted
    TTFT (the serving roofline x the current queue) already exceeds its
    deadline, so admitting it could only burn capacity on work that is
    guaranteed to expire. Counted separately from sheds
    (``rejected_infeasible``)."""

    def __init__(self, msg: str, *, priority=None, retry_after_s=None,
                 predicted_ttft_s: "float | None" = None):
        super().__init__(msg, reason="infeasible", priority=priority,
                         retry_after_s=retry_after_s)
        self.predicted_ttft_s = predicted_ttft_s


def retry_after_s(err: BaseException) -> "float | None":
    """The server-suggested backoff riding a typed rejection (None when
    the error carries none), rendered as ``Retry-After``."""
    v = getattr(err, "retry_after_s", None)
    try:
        return None if v is None else max(0.0, float(v))
    except (TypeError, ValueError):
        return None


class DeadlineExceededError(ResilienceError):
    """The request's deadline passed before it completed.
    HTTP 504 / gRPC DEADLINE_EXCEEDED."""


class CircuitOpenError(ResilienceError):
    """The model's circuit breaker is open; request rejected without
    touching the device. HTTP 503 / gRPC UNAVAILABLE."""


class ShuttingDownError(ResilienceError):
    """The request was cancelled or the server is draining.
    HTTP 503 / gRPC UNAVAILABLE."""


def http_status(err: ResilienceError) -> int:
    """The single source of truth for ResilienceError -> HTTP status."""
    return 504 if isinstance(err, DeadlineExceededError) else 503


def grpc_code(err: ResilienceError, grpc):
    """ResilienceError -> grpc.StatusCode (``grpc`` passed in so this
    module stays importable without grpcio)."""
    if isinstance(err, DeadlineExceededError):
        return grpc.StatusCode.DEADLINE_EXCEEDED
    if isinstance(err, QueueFullError):
        return grpc.StatusCode.RESOURCE_EXHAUSTED
    return grpc.StatusCode.UNAVAILABLE


class RetryPolicy:
    """Exponential backoff with seeded jitter for transient errors.

    ``run(fn)`` calls ``fn`` up to ``max_attempts`` times, sleeping
    ``base_delay_s * 2**(attempt-1)`` (capped at ``max_delay_s``, plus
    up to ``jitter`` fractional noise) between attempts. Exceptions not
    in ``retryable`` propagate immediately.
    """

    def __init__(
        self,
        max_attempts: int = 3,
        base_delay_s: float = 0.01,
        max_delay_s: float = 0.5,
        jitter: float = 0.25,
        retryable: Tuple[Type[BaseException], ...] = (TransientDeviceError,),
        sleep: Callable[[float], None] = time.sleep,
        seed: int = 0,
    ):
        self.max_attempts = max(1, max_attempts)
        self.base_delay_s = base_delay_s
        self.max_delay_s = max_delay_s
        self.jitter = jitter
        self.retryable = tuple(retryable)
        self.sleep = sleep
        self._rng = random.Random(f"retry|{seed}")
        self.last_attempts = 0  # attempts used by the last run()

    def would_retry(self, err: BaseException) -> bool:
        """True when :meth:`run` would retry this error: a retryable
        error surfacing from a pipelined (asynchronously dispatched) step
        gets the same invisible retry a synchronous step would have had
        inside ``run()``."""
        return isinstance(err, self.retryable) and self.max_attempts > 1

    def delay_for(self, attempt: int) -> float:
        """Backoff before retry number ``attempt`` (1-based)."""
        return backoff_delay(
            attempt,
            base_s=self.base_delay_s,
            max_s=self.max_delay_s,
            jitter=self.jitter,
            rng=self._rng,
        )

    def run(self, fn: Callable[[], "object"]):
        attempt = 0
        while True:
            attempt += 1
            try:
                out = fn()
            except self.retryable:
                if attempt >= self.max_attempts:
                    self.last_attempts = attempt
                    raise
                self.sleep(self.delay_for(attempt))
                continue
            self.last_attempts = attempt
            return out


class CircuitBreaker:
    """Per-model circuit breaker.

    CLOSED: everything admitted; ``failure_threshold`` consecutive
    failures open the circuit. OPEN: everything rejected until
    ``recovery_s`` has elapsed, then ONE request is admitted as a
    HALF_OPEN probe. HALF_OPEN: the probe's success closes the circuit,
    its failure re-opens it (fresh recovery window); concurrent requests
    are rejected while the probe is in flight.
    """

    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"

    def __init__(
        self,
        failure_threshold: int = 5,
        recovery_s: float = 30.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.failure_threshold = max(1, failure_threshold)
        self.recovery_s = recovery_s
        self.clock = clock
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._probing = False
        self._probe_at = 0.0

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def ready(self) -> bool:
        """Health view: not-ready only while OPEN (a HALF_OPEN probe in
        flight counts as recovering, i.e. ready)."""
        with self._lock:
            if self._state != self.OPEN:
                return True
            # an elapsed recovery window means the next request will be
            # admitted as a probe; report ready so traffic returns
            return self.clock() - self._opened_at >= self.recovery_s

    def allow(self) -> bool:
        """Admission check; may transition OPEN -> HALF_OPEN (claiming
        the probe slot for the caller)."""
        with self._lock:
            if self._state == self.CLOSED:
                return True
            now = self.clock()
            if self._state == self.OPEN:
                if now - self._opened_at >= self.recovery_s:
                    self._state = self.HALF_OPEN
                    self._probing = True
                    self._probe_at = now
                    return True
                return False
            # HALF_OPEN: one probe at a time; a probe whose outcome never
            # got recorded times out after recovery_s
            if not self._probing or now - self._probe_at >= self.recovery_s:
                self._probing = True
                self._probe_at = now
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._state = self.CLOSED
            self._probing = False

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            if self._state == self.HALF_OPEN or self._failures >= self.failure_threshold:
                self._state = self.OPEN
                self._opened_at = self.clock()
                self._failures = 0
                self._probing = False

    def trip(self) -> None:
        """Force the breaker OPEN immediately, bypassing the consecutive-
        failure count: the step watchdog's call when a device step
        stalls (no request completes, so nothing records a failure)."""
        with self._lock:
            self._state = self.OPEN
            self._opened_at = self.clock()
            self._failures = 0
            self._probing = False
