"""Dynamic batcher: coalesce concurrent requests into one device batch
(port of ``flexflow_tpu/serving/batcher.py``).

Requests queue up; a collector thread drains up to ``max_batch`` samples
(waiting at most ``max_delay_s`` after the first), runs ONE padded
``InferenceModel.infer`` call on the model's device, and scatters the
results back to per-request futures.

Resilience (``serving/resilience.py`` + ``runtime/faults.py``):

* bounded queue — ``submit`` rejects with an ``OverloadedError`` (a
  :class:`QueueFullError`) when ``max_queue`` requests are waiting;
* per-request deadlines — an expired or client-abandoned request is
  dropped at collect/dispatch time so it never reaches the device
  (``infer(timeout=...)`` cancels its request on timeout);
* retry with exponential backoff for ``TransientDeviceError``, via an
  injectable :class:`RetryPolicy`;
* batch bisection — a device failure on a multi-request batch splits it
  in half and retries each side, so one poisoned request fails alone;
* per-model circuit breaker — consecutive device failures open the
  circuit (submit rejects with :class:`CircuitOpenError`); after the
  recovery window one probe request is admitted and its success closes
  it again. Health endpoints read ``batcher.breaker``;
* graceful drain — ``stop(drain=True)`` completes queued and in-flight
  requests before the collector exits; new submits are rejected with
  :class:`ShuttingDownError` while draining.

Besides its ``ServingStats`` (the JAX package's counters and its
``queue_depth`` gauge), the batcher counts its device calls and the
requests they carried (``device_calls``, ``batched_requests``: plain
attributes, outside ``/v2/stats`` and ``/metrics``, which stay the JAX
package's).
"""
from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as _FuturesTimeout
from typing import Callable, List, Optional, Sequence

import numpy as np

from ..obs import RequestTrace, TraceRing, next_request_id
from ..runtime import faults
from .model import InferenceModel
from .overload import Priority
from .resilience import (
    CircuitBreaker,
    CircuitOpenError,
    DeadlineExceededError,
    OverloadedError,
    RetryPolicy,
    ShuttingDownError,
)


class _Request:
    __slots__ = ("inputs", "future", "n", "deadline", "t_submit", "trace")

    def __init__(
        self,
        inputs: Sequence[np.ndarray],
        deadline: Optional[float] = None,
        t_submit: float = 0.0,
    ):
        self.inputs = inputs
        self.future: Future = Future()
        self.n = inputs[0].shape[0]
        self.deadline = deadline  # absolute, on the batcher's clock
        self.t_submit = t_submit  # for the latency stats
        self.trace: Optional[RequestTrace] = None  # set by submit()


def make_batcher(model: InferenceModel, kwargs: dict) -> "DynamicBatcher":
    """Build a batcher from server-level kwargs. ``breaker``/``retry``
    may be zero-arg factories (callables) — invoked here so each model
    gets its OWN instance; passing bare instances shares them across
    every model the server registers (fine for single-model servers,
    wrong for multi-model: one model's failures would open every
    model's circuit)."""
    kw = dict(kwargs)
    for key in ("breaker", "retry"):
        v = kw.get(key)
        if callable(v):
            kw[key] = v()
    return DynamicBatcher(model, **kw)


class DynamicBatcher:
    """Queue + collector thread around one InferenceModel.

    ``clock`` drives deadlines and the circuit breaker (injectable for
    deterministic chaos tests); the collect window itself always uses
    real ``time.monotonic`` so batching latency stays physical.
    """

    def __init__(
        self,
        model: InferenceModel,
        max_delay_s: float = 0.005,
        max_queue: int = 256,
        breaker: Optional[CircuitBreaker] = None,
        retry: Optional[RetryPolicy] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.model = model
        self.max_delay_s = max_delay_s
        self.max_queue = max_queue
        self.clock = clock
        self.breaker = breaker or CircuitBreaker(clock=clock)
        self.retry = retry or RetryPolicy()
        # /v2/stats: admission counters + request latency + queue depth
        from .stats import ServingStats

        self.stats = ServingStats()
        self.stats.add_gauge("queue_depth", lambda: self._q.qsize())
        # device calls (retries and bisection halves included) and the
        # requests they carried, written by the collector thread only
        self.device_calls = 0
        self.batched_requests = 0
        # per-request traces (accept -> dispatch -> finish) for the
        # batched-inference path; finished traces land here and on
        # GET /v2/debug/traces next to the generation traces
        self.trace_ring = TraceRing(64)
        # unbounded Queue; the bound is enforced in submit() via qsize so
        # control sentinels can never block behind a full queue
        self._q: "queue.Queue[Optional[_Request]]" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._running = False
        self._draining = False
        # one-slot holdover for a request that didn't fit the last batch:
        # it leads the NEXT batch instead of re-queueing behind newer
        # arrivals (FIFO re-queue starved large requests under sustained
        # small-request load)
        self._pending: Optional[_Request] = None

    # ------------------------------------------------------------ control
    def start(self):
        if self._running:
            return
        if self._thread is not None and self._thread.is_alive():
            # a previous stop() timed out mid-drain; two collectors on one
            # queue would race over requests and sentinels
            raise RuntimeError("previous collector still draining; cannot restart")
        self._running = True
        self._draining = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self, drain: bool = True, timeout: float = 10.0):
        """Stop the collector. ``drain=True`` (default) first completes
        every queued and in-flight request; ``drain=False`` stops after
        the current batch and errors the rest. A drain that outlives
        ``timeout`` degrades to a hard stop."""
        if not self._running:
            return
        if drain:
            # collector keeps running until it eats the sentinel, so the
            # whole queue (and any holdover) is served first; submit()
            # rejects new work while draining
            self._draining = True
            self._q.put(None)
            if self._thread:
                self._thread.join(timeout=timeout)
                if self._thread.is_alive():
                    # wedged drain (e.g. a hung device call): stop
                    # accepting work but KEEP _draining set so submits
                    # surface as 503 ShuttingDownError, and leave the
                    # collector's state (_pending, queue) alone — touching
                    # it here would race the live thread. The daemon
                    # thread exits with the process; start() refuses to
                    # run until it actually dies.
                    self._running = False
                    return
            self._running = False
            self._draining = False
        else:
            self._running = False
            self._q.put(None)
        if self._thread:
            self._thread.join(timeout=5)
            if self._thread.is_alive():
                # wedged hard stop: leave the collector's state alone (as
                # above); subsequent submits get the plain stopped-batcher
                # RuntimeError, matching any other drain=False stop
                return
            self._thread = None
        # drain stale sentinels/requests so a later start() gets a clean
        # queue (a re-queued None would kill the new collector instantly)
        if self._pending is not None:
            if not self._pending.future.done():
                self._pending.future.set_exception(ShuttingDownError("batcher stopped"))
            self._pending = None
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if isinstance(item, _Request) and not item.future.done():
                item.future.set_exception(ShuttingDownError("batcher stopped"))

    def ready(self) -> bool:
        """Health-endpoint view, shared by the HTTP and gRPC front ends:
        accepting work and the breaker is not holding traffic."""
        return self._running and not self._draining and self.breaker.ready()

    # ------------------------------------------------------------- submit
    def submit(
        self,
        inputs: Sequence[np.ndarray],
        deadline_s: Optional[float] = None,
        transport: Optional[str] = None,
        priority: Optional[str] = None,
    ) -> Future:
        """Enqueue one request (batch <= max_batch); returns a Future of
        the output list. ``deadline_s`` is this request's latency budget:
        if it expires before the request reaches the device, the request
        fails with DeadlineExceededError instead of wasting batch space.
        ``transport`` annotates the request's trace ("http"/"grpc").
        ``priority`` (interactive / standard / best_effort) labels the
        rejection accounting: a full queue answers with the typed
        OverloadedError (HTTP 503 + Retry-After) counted per reason AND
        per class, so /v2/stats explains why load was refused."""
        # draining outranks stopped: a wedged drain leaves _running False
        # with _draining set, and those submits must stay 503, not 500
        if self._draining:
            raise ShuttingDownError("batcher draining")
        if not self._running:
            raise RuntimeError("batcher not started")
        if len(inputs) != len(self.model.inputs):
            raise ValueError(f"model takes {len(self.model.inputs)} inputs, got {len(inputs)}")
        n = inputs[0].shape[0]
        if n > self.model.max_batch:
            raise ValueError(f"request batch {n} exceeds max_batch {self.model.max_batch}")
        arrays = [np.asarray(x) for x in inputs]
        # validate per-request so one malformed request can't poison the
        # co-batched requests at np.concatenate time
        for x, meta in zip(arrays, self.model.inputs):
            if tuple(x.shape[1:]) != meta.shape:
                raise ValueError(f"input {meta.name}: expected {meta.shape}, got {tuple(x.shape[1:])}")
            if x.shape[0] != n:
                raise ValueError("all inputs in a request must share the batch dim")
        if deadline_s is not None and deadline_s <= 0:
            self.stats.incr("expired")
            raise DeadlineExceededError("deadline already expired at submit")
        priority = Priority.parse(priority)
        if self._q.qsize() >= self.max_queue:
            # per-reason / per-priority split next to the aggregate, so
            # /v2/stats explains why load was refused
            self.stats.incr("rejected")
            self.stats.incr("rejected_queue_full")
            self.stats.incr(f"rejected_{priority}")
            raise OverloadedError(
                f"model {self.model.name!r}: request queue full ({self.max_queue})",
                reason="queue_full", priority=priority, retry_after_s=1.0,
            )
        # breaker LAST so a rejection on the cheap checks above can never
        # consume (and leak) the HALF_OPEN probe slot
        if not self.breaker.allow():
            self.stats.incr("rejected")
            raise CircuitOpenError(f"model {self.model.name!r}: circuit open")
        deadline = None if deadline_s is None else self.clock() + deadline_s
        req = _Request(arrays, deadline=deadline, t_submit=self.clock())
        # ids come from the process-wide obs counter shared with the
        # generation path, so /v2/debug/traces?id=N is unambiguous
        req.trace = RequestTrace(
            next_request_id(), clock=self.clock, model=self.model.name
        )
        req.trace.mark_accept(batch=n, deadline_s=deadline_s)
        if transport is not None:
            req.trace.mark_transport(transport)
        self.stats.incr("admitted")
        self._q.put(req)
        # close the submit/stop race: if stop() ran to completion between
        # the liveness checks above and the put, neither the collector nor
        # stop()'s cleanup sweep will ever see this request — fail it here
        # instead of leaving the caller to hit its own result timeout
        if not self._running and not self._draining:
            try:
                req.future.set_exception(ShuttingDownError("batcher stopped"))
            except Exception:
                pass  # the cleanup sweep got to it first
            raise ShuttingDownError("batcher stopped")
        return req.future

    def infer(self, inputs: Sequence[np.ndarray], timeout: Optional[float] = None) -> List[np.ndarray]:
        fut = self.submit(inputs, deadline_s=timeout)
        try:
            return fut.result(timeout=timeout)
        except (TimeoutError, _FuturesTimeout):
            # futures.TimeoutError only aliases the builtin from 3.11 on
            # abandoned: cancel so the collector skips it instead of
            # running it in a future device batch nobody waits for
            fut.cancel()
            raise

    # ------------------------------------------------------------ internals
    def _trace_done(self, req: _Request, outcome: str, err=None) -> None:
        if req.trace is None:
            return
        req.trace.mark_finish(outcome, err)
        self.trace_ring.add(req.trace)

    def _admit(self, req: _Request) -> bool:
        """Called once when a request is pulled for batching. Drops
        abandoned (cancelled/already-failed) requests and fails expired
        ones — neither ever reaches the device."""
        if req.future.done():
            # already cancelled or failed (e.g. the submit/stop race check
            # settled it while it sat in the queue); FINISHED futures must
            # not reach set_running_or_notify_cancel, which would raise
            # and kill the collector
            return False
        if req.deadline is not None and self.clock() >= req.deadline:
            if not req.future.done():
                self.stats.incr("expired")
                err = DeadlineExceededError("deadline expired before dispatch")
                # trace closes BEFORE the future settles: the client
                # thread wakes on set_exception and may read the trace
                self._trace_done(req, "DeadlineExceededError", err)
                req.future.set_exception(err)
            return False
        # flips PENDING->RUNNING so infer()-timeout cancels can no longer
        # race with result scatter; returns False if already cancelled
        try:
            admitted = req.future.set_running_or_notify_cancel()
        except RuntimeError:  # FINISHED in the window since the check above
            return False
        if admitted and req.trace is not None:
            req.trace.mark_admit()
            self.stats.observe("queue_time", max(0.0, self.clock() - req.t_submit))
        return admitted

    def _collect(self) -> List[_Request]:
        """Block for the first live request, then drain until the batch
        is full or max_delay_s has passed. A held-over request (one that
        didn't fit the previous batch) always leads."""
        if self._pending is not None:
            first, self._pending = self._pending, None
        else:
            first = None
            while first is None:
                item = self._q.get()
                if item is None:
                    return []
                if self._admit(item):
                    first = item
        batch = [first]
        total = first.n
        # the coalescing window bounds a REAL blocking queue.get below,
        # so it must run on physical time: the injectable self.clock is
        # virtual in chaos tests and would turn max_delay_s into either
        # zero or forever. Request deadlines still use self.clock.
        deadline = time.monotonic() + self.max_delay_s  # flexlint: disable=clock-discipline
        while total < self.model.max_batch:
            remaining = deadline - time.monotonic()  # flexlint: disable=clock-discipline
            if remaining <= 0:
                break
            try:
                nxt = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:
                self._q.put(None)  # keep the shutdown signal
                break
            if not self._admit(nxt):
                continue
            if total + nxt.n > self.model.max_batch:
                self._pending = nxt  # doesn't fit: leads the next batch
                break
            batch.append(nxt)
            total += nxt.n
        return batch

    def _device_infer(self, batch: List[_Request]) -> List[np.ndarray]:
        self.device_calls += 1
        self.batched_requests += len(batch)
        stacked = [
            np.concatenate([r.inputs[i] for r in batch], axis=0)
            for i in range(len(batch[0].inputs))
        ]
        return self.model.infer(stacked)

    def _run(self, batch: List[_Request], top_level: bool = True) -> None:
        """Run one batch with retry; on persistent failure, bisect so the
        poisoned request fails alone while its batch-mates succeed.
        Transient errors get their full retry budget ONCE, at the top
        level — bisection children run single-shot, so a device-wide
        failure on a batch of k costs O(k) calls, not O(k * attempts)."""
        try:
            if top_level:
                outs = self.retry.run(lambda: self._device_infer(batch))
            else:
                outs = self._device_infer(batch)
        except Exception as e:
            if len(batch) > 1:
                mid = len(batch) // 2
                self._run(batch[:mid], top_level=False)
                self._run(batch[mid:], top_level=False)
            else:
                # leaf: failure definitively attributed to this request's
                # device call — this is what trips the breaker
                self.breaker.record_failure()
                r = batch[0]
                if not r.future.done():
                    self.stats.incr("failed")
                    self._trace_done(r, type(e).__name__, e)
                    r.future.set_exception(e)
            return
        self.breaker.record_success()
        off = 0
        now = self.clock()
        for r in batch:
            if not r.future.done():
                self.stats.incr("completed")
                self.stats.latency.record(max(0.0, now - r.t_submit))
                self._trace_done(r, "completed")
                r.future.set_result([o[off : off + r.n] for o in outs])
            off += r.n

    def _loop(self):
        while True:
            if not self._running and not self._draining:
                break
            batch = self._collect()
            if not batch:
                break
            # final sweep: a deadline that expired while the request was
            # held over / the window filled must still never dispatch
            now = self.clock()
            live = []
            for r in batch:
                if r.deadline is not None and now >= r.deadline:
                    if not r.future.done():
                        self.stats.incr("expired")
                        err = DeadlineExceededError("deadline expired before dispatch")
                        self._trace_done(r, "DeadlineExceededError", err)
                        r.future.set_exception(err)
                else:
                    live.append(r)
            if not live:
                continue
            # the breaker opened while these requests sat in the backlog:
            # fast-fail them instead of burning device calls on a known-bad
            # device (state check only — must NOT consume the probe slot;
            # an admitted HALF_OPEN probe sees state HALF_OPEN and runs)
            if self.breaker.state == CircuitBreaker.OPEN:
                err = CircuitOpenError(f"model {self.model.name!r}: circuit open")
                for r in live:
                    if not r.future.done():
                        r.future.set_exception(err)
                continue
            try:
                live = faults.inject(faults.SERVING_BATCHER_DISPATCH, live)
                self._run(live)
            except Exception as e:  # injected dispatch fault / scatter bug
                for r in live:
                    if not r.future.done():
                        r.future.set_exception(e)
