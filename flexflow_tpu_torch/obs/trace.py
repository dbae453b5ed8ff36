"""Per-request tracing: the answer to "why was THIS request slow?".

(Port of ``flexflow_tpu/obs/trace.py``, which imports nothing of JAX:
the same code, kept as the port's own copy. ``journey_id`` is the
request's journey id while journeys are on: obs/journey.py.)

A :class:`RequestTrace` rides every generation request from accept to
finish (its transport, e.g. "http", annotated) and records the
latency decomposition the serving-SLO literature evaluates on:

  queue_time  accept -> admission (first time the request gets device
              resources; re-admissions after preemption/replay are
              ``admit`` events but do not reset the clock)
  TTFT        accept -> first generated token (time-to-first-token)
  TPOT        mean inter-token time after the first token
              (time-per-output-token)

plus an append-only event log (bounded deque) carrying scheduling
annotations: speculation windows, preemptions, journal replays,
quarantines, watchdog reaps. Timestamps come from the owner's clock —
the scheduler's injectable clock in generation, so virtual-clock chaos
tests see deterministic traces.

Completed traces land in a :class:`TraceRing` (bounded, most recent
first) served on ``GET /v2/debug/traces``; a failed request's trace is
also embedded in its error response so the client holds the postmortem
without a second round trip.

Thread-safety: events are appended by the scheduler loop thread, the
watchdog thread (terminal reaps), and transport threads (annotations);
a tiny per-trace lock keeps the log and the derived marks consistent.
``NULL_TRACE`` is the disabled-observability stand-in: every method is
a no-op, so hot paths stay branch-free.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

# process-wide request-id stream shared by every scheduler, so a trace id on
# /v2/debug/traces?id=N names exactly one request whichever ring holds
# it
_ids = itertools.count()


def next_request_id() -> int:
    return next(_ids)


class RequestTrace:
    """Lifecycle record of one serving request."""

    __slots__ = (
        "request_id", "model", "_clock", "_lock", "events", "prompt_len",
        "t_accept", "t_admit", "t_first_token", "t_last_token", "t_finish",
        "n_generated", "outcome", "error", "preemptions", "replays",
        "spec_windows", "spec_proposed", "spec_accepted", "transport",
        "progress_every", "_steps_since_progress", "journey_id",
    )

    def __init__(
        self,
        request_id: int,
        clock: Callable[[], float] = time.monotonic,
        model: Optional[str] = None,
        progress_every: int = 8,
        max_events: int = 256,
    ):
        self.request_id = request_id
        self.model = model
        self._clock = clock
        self._lock = threading.Lock()
        # (t, name, fields-or-None); bounded so a 100k-token stream
        # cannot grow its trace without limit (progress events roll off)
        self.events: deque = deque(maxlen=max_events)  # guarded-by: _lock
        self.prompt_len = 0
        self.t_accept: Optional[float] = None
        self.t_admit: Optional[float] = None
        self.t_first_token: Optional[float] = None
        self.t_last_token: Optional[float] = None
        self.t_finish: Optional[float] = None
        self.n_generated = 0
        self.outcome: Optional[str] = None
        self.error: Optional[str] = None
        self.preemptions = 0
        self.replays = 0
        self.spec_windows = 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.transport: Optional[str] = None
        # fleet-wide journey (trace) id this request rides, if any —
        # the join key between a replica-local trace and the stitched
        # cross-replica journey (obs/journey.py)
        self.journey_id: Optional[str] = None
        self.progress_every = max(1, progress_every)
        self._steps_since_progress = 0

    # --------------------------------------------------------------- events
    def event(self, name: str, **fields) -> None:
        with self._lock:
            self.events.append((self._clock(), name, fields or None))

    def mark_accept(self, prompt_len: int = 0, **fields) -> None:
        with self._lock:
            self.t_accept = self._clock()
            self.prompt_len = prompt_len
            self.events.append(
                (self.t_accept, "accept", dict(prompt_len=prompt_len, **fields))
            )

    def mark_transport(self, kind: str) -> None:
        with self._lock:
            self.transport = kind
            self.events.append((self._clock(), "transport", {"kind": kind}))

    def mark_admit(self, **fields) -> None:
        """Admission to device resources. Only the FIRST admission sets
        the queue-time mark; re-admissions (preemption recompute,
        journal replay) stay visible as extra ``admit`` events."""
        with self._lock:
            now = self._clock()
            if self.t_admit is None:
                self.t_admit = now
            self.events.append((now, "admit", fields or None))

    def note_tokens(self, n_new: int, kind: str) -> None:
        """Fold one step's emitted tokens in; logs a ``progress`` event
        every ``progress_every`` steps instead of one event per token."""
        if n_new <= 0:
            return
        with self._lock:
            now = self._clock()
            first = self.n_generated == 0
            self.n_generated += n_new
            self.t_last_token = now
            if first:
                self.t_first_token = now
                self.events.append((now, "first_token", {"kind": kind}))
                self._steps_since_progress = 0
                return
            self._steps_since_progress += 1
            if self._steps_since_progress >= self.progress_every:
                self._steps_since_progress = 0
                self.events.append(
                    (now, "progress", {"kind": kind, "n_generated": self.n_generated})
                )

    def note_speculation(self, proposed: int, accepted: int) -> None:
        with self._lock:
            self.spec_windows += 1
            self.spec_proposed += proposed
            self.spec_accepted += accepted

    def note_preempt(self) -> None:
        with self._lock:
            self.preemptions += 1
            self.events.append(
                (self._clock(), "preempt", {"n_generated": self.n_generated})
            )

    def note_replay(self) -> None:
        with self._lock:
            self.replays += 1
            self.events.append(
                (self._clock(), "replay", {"n_generated": self.n_generated})
            )

    def mark_finish(self, outcome: str, error: Optional[BaseException] = None) -> None:
        """Terminal mark; idempotent (the loop/watchdog race's loser
        must not overwrite the winner's outcome)."""
        with self._lock:
            if self.outcome is not None:
                return
            self.t_finish = self._clock()
            self.outcome = outcome
            if error is not None:
                self.error = str(error)
            self.events.append(
                (self.t_finish, "finish",
                 {"outcome": outcome, "n_generated": self.n_generated}),
            )

    # -------------------------------------------------------------- derived
    @property
    def queue_time_s(self) -> Optional[float]:
        if self.t_accept is None or self.t_admit is None:
            return None
        return max(0.0, self.t_admit - self.t_accept)

    @property
    def ttft_s(self) -> Optional[float]:
        if self.t_accept is None or self.t_first_token is None:
            return None
        return max(0.0, self.t_first_token - self.t_accept)

    @property
    def tpot_s(self) -> Optional[float]:
        """Mean seconds per output token AFTER the first (undefined
        below two tokens)."""
        if self.t_first_token is None or self.t_last_token is None:
            return None
        if self.n_generated < 2:
            return None
        return max(0.0, self.t_last_token - self.t_first_token) / (self.n_generated - 1)

    @property
    def total_s(self) -> Optional[float]:
        if self.t_accept is None or self.t_finish is None:
            return None
        return max(0.0, self.t_finish - self.t_accept)

    def to_dict(self) -> Dict:
        with self._lock:
            events = [
                {"t": t, "event": name, **(fields or {})}
                for t, name, fields in self.events
            ]
        return {
            "request_id": self.request_id,
            "model": self.model,
            "transport": self.transport,
            "journey_id": self.journey_id,
            "t_accept": self.t_accept,
            "t_finish": self.t_finish,
            "prompt_len": self.prompt_len,
            "n_generated": self.n_generated,
            "outcome": self.outcome,
            "error": self.error,
            "queue_time_s": self.queue_time_s,
            "ttft_s": self.ttft_s,
            "tpot_s": self.tpot_s,
            "total_s": self.total_s,
            "preemptions": self.preemptions,
            "replays": self.replays,
            "speculation": {
                "windows": self.spec_windows,
                "proposed": self.spec_proposed,
                "accepted": self.spec_accepted,
            },
            "events": events,
        }


class _NullTrace:
    """Observability-off stand-in: accepts every RequestTrace call as a
    no-op so call sites need no ``if trace`` branches."""

    __slots__ = ()

    def event(self, *a, **k):
        pass

    mark_accept = mark_transport = mark_admit = event
    note_tokens = note_speculation = note_preempt = note_replay = event
    mark_finish = event

    def to_dict(self):
        return {}

    queue_time_s = ttft_s = tpot_s = total_s = None
    n_generated = 0
    t_accept = None
    journey_id = None


NULL_TRACE = _NullTrace()


class TraceRing:
    """Bounded ring of recently finished traces (most recent last in
    storage, served most-recent-first)."""

    def __init__(self, capacity: int = 256):
        self.capacity = max(1, capacity)
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=self.capacity)  # guarded-by: _lock
        self.total = 0  # cumulative adds (ring is bounded); guarded-by: _lock

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def add(self, trace: RequestTrace) -> None:
        if trace is NULL_TRACE:
            return
        with self._lock:
            self._ring.append(trace)
            self.total += 1

    def recent(self, n: int = 32) -> List[RequestTrace]:
        with self._lock:
            items = list(self._ring)
        return list(reversed(items))[: max(0, n)]

    def get(self, request_id: int) -> Optional[RequestTrace]:
        with self._lock:
            items = list(self._ring)
        for tr in reversed(items):
            if tr.request_id == request_id:
                return tr
        return None
