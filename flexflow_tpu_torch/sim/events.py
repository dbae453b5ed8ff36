"""Discrete-event core for the fleet digital twin: a virtual clock and
a deterministic (time, seq) event heap.

Determinism is the whole point — two runs of the same schedule + seed
must produce byte-identical event traces, so capacity answers are
reviewable artifacts rather than measurements. Three rules make it so:

* time is virtual: the clock only moves when the loop dispatches an
  event (no module of this package reads a real clock, ``perf_counter``
  included);
* ties are broken by a monotone sequence number, so same-instant
  events dispatch in scheduling order, never hash or heap order;
* every dispatched event is appended to ``trace`` and folded into a
  SHA-256 ``trace_digest`` — the identity tests and the ``simfleet``
  report pin.
"""
from __future__ import annotations

import hashlib
import heapq
from typing import Callable, List, Optional, Tuple


class SimClock:
    """Callable virtual clock (the same read interface as the
    injectable ``time.monotonic``-shaped clocks the serving stack
    already takes), advanced only by the event loop."""

    __slots__ = ("_t",)

    def __init__(self, t0: float = 0.0):
        self._t = float(t0)

    def __call__(self) -> float:
        return self._t

    def _advance_to(self, t: float) -> None:
        if t < self._t - 1e-12:
            raise ValueError(
                f"virtual time cannot run backwards ({t} < {self._t})"
            )
        self._t = max(self._t, float(t))


class EventLoop:
    """Deterministic event heap over a :class:`SimClock`.

    ``at(t, kind, fn)`` / ``after(delay, kind, fn)`` schedule
    ``fn(t)``; ``run()`` dispatches in (time, seq) order until the heap
    drains. ``detail`` strings join the trace so digests distinguish
    e.g. which request an event belonged to.
    """

    def __init__(self, clock: Optional[SimClock] = None):
        self.clock = clock or SimClock()
        self._heap: List[Tuple[float, int, str, str, Callable]] = []
        self._seq = 0
        self.events_run = 0
        self.trace: List[Tuple[float, int, str, str]] = []

    def at(self, t: float, kind: str, fn: Callable[[float], None],
           detail: str = "") -> int:
        if t < self.clock() - 1e-12:
            raise ValueError(
                f"cannot schedule {kind!r} in the past "
                f"({t} < {self.clock()})"
            )
        self._seq += 1
        heapq.heappush(self._heap, (float(t), self._seq, kind, detail, fn))
        return self._seq

    def after(self, delay: float, kind: str, fn: Callable[[float], None],
              detail: str = "") -> int:
        return self.at(self.clock() + max(0.0, float(delay)), kind, fn, detail)

    def run(self, until: Optional[float] = None,
            max_events: int = 2_000_000) -> int:
        """Dispatch until the heap drains (or ``until``); returns the
        number of events run. ``max_events`` is a runaway backstop — a
        zero-cost iteration loop would otherwise spin forever at one
        virtual instant."""
        while self._heap:
            t = self._heap[0][0]
            if until is not None and t > until:
                break
            t, seq, kind, detail, fn = heapq.heappop(self._heap)
            self.clock._advance_to(t)
            self.events_run += 1
            if self.events_run > max_events:
                raise RuntimeError(
                    f"simulation exceeded {max_events} events at t={t}; "
                    "a zero-duration iteration is likely looping"
                )
            self.trace.append((round(t, 9), seq, kind, detail))
            fn(t)
        return self.events_run

    def trace_digest(self) -> str:
        """SHA-256 over the dispatched-event trace — the determinism
        fingerprint two runs of the same scenario must share."""
        h = hashlib.sha256()
        for entry in self.trace:
            h.update(repr(entry).encode())
        return h.hexdigest()
