"""Engine flight recorder: a bounded ring of per-step records written
by the continuous-batching scheduler loop.

(Port of ``flexflow_tpu/obs/flight.py``, which imports nothing of JAX:
the same code, kept as the port's own copy.)

FlexFlow brackets kernels with cudaEvents under ``--profiling`` and
replays Legion traces for postmortems; the serving-plane analog here is
a crash-safe, lock-cheap ring the scheduler writes once per step:

  step records  step kind (prefill/decode/verify), batch occupancy,
                queue depth, free cache blocks, drafted/accepted/emitted
                token counts, and wall-clock phase timings
                (schedule / admit / prefix_plan / draft / sample /
                device / bookkeep). Decode/verify/prefill records
                also carry ``execute_s`` — the device-EXECUTE
                seconds inside the conflated "device" phase (the
                step's launch to its completion), so a
                postmortem shows how much of a slow step was device
                compute vs host overhead. The ring's phases stay
                DURATIONS rendered back-to-back; the real-offset
                two-lane view is obs/steptrace.py's capture
                (GET /v2/debug/anatomy).
  events        instantaneous markers from the self-healing layer:
                step_failed, step_retry, watchdog_trip, quarantine,
                restart, recovery, engine_failed

Both share one ring so a snapshot interleaves them in true order — the
"what was the engine doing when it tripped the watchdog?" answer.

Incidents: the supervisor calls :meth:`incident` at every quarantine /
restart / give-up; the recorder freezes the trailing window of records
into a bounded ``incidents`` list AND returns the snapshot so it can be
attached to the error object riding back to the client. Every
recovery therefore has a postmortem without anyone scraping in time.

``to_chrome_trace`` renders the ring as chrome://tracing JSON (load in
``chrome://tracing`` or https://ui.perfetto.dev): phases as duration
events, markers as instants, occupancy/free-blocks as counter tracks.

Clock discipline: phase DURATIONS and the record's
``t`` stamp use ``time.perf_counter`` — physical profiling data even in
virtual-clock tests — while scheduler-plane consumers (request traces,
SLO windows) run on the scheduler's injectable clock. Mixing the two on
one timeline produced incoherent interleavings in virtual-clock tests,
so every record now carries BOTH stamps: ``t`` (the recorder's physical
clock; the timeline renders exclusively from this one) and ``t_sched``
(the scheduler's clock, when one is supplied via ``sched_clock``) for
correlating a flight record with trace/SLO events. Disabled recorders
(``enabled=False``) make every method a cheap no-op.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional


class FlightRecorder:
    def __init__(
        self,
        capacity: int = 512,
        clock: Callable[[], float] = time.perf_counter,
        max_incidents: int = 8,
        incident_window: int = 64,
        enabled: bool = True,
        sched_clock: Optional[Callable[[], float]] = None,
    ):
        self.enabled = enabled
        self.capacity = max(1, capacity)
        self.clock = clock
        # the owner's (possibly virtual) clock: stamps ride records as
        # t_sched so timeline entries correlate with trace/SLO events
        self.sched_clock = sched_clock
        self.incident_window = incident_window
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=self.capacity)  # guarded-by: _lock
        self._seq = 0  # guarded-by: _lock
        self.incidents: deque = deque(maxlen=max(1, max_incidents))  # guarded-by: _lock

    @property
    def seq(self) -> int:
        with self._lock:
            return self._seq

    # ------------------------------------------------------------ recording
    def record_step(
        self,
        kind: str,
        *,
        phases: Optional[Dict[str, float]] = None,
        **fields,
    ) -> int:
        """One scheduler-loop step. ``phases`` maps phase name ->
        seconds; extra fields (occupancy, queue_depth, blocks_free,
        drafted, accepted, emitted, admitted) ride along verbatim."""
        if not self.enabled:
            return -1
        rec = {"t": self.clock(), "kind": kind}
        if self.sched_clock is not None:
            rec["t_sched"] = self.sched_clock()
        if phases:
            rec["phases"] = phases
        rec.update(fields)
        with self._lock:
            self._seq += 1
            rec["seq"] = self._seq
            self._ring.append(rec)
        return rec["seq"]

    def record_event(self, kind: str, **fields) -> int:
        """Instantaneous marker (no phases): supervisor/watchdog events."""
        return self.record_step(kind, **fields)

    def incident(self, kind: str, **fields) -> Dict:
        """Freeze the trailing window of records as a postmortem. The
        snapshot is stored in ``incidents`` AND returned so callers can
        attach it to the error context (PoisonedRequestError /
        EngineFailedError / restart cause)."""
        if not self.enabled:
            return {}
        marker_seq = self.record_event("incident:" + kind, **fields)
        with self._lock:
            records = list(self._ring)[-self.incident_window:]
            snap = {
                "kind": kind,
                "t": self.clock(),
                **({"t_sched": self.sched_clock()} if self.sched_clock is not None else {}),
                "seq": marker_seq,
                **fields,
                "records": records,
            }
            # append under the same lock: a scrape thread listing
            # incidents mid-append must not race the supervisor
            self.incidents.append(snap)
        return snap

    # ------------------------------------------------------------ snapshots
    def incident_snapshots(self) -> List[Dict]:
        """Locked copy of the retained incident postmortems — the read
        path for scrape threads (iterating the deque raw races a
        supervisor appending mid-incident, exactly when it matters)."""
        with self._lock:
            return list(self.incidents)

    def snapshot(self, last: Optional[int] = None) -> List[Dict]:
        """Ring contents in order, oldest first (``last`` trims to the
        trailing N)."""
        with self._lock:
            records = list(self._ring)
        if last is not None:
            records = records[-last:]
        return records

    def to_chrome_trace(self, pid: int = 1, name: str = "engine") -> Dict:
        """chrome://tracing JSON: one duration event per step (phases as
        nested durations), instants for markers, counter tracks for
        occupancy and free cache blocks. Timestamps are microseconds
        relative to the oldest retained record."""
        records = self.snapshot()
        events: List[Dict] = [
            {"name": "process_name", "ph": "M", "pid": pid,
             "args": {"name": name}},
        ]
        if not records:
            return {"traceEvents": events, "displayTimeUnit": "ms"}
        t0 = records[0]["t"]
        for rec in records:
            ts = (rec["t"] - t0) * 1e6
            phases = rec.get("phases")
            args = {
                k: v for k, v in rec.items()
                if k not in ("t", "phases") and v is not None
            }
            if phases:
                total = sum(phases.values())
                events.append({
                    "name": rec["kind"], "ph": "X", "pid": pid, "tid": 1,
                    "ts": ts, "dur": total * 1e6, "args": args,
                })
                off = ts
                for pname, dur in phases.items():
                    events.append({
                        "name": pname, "ph": "X", "pid": pid, "tid": 2,
                        "ts": off, "dur": dur * 1e6, "args": {},
                    })
                    off += dur * 1e6
            else:
                events.append({
                    "name": rec["kind"], "ph": "i", "pid": pid, "tid": 3,
                    "ts": ts, "s": "p", "args": args,
                })
            for counter in ("occupancy", "blocks_free", "queue_depth"):
                if counter in rec:
                    events.append({
                        "name": counter, "ph": "C", "pid": pid,
                        "ts": ts, "args": {counter: rec[counter]},
                    })
        return {"traceEvents": events, "displayTimeUnit": "ms"}
