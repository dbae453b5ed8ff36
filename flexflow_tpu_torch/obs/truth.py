"""Cost-model truth telemetry: does the roofline's arithmetic match the
device's clock? (Port of ``flexflow_tpu/obs/truth.py``, which imports
nothing of JAX: the same code, kept as the port's own copy.)

:class:`PredictionLedger` joins predictions with measurements under
stable keys:

* **predict side** — the port's generation engine predicts each step
  (``prefill[N]``, ``prefix_prefill[W]``, ``decode``, ``verify``) from
  its ``ServingFlops`` roofline with the device's chip preset
  (``obs/capacity.py``), over the work the fixed-shape step executes;
* **measure side** — the step's execute seconds on the host clock
  (launch to completion), so host preparation does not pollute the
  pair; a step that captured its graph is left out (its wall time is
  the program registry's capture time);
* **join** — every measured sample with a registered prediction becomes
  one (predicted, measured) pair; measurements with no prediction are
  *counted* (``unpredicted_total``), never dropped.

On top of the pairs sits an EWMA **drift detector**: the exponentially
weighted signed relative error per key trips a staleness alarm once it
exceeds ``drift_threshold`` with at least ``min_samples`` pairs,
carrying a human blame string ("decode: predicted 1.8ms, measured p50
3.1ms, error +72%, ..."). Alarms re-arm only after the EWMA recovers
below half the threshold. The scheduler points ``on_alarm`` at the
flight ring; ``GET /v2/debug/predictions`` serves the report and the
``flexflow_sim_*`` families ride ``/metrics``. ``GLOBAL_LEDGER`` is the
process-wide ledger (the JAX package's search cost model feeds its own;
the port has no search yet).

Everything is host-side arithmetic under one lock: an observe is a dict
lookup, a deque append and a few float ops. The clock is injectable so
drift tests run on virtual time.
"""
from __future__ import annotations

import math
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional


def _fmt_s(seconds: float) -> str:
    """Human seconds: 1.2s / 3.1ms / 12.3us."""
    if seconds >= 1.0:
        return f"{seconds:.2f}s"
    if seconds >= 1e-3:
        return f"{seconds * 1e3:.1f}ms"
    return f"{seconds * 1e6:.1f}us"


class _Entry:
    """Per-key ledger state: the latest prediction plus a bounded
    window of measured samples and the drift EWMA."""

    __slots__ = (
        "key", "label", "provenance", "predicted_s", "prediction_id",
        "pairs", "measured", "errs", "ewma_err", "alarming", "last_blame",
        "alarm_enabled",
    )

    def __init__(self, key: str, predicted_s: float, label: str,
                 provenance: str, prediction_id: int, window: int,
                 alarm_enabled: bool = True):
        self.key = key
        self.label = label
        self.provenance = provenance
        self.predicted_s = predicted_s
        self.prediction_id = prediction_id
        self.alarm_enabled = alarm_enabled
        self.pairs = 0
        self.measured: deque = deque(maxlen=window)
        # per-PAIR relative errors, stamped at measure time against the
        # prediction in effect for THAT sample — a key whose prediction
        # varies per call (decode: context grows every step) must not
        # have old samples re-graded against the newest prediction
        self.errs: deque = deque(maxlen=window)
        self.ewma_err: Optional[float] = None
        self.alarming = False
        self.last_blame: Optional[str] = None

    def measured_p50(self) -> Optional[float]:
        if not self.measured:
            return None
        s = sorted(self.measured)
        return s[(len(s) - 1) // 2]

    def rel_errors(self) -> List[float]:
        return list(self.errs)


class PredictionLedger:
    """The (predicted, measured) join with per-key EWMA drift alarms.

    ``predict(key, seconds)`` registers/refreshes a prediction and
    returns its id (the tag ``CostMetrics.prediction_id`` carries);
    ``measure(key, seconds)`` joins one measured sample;
    ``observe(key, predicted, measured)`` does both for callers that
    hold both sides at once (the engine's per-step path).

    Thread-safety: one lock — the writer is the scheduler loop thread
    (the engine's steps); readers are HTTP
    scrape threads. ``on_alarm`` fires outside the lock and exceptions
    are swallowed: telemetry must never break the path it watches.
    """

    def __init__(
        self,
        *,
        alpha: float = 0.25,
        drift_threshold: float = 0.5,
        min_samples: int = 4,
        window: int = 128,
        max_entries: int = 4096,
        max_alarms: int = 64,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.alpha = alpha
        self.drift_threshold = drift_threshold
        self.min_samples = min_samples
        self.window = window
        self.max_entries = max_entries
        self.clock = clock
        self._lock = threading.Lock()
        self._entries: Dict[str, _Entry] = {}  # guarded-by: _lock
        self._unpredicted: Dict[str, int] = {}  # guarded-by: _lock
        self.alarms: deque = deque(maxlen=max_alarms)  # guarded-by: _lock
        self.on_alarm: Optional[Callable[[Dict], None]] = None
        self._next_id = 0  # guarded-by: _lock
        self.predictions_total = 0  # guarded-by: _lock
        self.pairs_total = 0  # guarded-by: _lock
        self.unpredicted_total = 0  # guarded-by: _lock
        self.alarms_total = 0  # guarded-by: _lock
        self._summary_cache: Optional[tuple] = None  # guarded-by: _lock

    # ------------------------------------------------------------- predict
    def predict(
        self,
        key: str,
        predicted_s: float,
        label: Optional[str] = None,
        provenance: Optional[str] = None,
        alarm: bool = True,
    ) -> int:
        """Register (or refresh) the prediction for ``key``; returns the
        prediction id. ``provenance`` names where the number came from
        ("calibration table entry from ...", "analytic roofline x
        derate", "serving roofline") — it ends the blame string when the
        key drifts. ``alarm=False`` keeps the pair-join and error
        distributions but never raises a drift alarm — for predictions
        the source itself knows are uncalibrated (the serving roofline
        on a CPU host models a chip that is not there)."""
        with self._lock:
            self.predictions_total += 1
            entry = self._entries.get(key)
            if entry is not None:
                entry.predicted_s = predicted_s
                entry.alarm_enabled = alarm
                if label:
                    entry.label = label
                if provenance:
                    entry.provenance = provenance
                return entry.prediction_id
            if len(self._entries) >= self.max_entries:
                self._evict_one_locked()
            self._next_id += 1
            self._entries[key] = _Entry(
                key, predicted_s, label or key, provenance or "unspecified",
                self._next_id, self.window, alarm_enabled=alarm,
            )
            return self._next_id

    def _evict_one_locked(self) -> None:
        """Drop the oldest never-measured entry (search sweeps register
        thousands of op signatures that are never executed); fall back
        to the oldest entry outright so the ledger stays bounded."""
        victim = None
        for k, e in self._entries.items():
            if e.pairs == 0:
                victim = k
                break
        if victim is None:
            victim = next(iter(self._entries))
        del self._entries[victim]

    # ------------------------------------------------------------- measure
    def measure(self, key: str, measured_s: float) -> None:
        """Join one measured sample with ``key``'s prediction. No
        prediction -> counted as unpredicted, not dropped."""
        alarm = None
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.unpredicted_total += 1
                if key in self._unpredicted or len(self._unpredicted) < self.max_entries:
                    self._unpredicted[key] = self._unpredicted.get(key, 0) + 1
                return
            entry.pairs += 1
            self.pairs_total += 1
            entry.measured.append(measured_s)
            alarm = self._update_drift_locked(entry, measured_s)
            if alarm is not None:
                # same hold that bumped alarms_total: a report() can
                # never see the counter ahead of the alarms list
                self.alarms.append(alarm)
        if alarm is not None:
            # the callback runs OUTSIDE the lock — observers may
            # re-enter the ledger
            cb = self.on_alarm
            if cb is not None:
                try:
                    cb(alarm)
                except Exception:
                    pass  # observability must never break the hot path

    def observe(
        self,
        key: str,
        predicted_s: float,
        measured_s: float,
        label: Optional[str] = None,
        provenance: Optional[str] = None,
        alarm: bool = True,
    ) -> None:
        """Matched pair in one call (predict + measure)."""
        self.predict(key, predicted_s, label=label, provenance=provenance,
                     alarm=alarm)
        self.measure(key, measured_s)

    # --------------------------------------------------------------- drift
    def _update_drift_locked(self, entry: _Entry, measured_s: float) -> Optional[Dict]:
        if entry.predicted_s <= 0:
            return None
        rel = (measured_s - entry.predicted_s) / entry.predicted_s
        entry.errs.append(rel)
        # seed the EWMA at the first sample (not 0): a constant-error
        # stream reads its true error immediately instead of asymptoting
        entry.ewma_err = (
            rel if entry.ewma_err is None
            else self.alpha * rel + (1.0 - self.alpha) * entry.ewma_err
        )
        err = entry.ewma_err
        if not entry.alarm_enabled:
            # pairs and error distributions still accumulate for the
            # report; only the alarm is suppressed
            return None
        if entry.alarming:
            # hysteresis: re-arm only once the drift clearly recovered
            if abs(err) < self.drift_threshold / 2.0:
                entry.alarming = False
            return None
        if entry.pairs < self.min_samples or abs(err) < self.drift_threshold:
            return None
        entry.alarming = True
        self.alarms_total += 1
        p50 = entry.measured_p50() or measured_s
        blame = (
            f"{entry.label}: predicted {_fmt_s(entry.predicted_s)}, "
            f"measured p50 {_fmt_s(p50)}, error {err:+.0%}, {entry.provenance}"
        )
        entry.last_blame = blame
        return {
            "t": self.clock(),
            "key": entry.key,
            "label": entry.label,
            "predicted_s": entry.predicted_s,
            "measured_p50_s": p50,
            "rel_err": err,
            "provenance": entry.provenance,
            "blame": blame,
        }

    # ------------------------------------------------------------- reports
    def report(self) -> Dict:
        """The ``GET /v2/debug/predictions`` payload: every key's
        (predicted, measured) state, the unpredicted counts, alarms,
        and cumulative counters."""
        with self._lock:
            entries = []
            for e in sorted(self._entries.values(), key=lambda e: e.key):
                errs = sorted(e.rel_errors())
                n = len(errs)
                entries.append({
                    "key": e.key,
                    "label": e.label,
                    "provenance": e.provenance,
                    "predicted_s": e.predicted_s,
                    "pairs": e.pairs,
                    "measured_p50_s": e.measured_p50(),
                    "rel_err_p50": errs[(n - 1) // 2] if n else None,
                    # nearest-rank (stats.py LatencyWindow convention):
                    # (19*n)//20 reads p100 whenever n is a multiple of 20
                    "rel_err_p95": (
                        errs[min(n - 1, math.ceil(0.95 * n) - 1)] if n else None
                    ),
                    "rel_err_ewma": e.ewma_err,
                    "alarming": e.alarming,
                    "alarm_enabled": e.alarm_enabled,
                    "last_blame": e.last_blame,
                })
            return {
                "counters": {
                    "predictions_total": self.predictions_total,
                    "pairs_total": self.pairs_total,
                    "unpredicted_total": self.unpredicted_total,
                    "drift_alarms_total": self.alarms_total,
                },
                "entries": entries,
                "unpredicted": dict(self._unpredicted),
                "alarms": list(self.alarms),
            }

    def scrape_snapshot(self, limit: int = 128) -> Dict:
        """The bounded ``/metrics`` view: cumulative counters plus at
        most ``limit`` PAIRED entries (key, pairs, error quantiles).
        ``report()`` builds every entry — thousands of never-executed
        search signatures included — which is fine for a debug endpoint
        but must not run under the measurement lock on every scrape."""
        with self._lock:
            paired = [e for e in self._entries.values() if e.pairs > 0]
            paired.sort(key=lambda e: e.key)
            entries = []
            for e in paired[:limit]:
                errs = sorted(e.errs)
                n = len(errs)
                entries.append({
                    "key": e.key,
                    "pairs": e.pairs,
                    "rel_err_p50": errs[(n - 1) // 2] if n else None,
                    "rel_err_p95": (
                        errs[min(n - 1, math.ceil(0.95 * n) - 1)] if n else None
                    ),
                })
            return {
                "counters": {
                    "predictions_total": self.predictions_total,
                    "pairs_total": self.pairs_total,
                    "unpredicted_total": self.unpredicted_total,
                    "drift_alarms_total": self.alarms_total,
                },
                "entries": entries,
            }

    def error_summary(self) -> Dict:
        """Cheap cross-key aggregates for the ``perf_*`` gauges.
        Memoized on the ledger's mutation stamp: the error_p50 and
        error_max gauges both call this per stats snapshot, and the
        per-key sorts must not run twice under the lock on the scrape
        path the tracing-overhead budget protects."""
        with self._lock:
            stamp = (self.pairs_total, self.predictions_total,
                     len(self._entries))
            if self._summary_cache is not None and self._summary_cache[0] == stamp:
                return self._summary_cache[1]
            errs = []
            ewma_abs = 0.0
            for e in self._entries.values():
                if e.pairs == 0:
                    continue
                es = e.rel_errors()
                if es:
                    s = sorted(abs(x) for x in es)
                    errs.append(s[(len(s) - 1) // 2])
                if e.ewma_err is not None:
                    ewma_abs = max(ewma_abs, abs(e.ewma_err))
            errs.sort()
            out = {
                "keys_paired": len(errs),
                "abs_err_p50": errs[(len(errs) - 1) // 2] if errs else 0.0,
                "abs_err_max": errs[-1] if errs else 0.0,
                "ewma_abs_max": ewma_abs,
            }
            self._summary_cache = (stamp, out)
            return out

    def remove_namespace(self, prefix: str) -> None:
        """Drop every key ``prefix`` or ``prefix.*`` (executors evict
        their namespace on GC, mirroring ProgramRegistry)."""
        dot = prefix + "."
        with self._lock:
            self._summary_cache = None
            for d in (self._entries, self._unpredicted):
                for k in [k for k in d if k == prefix or k.startswith(dot)]:
                    del d[k]


# Process-wide ledger (rendered on /metrics and /v2/debug/predictions);
# the port has no search cost model to feed it yet. Generation engines
# keep per-engine ledgers (engine.ledger) so per-model serving
# telemetry stays separable.
GLOBAL_LEDGER = PredictionLedger()
