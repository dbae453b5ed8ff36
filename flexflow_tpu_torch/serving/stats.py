"""Serving statistics (port of ``flexflow_tpu/serving/stats.py``):
per-model counters, latency windows, Prometheus histograms and gauges,
surfaced on the HTTP server's ``/v2/stats`` and ``/metrics``.

The generation scheduler and the dynamic batcher each report into one
:class:`ServingStats` per model: counters (admitted / rejected / ... and
dynamic ones such as the per-reason rejection split), named latency
windows (queue_time, and ttft / tpot in generation) that also feed
histograms, and ``gauges`` (the batcher's ``queue_depth``; zero-arg callables
evaluated at snapshot time, so the endpoints read live values without
the stats object holding references into hot-path state). The
speculation, constrained-decoding, goodput, recovery and durable-serving
counters register their gauges into it. :class:`RecoveryStats` lives in
``generation/recovery.py`` and is re-exported here, so both import paths
name the one class.

Thread-safety: counters take a lock (HTTP handler threads, the batchers'
collector threads and the scheduler's loop and watchdog threads write
concurrently); snapshots are
consistent-enough reads for monitoring, not transactions.
"""
from __future__ import annotations

import bisect
import math
import threading
from collections import deque
from typing import Callable, Dict, Optional, Sequence, Tuple


class LatencyWindow:
    """Rolling window of the last ``maxlen`` request latencies with
    cheap summary stats (count is cumulative; percentiles are over the
    window). Observations may carry an *exemplar* — an opaque id (the
    fleet journey id) retained alongside the sample so a bad percentile
    links back to one concrete, stitchable request journey."""

    def __init__(self, maxlen: int = 512):
        self._lock = threading.Lock()
        self._window: deque = deque(maxlen=maxlen)  # guarded-by: _lock
        # (seconds, exemplar-id) pairs, same horizon as the window —
        # only samples that arrived WITH an id (journeys on)
        self._exemplars: deque = deque(maxlen=maxlen)  # guarded-by: _lock
        self.count = 0  # guarded-by: _lock
        self.total_s = 0.0  # guarded-by: _lock
        self.max_s = 0.0  # guarded-by: _lock

    def record(self, seconds: float, exemplar: Optional[str] = None) -> None:
        with self._lock:
            self.count += 1
            self.total_s += seconds
            self.max_s = max(self.max_s, seconds)
            self._window.append(seconds)
            if exemplar is not None:
                self._exemplars.append((seconds, exemplar))

    def slow_exemplars(self, k: int = 8) -> list:
        """Up to ``k`` worst-decile samples (>= the window p90, ties
        included) that carried an exemplar id, slowest first, deduped by
        id — the ``/v2/debug/slow`` rows for this window."""
        with self._lock:
            window = sorted(self._window)
            pairs = list(self._exemplars)
        if not window or not pairs:
            return []
        p90 = window[min(len(window) - 1, math.ceil(0.90 * len(window)) - 1)]
        out, seen = [], set()
        for seconds, ex in sorted(pairs, key=lambda p: -p[0]):
            if seconds < p90 or ex in seen:
                continue
            seen.add(ex)
            out.append({"seconds": seconds, "journey_id": ex})
            if len(out) >= k:
                break
        return out

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            window = sorted(self._window)
            n = len(window)
            # nearest-rank: ceil(p*n) is the 1-based rank of the p-th
            # percentile sample (int(p*n) biased high on small windows:
            # p50 of 2 samples returned the max)
            pct = lambda p: window[min(n - 1, math.ceil(p * n) - 1)] if n else 0.0
            return {
                "count": self.count,
                "sum_s": self.total_s,
                "mean_s": self.total_s / self.count if self.count else 0.0,
                "max_s": self.max_s,
                "p50_s": pct(0.50),
                "p95_s": pct(0.95),
                "p99_s": pct(0.99),
            }


class Histogram:
    """Fixed-bucket latency histogram in the Prometheus shape:
    cumulative bucket counts keyed by upper bound (``le``), plus running
    sum and count. Buckets are chosen once (seconds, spanning sub-ms
    TTFT on warm engines to multi-second cold paths); observations are
    a bisect + three increments under a lock."""

    DEFAULT_BUCKETS: Tuple[float, ...] = (
        0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
        0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
    )

    def __init__(self, buckets: Optional[Sequence[float]] = None):
        bounds = tuple(sorted(buckets or self.DEFAULT_BUCKETS))
        if not bounds or bounds[-1] != math.inf:
            bounds = bounds + (math.inf,)
        self.bounds = bounds
        self._lock = threading.Lock()
        self._counts = [0] * len(bounds)  # per-bucket (non-cumulative); guarded-by: _lock
        self.count = 0  # guarded-by: _lock
        self.sum = 0.0  # guarded-by: _lock

    def observe(self, value: float) -> None:
        # bucket i is the first bound >= value (the last bound is +Inf,
        # so the index always lands in range)
        i = bisect.bisect_left(self.bounds, value)
        with self._lock:
            self.count += 1
            self.sum += value
            self._counts[i] += 1

    def snapshot(self) -> Dict:
        """Cumulative (le, count) pairs the exposition format wants."""
        with self._lock:
            counts = list(self._counts)
            total, s = self.count, self.sum
        cum, buckets = 0, []
        for b, c in zip(self.bounds, counts):
            cum += c
            buckets.append((b, cum))
        return {"count": total, "sum": s, "buckets": buckets}


class ServingStats:
    """Counters + latency windows + histograms + live gauges for one
    served model. ``observe(name, s)`` feeds a named window (rolling
    percentiles on /v2/stats) AND a Prometheus histogram (/metrics)
    under the same name — queue_time / ttft / tpot in generation."""

    COUNTERS = ("admitted", "rejected", "expired", "completed", "failed", "cancelled")

    def __init__(self, latency_window: int = 512):
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {c: 0 for c in self.COUNTERS}  # guarded-by: _lock
        self.latency = LatencyWindow(latency_window)
        self._window_len = latency_window
        # name -> zero-arg callable returning a number (queue depth,
        # cache occupancy, tokens/s ...), evaluated at snapshot time.
        # Registration and iteration share self._lock: a model loading
        # mid-scrape must not mutate the dict under snapshot()'s feet.
        self.gauges: Dict[str, Callable[[], float]] = {}  # guarded-by: _lock
        self._windows: Dict[str, LatencyWindow] = {}  # guarded-by: _lock
        self._histograms: Dict[str, Histogram] = {}  # guarded-by: _lock

    def incr(self, counter: str, n: int = 1) -> None:
        with self._lock:
            self._counts[counter] = self._counts.get(counter, 0) + n

    def get(self, counter: str) -> int:
        with self._lock:
            return self._counts.get(counter, 0)

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def add_gauge(self, name: str, fn: Callable[[], float]) -> None:
        with self._lock:
            self.gauges[name] = fn

    def observe(self, name: str, seconds: float,
                exemplar: Optional[str] = None) -> None:
        """Record one observation into the named window + histogram
        (created on first use). ``exemplar`` — a journey id, retained
        for worst-decile samples so tail latency links to a stitched
        journey — is None whenever journeys are off."""
        with self._lock:
            w = self._windows.get(name)
            if w is None:
                w = self._windows[name] = LatencyWindow(self._window_len)
                self._histograms[name] = Histogram()
            h = self._histograms[name]
        w.record(seconds, exemplar=exemplar)
        h.observe(seconds)

    def slow_exemplars(self, k: int = 8) -> Dict[str, list]:
        """Worst-decile exemplars per named window (ttft / tpot /
        queue_time ...), windows with none omitted."""
        with self._lock:
            windows = dict(self._windows)
        out: Dict[str, list] = {}
        for name, w in windows.items():
            rows = w.slow_exemplars(k)
            if rows:
                out[name] = rows
        return out

    def window_p95(self, name: str) -> float:
        """One named window's rolling p95 (0.0 before any observation)
        — the AdaptiveLimiter's queue-time / TTFT pressure inputs,
        without snapshotting every window per control tick."""
        with self._lock:
            w = self._windows.get(name)
        return w.snapshot()["p95_s"] if w is not None else 0.0

    def window_snapshots(self) -> Dict[str, Dict]:
        with self._lock:
            windows = dict(self._windows)
        return {name: w.snapshot() for name, w in windows.items()}

    def histogram_snapshots(self) -> Dict[str, Dict]:
        with self._lock:
            hists = dict(self._histograms)
        return {name: h.snapshot() for name, h in hists.items()}

    def gauge_values(self) -> Dict[str, Optional[float]]:
        """Evaluate every gauge (None for a dying gauge) — the shared
        read path for /v2/stats and /metrics."""
        with self._lock:
            gauges = list(self.gauges.items())
        out: Dict[str, Optional[float]] = {}
        for name, fn in gauges:
            try:
                out[name] = fn()
            except Exception:  # a dying gauge must not kill a scrape
                out[name] = None
        return out

    def snapshot(self) -> Dict:
        out: Dict = dict(self.counters())
        out["latency"] = self.latency.snapshot()
        for name, snap in self.window_snapshots().items():
            out[name] = snap
        out.update(self.gauge_values())
        return out


class SpeculationStats:
    """Speculative-decoding counters for one served model: drafted
    (proposed) vs accepted tokens per verification window, plus the
    derived acceptance rate and mean accepted run length surfaced as
    /v2/stats gauges.

    ``record_window(proposed, accepted)`` is called once per verify
    window per sequence; windows with zero proposals (drafter miss,
    budget cap) still count toward ``windows`` so the mean run length
    reflects what the engine actually did.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self.windows = 0  # guarded-by: _lock
        self.proposed = 0  # guarded-by: _lock
        self.accepted = 0  # guarded-by: _lock
        self.emitted = 0  # guarded-by: _lock

    def record_window(self, proposed: int, accepted: int, emitted: int) -> None:
        with self._lock:
            self.windows += 1
            self.proposed += proposed
            self.accepted += accepted
            self.emitted += emitted

    def acceptance_rate(self) -> float:
        with self._lock:
            return self.accepted / self.proposed if self.proposed else 0.0

    def mean_accepted_len(self) -> float:
        """Mean accepted drafts per verification window."""
        with self._lock:
            return self.accepted / self.windows if self.windows else 0.0

    def mean_emitted_len(self) -> float:
        """Mean tokens emitted per verification window (accepted drafts
        + the correction/bonus token) — the tokens-per-engine-step
        multiplier over non-speculative decode."""
        with self._lock:
            return self.emitted / self.windows if self.windows else 0.0

    def counts(self) -> Dict[str, int]:
        """Locked snapshot of the raw counters — the gauge read path
        (gauge callables run on scrape threads while the verify loop is
        mid-record_window)."""
        with self._lock:
            return {
                "windows": self.windows,
                "proposed": self.proposed,
                "accepted": self.accepted,
                "emitted": self.emitted,
            }

    def register_gauges(self, stats: "ServingStats", prefix: str = "spec_") -> None:
        stats.add_gauge(prefix + "windows", lambda: self.counts()["windows"])
        stats.add_gauge(prefix + "tokens_proposed", lambda: self.counts()["proposed"])
        stats.add_gauge(prefix + "tokens_accepted", lambda: self.counts()["accepted"])
        stats.add_gauge(prefix + "acceptance_rate", self.acceptance_rate)
        stats.add_gauge(prefix + "mean_accepted_len", self.mean_accepted_len)
        stats.add_gauge(prefix + "mean_emitted_len", self.mean_emitted_len)


class ConstrainedStats:
    """Constrained-decoding counters for one generation engine
    (generation/constrained/), surfaced as /v2/stats gauges and the
    ``flexflow_serving_constrained_*`` Prometheus families:

      grammar_cache_hits      response_format specs served from the
                              per-model compiled-grammar cache
      grammar_cache_misses    specs that compiled a new token DFA
      grammar_compile_seconds cumulative wall seconds spent compiling
                              grammars (floats accumulate)
      masked_steps            slot-steps that carried a real (non-zero)
                              grammar mask row into prefill, decode or
                              verify
      dead_end_failures       constrained streams quarantined because
                              the automaton refused an emitted token or
                              reached an empty mask (injected faults or
                              replay divergence — pruning makes natural
                              dead-ends unreachable)

    Writers: the scheduler loop thread (mask assembly/advance) and
    serving submit threads (the grammar cache); the lock keeps counts
    exact so tests can assert them.
    """

    FIELDS = (
        "grammar_cache_hits", "grammar_cache_misses",
        "grammar_compile_seconds", "masked_steps", "dead_end_failures",
    )

    def __init__(self):
        self._lock = threading.Lock()
        for f in self.FIELDS:
            setattr(self, f, 0)

    def incr(self, field: str, n=1) -> None:
        if field not in self.FIELDS:
            raise ValueError(f"unknown constrained counter {field!r}")
        with self._lock:
            setattr(self, field, getattr(self, field) + n)

    def register_gauges(self, stats: "ServingStats") -> None:
        # cumulative counters -> prometheus-conventional _total names
        # (flexflow_serving_constrained_* once prom.py prefixes them)
        for f in self.FIELDS:
            stats.add_gauge(
                f"constrained_{f}_total", lambda f=f: getattr(self, f)
            )


class GoodputStats:
    """Deadline-goodput accounting for one served model: tokens emitted
    on requests that COMPLETED within their deadline vs all tokens
    emitted (a request with no deadline counts as in-deadline when it
    completes; failed/expired/cancelled requests contribute only to the
    denominator). The honest throughput number — raw tokens/s includes
    work clients never benefited from.

    Written once per finished request by the scheduler's trace-done
    hook (loop or watchdog thread), read by scrape threads.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self.tokens_total = 0  # guarded-by: _lock
        self.tokens_good = 0  # guarded-by: _lock
        self.requests_total = 0  # guarded-by: _lock
        self.requests_good = 0  # guarded-by: _lock

    def record(self, n_tokens: int, good: bool) -> None:
        with self._lock:
            self.requests_total += 1
            self.tokens_total += n_tokens
            if good:
                self.requests_good += 1
                self.tokens_good += n_tokens

    def ratio(self) -> float:
        with self._lock:
            return self.tokens_good / self.tokens_total if self.tokens_total else 0.0

    def totals(self) -> Tuple[int, int]:
        """Locked (tokens_total, tokens_good) — the gauge read path."""
        with self._lock:
            return self.tokens_total, self.tokens_good

    def register_gauges(self, stats: "ServingStats") -> None:
        stats.add_gauge("goodput_tokens_total", lambda: self.totals()[0])
        stats.add_gauge("goodput_tokens_good", lambda: self.totals()[1])
        stats.add_gauge("goodput_ratio", self.ratio)


class DurableStats:
    """Durable-serving counters for one generation engine
    (``serving/durable.py`` + ``runtime/wal.py``), surfaced as /v2/stats
    gauges and the ``flexflow_serving_durable_*`` Prometheus families:

      wal_appends          journal records framed into the WAL buffer
      wal_bytes            framed bytes appended (headers included)
      fsyncs               group commits that reached fsync
      replayed_streams     unfinished streams a warm restart re-admitted
      replayed_tokens      journaled tokens those streams carried back
      torn_records         torn segment tails truncated on scan (crash
                           mid-append: expected)
      rolling_restarts     completed rolling-restart cycles (the gauge
                           the JAX package's fleet drives; 0 on one GPU)
      wal_append_failures  streams degraded to non-durable by a failed
                           journal append

    The wal_* write/commit counters live inside the WriteAheadLog; set
    :attr:`wal` and the gauge read path merges them live.
    ``wal_segments`` is a level gauge over the segment directory.
    Writers: the scheduler loop thread (through the DurableJournal) and
    the warm restart; the lock keeps the replay counters exact.
    """

    FIELDS = (
        "replayed_streams", "replayed_tokens", "torn_records",
        "rolling_restarts", "wal_append_failures",
    )
    WAL_FIELDS = ("wal_appends", "wal_bytes", "fsyncs")

    def __init__(self):
        self._lock = threading.Lock()
        for f in self.FIELDS:
            setattr(self, f, 0)
        # the attached WriteAheadLog (counters() + segment_count()); None
        # until a Durability wires one in
        self.wal = None

    def incr(self, field: str, n: int = 1) -> None:
        if field not in self.FIELDS:
            raise ValueError(f"unknown durable counter {field!r}")
        with self._lock:
            setattr(self, field, getattr(self, field) + n)

    def counts(self) -> Dict[str, int]:
        """Locked snapshot merged with the live WAL write counters (the
        gauge read path: scrape threads race the loop thread)."""
        with self._lock:
            out = {f: getattr(self, f) for f in self.FIELDS}
        wal = self.wal
        wc = wal.counters() if wal is not None else {}
        out["wal_appends"] = wc.get("appends", 0)
        out["wal_bytes"] = wc.get("bytes", 0)
        out["fsyncs"] = wc.get("fsyncs", 0)
        return out

    def segments(self) -> int:
        wal = self.wal
        return wal.segment_count() if wal is not None else 0

    def register_gauges(self, stats: "ServingStats") -> None:
        # cumulative counters -> _total names (flexflow_serving_durable_*
        # once prom.py prefixes them), plus the segments on disk now
        for f in self.WAL_FIELDS + self.FIELDS:
            stats.add_gauge(f"durable_{f}_total", lambda f=f: self.counts()[f])
        stats.add_gauge("durable_wal_segments", self.segments)


class FleetStats:
    """Fleet-lifecycle counters for one replicated generation service
    (serving/fleet.py), surfaced on ``GET /v2/fleet`` and as the
    ``flexflow_serving_fleet_*`` / ``router_decisions_total`` Prometheus
    families:

      failovers        replica deaths (restart budget exhausted) whose
                       live streams were handed to the fleet for
                       cross-replica journal-replay
      migrated_streams requests journal-replayed onto a surviving (or
                       replacement) replica
      replaced         replicas retired and swapped for a fresh warmed
                       replica (drain completion, drain timeout, or
                       post-failover replacement)
      drains           replicas transitioned to DRAINING by a health
                       signal or operator call
      spawn_failures   replacement spawns that failed (engine factory or
                       warmup error; retried on the next check)
      sheds            fleet-wide sheds: requests refused because EVERY
                       eligible replica was saturated (the router's
                       per-replica spill had nowhere left to go)

    Router decisions are counted by reason ("affinity", "least_loaded",
    "only_candidate", "no_candidate", "spill", "fleet_shed"): the
    ``router_decisions_total{reason}`` counter.

    Writers: replica loop threads (failover sinks) and the fleet
    supervisor; the lock keeps increments exact.
    """

    FIELDS = (
        "failovers", "migrated_streams", "replaced", "drains",
        "spawn_failures", "sheds",
    )

    def __init__(self):
        self._lock = threading.Lock()
        for f in self.FIELDS:
            setattr(self, f, 0)
        self._decisions: Dict[str, int] = {}  # guarded-by: _lock

    def incr(self, field: str, n: int = 1) -> None:
        if field not in self.FIELDS:
            raise ValueError(f"unknown fleet counter {field!r}")
        with self._lock:
            setattr(self, field, getattr(self, field) + n)

    def note_decision(self, reason: str) -> None:
        with self._lock:
            self._decisions[reason] = self._decisions.get(reason, 0) + 1

    def decisions(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._decisions)

    def snapshot(self) -> Dict:
        with self._lock:
            out: Dict = {f: getattr(self, f) for f in self.FIELDS}
            out["router_decisions"] = dict(self._decisions)
            return out


class TokenRate:
    """Windowed tokens/s gauge for the generation engine: record token
    batches as they are emitted; ``rate()`` is tokens over the trailing
    ``window_s`` seconds of the supplied clock."""

    def __init__(self, clock: Callable[[], float], window_s: float = 10.0):
        self._clock = clock
        self._window_s = window_s
        self._lock = threading.Lock()
        self._events: deque = deque()  # (t, n_tokens); guarded-by: _lock
        self.total = 0  # guarded-by: _lock

    def record(self, n_tokens: int) -> None:
        now = self._clock()
        with self._lock:
            self.total += n_tokens
            self._events.append((now, n_tokens))
            self._trim_locked(now)

    def _trim_locked(self, now: float) -> None:
        # caller holds self._lock
        while self._events and now - self._events[0][0] > self._window_s:
            self._events.popleft()

    def rate(self) -> float:
        now = self._clock()
        with self._lock:
            self._trim_locked(now)
            if not self._events:
                return 0.0
            span = max(now - self._events[0][0], 1e-9)
            n = sum(c for _, c in self._events)
            # a single instantaneous burst has no measurable span; report
            # it over the window instead of a 1e9 spike
            return n / (span if span > 1e-6 else self._window_s)


def __getattr__(name: str):
    """``RecoveryStats`` is defined with the supervisor it counts for
    (``generation/recovery.py``, which imports this package) and resolved
    on first access here, so both import paths name the one class."""
    if name == "RecoveryStats":
        from ..generation.recovery import RecoveryStats

        return RecoveryStats
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
