"""Prometheus text exposition (format 0.0.4) for the serving stats.

(Port of ``flexflow_tpu/obs/prom.py``, which imports nothing of JAX:
the same code, kept as the port's own copy, with the same families and
labels, pinned by ``tests/data/prometheus_golden.txt``. The fleet and
KV-handoff families render only when a caller passes ``fleets=``, as the
server does for its fleets.)

Renders every :class:`~flexflow_tpu_torch.serving.stats.ServingStats`
counter, gauge, latency window, and histogram under STABLE metric
names, so standard monitoring can scrape ``GET /metrics`` instead of
parsing the ad-hoc ``/v2/stats`` JSON. The name scheme (the golden
test in tests/test_observability.py pins the full rendering, so a
rename breaks CI instead of dashboards):

  flexflow_serving_requests_total{model,outcome}      counter — one
      family for all admission/terminal counters (admitted, rejected,
      expired, completed, failed, cancelled, drafter_errors, ...)
  flexflow_serving_request_latency_seconds{model}     summary — the
      end-to-end latency window (rolling-window quantiles + cumulative
      _sum/_count)
  flexflow_serving_<window>_seconds{model}            histogram — one
      family per named observation window: queue_time, ttft, tpot
  flexflow_serving_<gauge>{model}                     gauge — one
      family per registered gauge (queue_depth, running, tokens_per_s,
      cache_occupancy, spec_*, recoveries, watchdog_trips, ...)
  flexflow_serving_step_phase_seconds{model,kind,phase} histogram —
      the step-anatomy profiler's per-(step kind, phase) duration
      distribution (obs/steptrace.py): host phases schedule / admit /
      prefix_plan / draft / sample / dispatch / block / readback /
      bookkeep plus the device execute lane
  flexflow_serving_fleet_pool_replicas{model,pool,state} gauge — a
      disaggregated fleet's replicas per pool (prefill/decode)
  flexflow_serving_handoff_*{model,...}               counter/histogram
      — the prefill->decode KV handoff protocol: transfers_total by
      outcome, bytes_total, replay_fallbacks_total, latency_seconds
  flexflow_fault_site_calls_total{site}               counter — times
      each fault-injection site was reached (active plan only)
  flexflow_fault_site_fires_total{site}               counter — times
      a rule actually fired at the site

Label values are escaped per the exposition format (backslash, quote,
newline); metric names are sanitized to ``[a-zA-Z0-9_]``. Rendering is
deterministic: models, families, and labels are sorted.
"""
from __future__ import annotations

import math
import re
from typing import Dict, Mapping, Optional

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")

_HELP = {
    "requests_total": "Request outcomes per model (cumulative).",
    "request_latency_seconds": "End-to-end request latency; quantiles over a rolling window, sum/count cumulative.",
    "queue_time_seconds": "Accept-to-admission queue wait per request.",
    "ttft_seconds": "Time to first generated token (accept to first token).",
    "tpot_seconds": "Mean time per output token after the first.",
    "queue_depth": "Requests waiting in the admission queue.",
    "running": "Requests currently occupying engine batch slots.",
    "tokens_generated": "Total generated tokens (cumulative).",
    "tokens_per_s": "Generated tokens per second over the trailing window.",
    "preemptions": "Sequences evicted for recompute under cache pressure.",
    "cache_blocks_used": "KV-cache blocks currently allocated.",
    "cache_blocks_total": "KV-cache blocks total.",
    "cache_occupancy": "Fraction of KV-cache blocks in use.",
    "recompiles": "XLA retraces beyond the first compile, all programs.",
    "device_time_s": "Cumulative wall seconds inside device step calls.",
    "cache_frag_slots": "Internal fragmentation: token slots allocated but not holding live cache entries.",
    "cache_free_low_water": "Minimum free KV-cache blocks observed.",
    "cache_free_high_water": "Maximum free KV-cache blocks observed.",
    "cache_blocks_allocated_total": "KV-cache blocks handed out (cumulative).",
    "cache_blocks_freed_total": "KV-cache blocks returned via free() (cumulative).",
    "cache_preempt_reclaimed_blocks": "Blocks reclaimed by preempt-by-recompute evictions.",
    "cache_trimmed_blocks": "Trailing blocks returned after partial speculative acceptance.",
    "cache_pressure_time_s": "Cumulative seconds spent below the free-block pressure threshold.",
    "cache_admission_waits": "Admissions that waited on cache blocks (episodes).",
    "cache_admission_wait_s": "Cumulative seconds requests sat blocked on cache blocks.",
    "mesh_devices": "Devices in the engine's serving mesh (1 = single-device).",
    "tp_degree": "Tensor-parallel degree: KV-head shards across the serving mesh.",
    "cache_shard_bytes": "KV-cache bytes resident PER SHARD (total / tp_degree; each device holds H/tp heads of every block).",
    "cache_shard_heads": "KV heads resident per shard (num_heads / tp_degree).",
    "mfu": "Serving model-FLOPs utilization: useful FLOPs / device execute seconds / chip peak (divided by the MESH's aggregate peak on multi-chip engines).",
    "achieved_tflops": "Achieved useful TFLOP/s over cumulative device step time.",
    "model_tflops_total": "Cumulative useful model TFLOPs executed by generation steps.",
    "goodput_tokens_total": "Tokens generated across all requests (goodput denominator).",
    "goodput_tokens_good": "Tokens on requests that completed within their deadline.",
    "goodput_ratio": "Deadline-goodput: in-deadline completed tokens / all tokens.",
    "slo_breaching_total": "Objectives currently burning past threshold on both windows.",
    "retraces_blamed": "Steady-state jit retraces recorded with blame by the program registry.",
    "recoveries": "Completed engine restart + journal-replay cycles.",
    "step_retries": "Failed device steps absorbed by the single step retry.",
    "replayed_tokens": "Generated tokens recomputed across recoveries.",
    "quarantined": "Poisoned requests failed alone (batch preserved).",
    "watchdog_trips": "Stalled device steps detected by the watchdog.",
    "engine_failures": "Restart budgets exhausted (engine declared dead).",
    "flexflow_fault_site_calls_total": "Times each fault-injection site was reached (active plan).",
    "flexflow_fault_site_fires_total": "Times a fault rule fired at the site (active plan).",
    "perf_prediction_pairs": "Predicted-vs-measured pairs joined in the engine's truth ledger.",
    "perf_prediction_error_p50": "Median per-program absolute relative error of step-time predictions.",
    "perf_prediction_error_max": "Worst per-program absolute relative error of step-time predictions.",
    "perf_drift_alarms": "Calibration-drift alarms raised by the engine's truth ledger.",
    "prefix_cache_hit_ratio": "Admissions that reused cached prefix blocks / all admissions.",
    "prefix_cache_blocks_reused_total": "Cached KV blocks reused by admissions instead of recomputed (cumulative).",
    "prefix_cache_tokens_reused_total": "Prompt token positions served from cached KV instead of prefill (cumulative).",
    "prefix_cache_cow_copies_total": "Copy-on-write block copies at divergent appends into shared blocks (cumulative).",
    "prefix_cache_swaps_in_total": "KV blocks swapped in from the host-RAM tier (cumulative).",
    "prefix_cache_swaps_out_total": "KV blocks offloaded to the host-RAM tier (cumulative).",
    "prefix_cache_host_bytes": "Bytes currently resident in the host-RAM KV tier.",
    "prefix_cache_resident_blocks": "Device blocks currently owned by the prefix index.",
    "prefix_cache_offloaded_blocks": "Prefix blocks currently on the host-RAM tier.",
    "flexflow_sim_prediction_error_ratio": "Signed relative error of simulator/cost-model predictions vs measured time, per key quantile.",
    "flexflow_sim_prediction_pairs_total": "Measured samples joined with a registered prediction, per key.",
    "flexflow_sim_prediction_unpredicted_total": "Measured samples that had no registered prediction (counted, not dropped).",
    "flexflow_sim_drift_alarms_total": "Calibration-drift alarms raised by the process-wide prediction ledger.",
    "step_phase_seconds": "Step-anatomy phase durations per step kind (host spans + the device execute lane).",
    "step_device_bubble_ratio": "Fraction of hot-path step wall time the device sat idle while the host worked (rolling window).",
    "step_host_bound": "Rolling-window classification: 1 host-bound, 0 device-bound (absent before enough steps).",
    "step_overlap_projected_tokens_per_s": "Amdahl projection: tokens/s if host phases were hidden behind device execution.",
    "step_overlap_projected_speedup": "Projected step-wall speedup from fully overlapping host work with device execution.",
    "step_anatomy_steps_observed": "Scheduler iterations folded into the step-anatomy aggregator.",
    "overload_limit": "AdaptiveLimiter's live AIMD concurrency limit (queued + running requests).",
    "overload_inflight": "Live requests currently counted against the adaptive concurrency limit.",
    "overload_throttled_total": "Admissions refused by the adaptive concurrency limit (cumulative).",
    "overload_limit_cuts_total": "Multiplicative-decrease events of the adaptive concurrency limit (cumulative).",
    "overload_sheds_total": "Queued requests shed for higher-priority admissions or by the degradation ladder (cumulative).",
    "overload_infeasible_total": "Requests denied because predicted TTFT already exceeded their deadline (cumulative).",
    "overload_queue_depth_interactive": "Queued interactive-priority requests.",
    "overload_queue_depth_standard": "Queued standard-priority requests.",
    "overload_queue_depth_best_effort": "Queued best-effort-priority requests.",
    "degrade_level": "Graceful-degradation ladder level (0 = normal service).",
    "degrade_transitions_total": "Degradation-ladder level transitions (cumulative).",
    "autoscale_signal": "Fleet autoscale signal: 1 want-more, -1 want-fewer, 0 steady.",
    "autoscale_want_replicas": "Replica count the fleet's sustained limiter state asks for.",
    "constrained_grammar_cache_hits_total": "response_format grammars served from the per-model compile cache (cumulative).",
    "constrained_grammar_cache_misses_total": "response_format grammars compiled from scratch (cumulative).",
    "constrained_grammar_compile_seconds_total": "Wall seconds spent compiling response_format grammars (cumulative).",
    "constrained_masked_steps_total": "Prefill/decode/verify rows stepped under a grammar mask (cumulative).",
    "constrained_dead_end_failures_total": "Constrained streams failed by a grammar dead-end or refused advance (cumulative).",
    "durable_wal_appends_total": "Journal records framed into the durable-serving write-ahead log (cumulative).",
    "durable_wal_bytes_total": "Bytes appended to the durable-serving write-ahead log, framing included (cumulative).",
    "durable_fsyncs_total": "WAL group commits that reached fsync (cumulative).",
    "durable_replayed_streams_total": "Unfinished streams re-admitted byte-exactly by a warm restart (cumulative).",
    "durable_replayed_tokens_total": "Journaled tokens carried back by warm-restarted streams (cumulative).",
    "durable_torn_records_total": "Torn WAL tails truncated on scan — expected crash-mid-append damage (cumulative).",
    "durable_rolling_restarts_total": "Completed rolling-restart cycles this replica came up through (cumulative).",
    "durable_wal_append_failures_total": "Streams degraded to non-durable by a failed journal append (cumulative).",
    "durable_wal_segments": "WAL segment files currently on disk.",
    "kv_imports": "KV handoff payloads imported into decode slots (disaggregated serving).",
    "kv_imports_rejected": "KV handoff imports rejected at unpack (stream fell back to recompute-prefill).",
    "fleet_replicas": "Current fleet replicas per lifecycle state.",
    "fleet_pool_replicas": "Disaggregated-fleet replicas per pool and lifecycle state.",
    "handoff_transfers_total": "Prefill->decode KV handoff transfers by terminal outcome (ok/corrupt/error/stalled).",
    "handoff_bytes_total": "KV bytes delivered onto decode replicas via the handoff wire (cumulative).",
    "handoff_replay_fallbacks_total": "Handoffs that fell back to decode-pool journal replay (cumulative).",
    "handoff_latency_seconds": "Prefill-done to decode-adoption latency per delivered handoff.",
    "fleet_failovers_total": "Replica deaths whose live streams were handed over for cross-replica journal-replay.",
    "fleet_migrated_streams_total": "Streams journal-replayed onto a surviving or replacement replica.",
    "fleet_replaced_total": "Replicas retired and swapped for a fresh warmed replica.",
    "router_decisions_total": "Fleet router placements by decision reason.",
    "journey_journeys_total": "Request journeys (fleet-wide traces) minted by this unit (cumulative).",
    "journey_spans_total": "Journey spans recorded across all hops (cumulative).",
    "journey_spooled_spans_total": "Journey spans mirrored to the on-disk spool next to the WAL (cumulative).",
    "journey_spool_truncated_total": "Torn journey-spool tails truncated on scan — expected crash-mid-append damage (cumulative).",
    "journey_remote_parents_total": "Journeys joined from a remote W3C traceparent rather than minted fresh (cumulative).",
}


def escape_label_value(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def sanitize_name(name: str) -> str:
    return _NAME_RE.sub("_", name)


def format_value(v) -> str:
    """Prometheus sample value: integers bare, floats via repr, and the
    spec's spellings for the non-finite values."""
    try:
        f = float(v)
    except (TypeError, ValueError):
        return "NaN"
    if math.isnan(f):
        return "NaN"
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _help_type(lines, name: str, kind: str) -> None:
    short = name[len("flexflow_serving_"):] if name.startswith("flexflow_serving_") else name
    text = _HELP.get(short, f"flexflow_tpu serving {kind} {short.replace('_', ' ')}.")
    lines.append(f"# HELP {name} {text}")
    lines.append(f"# TYPE {name} {kind}")


def _model_labels(key) -> str:
    """Label block for one stats key: a plain model name renders
    ``model="name"``; a ``(model, replica)`` tuple (a fleet replica's
    stats) additionally carries ``replica="rN"`` — so every
    ``flexflow_serving_*`` family is per-replica for fleets and
    Prometheus aggregates across the replica label."""
    if isinstance(key, tuple):
        m, rep = key
        return 'model="%s",replica="%s"' % (
            escape_label_value(m), escape_label_value(rep),
        )
    return 'model="%s"' % escape_label_value(key)


def _sort_key(key):
    if isinstance(key, tuple):
        return (key[0], key[1])
    return (key, "")


def render_prometheus(
    models: Mapping[str, "object"],
    fault_sites: Optional[Dict[str, Dict[str, int]]] = None,
    ledger=None,
    fleets: Optional[Dict[str, Dict]] = None,
    anatomy: Optional[Mapping[str, list]] = None,
) -> str:
    """Render ``{model_name: ServingStats}`` (keys may be
    ``(model, replica)`` tuples for fleet replicas — every family then
    carries a ``replica`` label), plus optional fault-site counters
    from runtime.faults.site_counters(), the process-wide prediction
    ledger's ``flexflow_sim_*`` families, per-fleet lifecycle
    families (``fleets={model: Fleet.prom_fleet()}``: replica states,
    failover/migration counters, router decisions), and the
    step-anatomy phase histograms
    (``anatomy={model: StepAnatomy.prom_snapshot()}`` ->
    ``flexflow_serving_step_phase_seconds{kind,phase}``) as exposition
    text."""
    lines: list = []
    names = sorted(models, key=_sort_key)

    # ------------------------------------------------------------ counters
    _help_type(lines, "flexflow_serving_requests_total", "counter")
    for m in names:
        counts = models[m].counters()
        for outcome in sorted(counts):
            lines.append(
                'flexflow_serving_requests_total{%s,outcome="%s"} %s'
                % (_model_labels(m), escape_label_value(outcome),
                   format_value(counts[outcome]))
            )

    # ----------------------------------------------------- latency summary
    _help_type(lines, "flexflow_serving_request_latency_seconds", "summary")
    for m in names:
        snap = models[m].latency.snapshot()
        ml = _model_labels(m)
        for q, key in (("0.5", "p50_s"), ("0.95", "p95_s"), ("0.99", "p99_s")):
            lines.append(
                'flexflow_serving_request_latency_seconds{%s,quantile="%s"} %s'
                % (ml, q, format_value(snap[key]))
            )
        # sum/count from the SAME locked snapshot, so ratio consumers
        # never see a sum that includes an observation count doesn't
        lines.append(
            'flexflow_serving_request_latency_seconds_sum{%s} %s'
            % (ml, format_value(snap["sum_s"]))
        )
        lines.append(
            'flexflow_serving_request_latency_seconds_count{%s} %s'
            % (ml, format_value(snap["count"]))
        )

    # ---------------------------------------------------------- histograms
    # one snapshot pass per model (like gauges below): re-snapshotting
    # per family would both repeat the locked copies and mix instants
    # within a single scrape
    hist_snaps = {m: models[m].histogram_snapshots() for m in names}
    hist_names = sorted({h for m in names for h in hist_snaps[m]})
    for hname in hist_names:
        family = "flexflow_serving_%s_seconds" % sanitize_name(hname)
        _help_type(lines, family, "histogram")
        for m in names:
            snap = hist_snaps[m].get(hname)
            if snap is None:
                continue
            ml = _model_labels(m)
            for le, cum in snap["buckets"]:
                lines.append(
                    '%s_bucket{%s,le="%s"} %s'
                    % (family, ml,
                       "+Inf" if math.isinf(le) else format_value(le),
                       format_value(cum))
                )
            lines.append('%s_sum{%s} %s' % (family, ml, format_value(snap["sum"])))
            lines.append('%s_count{%s} %s' % (family, ml, format_value(snap["count"])))

    # --------------------------------------------------------------- gauges
    gauge_values = {m: models[m].gauge_values() for m in names}
    gauge_names = sorted({g for m in names for g in gauge_values[m]})
    for gname in gauge_names:
        family = "flexflow_serving_%s" % sanitize_name(gname)
        _help_type(lines, family, "gauge")
        for m in names:
            v = gauge_values[m].get(gname)
            if v is None:
                continue  # unregistered here, or the gauge callable died
            lines.append(
                '%s{%s} %s'
                % (family, _model_labels(m), format_value(v))
            )

    # --------------------------------------------------- step anatomy
    if anatomy:
        family = "flexflow_serving_step_phase_seconds"
        _help_type(lines, family, "histogram")
        for m in sorted(anatomy, key=_sort_key):
            ml = _model_labels(m)
            for entry in anatomy[m]:
                labels = '%s,kind="%s",phase="%s"' % (
                    ml, escape_label_value(entry["kind"]),
                    escape_label_value(entry["phase"]),
                )
                for le, cum in entry["buckets"]:
                    lines.append(
                        '%s_bucket{%s,le="%s"} %s'
                        % (family, labels,
                           "+Inf" if math.isinf(le) else format_value(le),
                           format_value(cum))
                    )
                lines.append(
                    '%s_sum{%s} %s' % (family, labels, format_value(entry["sum"]))
                )
                lines.append(
                    '%s_count{%s} %s' % (family, labels, format_value(entry["count"]))
                )

    # ---------------------------------------------------------------- fleet
    if fleets:
        fnames = sorted(fleets)
        _help_type(lines, "flexflow_serving_fleet_replicas", "gauge")
        for f in fnames:
            fl = escape_label_value(f)
            states = fleets[f].get("states", {})
            for state in sorted(states):
                lines.append(
                    'flexflow_serving_fleet_replicas{model="%s",state="%s"} %s'
                    % (fl, escape_label_value(state), format_value(states[state]))
                )
        for short, key in (
            ("fleet_failovers_total", "failovers_total"),
            ("fleet_migrated_streams_total", "migrated_streams_total"),
            ("fleet_replaced_total", "replaced_total"),
        ):
            family = "flexflow_serving_%s" % short
            _help_type(lines, family, "counter")
            for f in fnames:
                lines.append(
                    '%s{model="%s"} %s'
                    % (family, escape_label_value(f),
                       format_value(fleets[f].get(key, 0)))
                )
        _help_type(lines, "flexflow_serving_router_decisions_total", "counter")
        for f in fnames:
            fl = escape_label_value(f)
            decisions = fleets[f].get("router_decisions", {})
            for reason in sorted(decisions):
                lines.append(
                    'flexflow_serving_router_decisions_total{model="%s",reason="%s"} %s'
                    % (fl, escape_label_value(reason),
                       format_value(decisions[reason]))
                )
        # autoscaling signal (serving/overload.py AutoscaleAdvisor):
        # want-more/want-fewer from sustained limiter saturation
        for short, key in (
            ("autoscale_signal", "signal"),
            ("autoscale_want_replicas", "want_replicas"),
        ):
            family = "flexflow_serving_%s" % short
            _help_type(lines, family, "gauge")
            for f in fnames:
                auto = fleets[f].get("autoscale")
                if auto is None:
                    continue
                lines.append(
                    '%s{model="%s"} %s'
                    % (family, escape_label_value(f),
                       format_value(auto.get(key, 0)))
                )
        # disaggregated serving (serving/fleet.py DisaggregatedFleet):
        # per-pool replica states + the KV handoff protocol families.
        # Key-gated on the pools/handoff keys so unified fleets render
        # byte-identically to before disaggregation existed.
        if any(fleets[f].get("pools") for f in fnames):
            family = "flexflow_serving_fleet_pool_replicas"
            _help_type(lines, family, "gauge")
            for f in fnames:
                pools = fleets[f].get("pools")
                if not pools:
                    continue
                fl = escape_label_value(f)
                for pool in sorted(pools):
                    states = pools[pool].get("states", {})
                    for state in sorted(states):
                        lines.append(
                            '%s{model="%s",pool="%s",state="%s"} %s'
                            % (family, fl, escape_label_value(pool),
                               escape_label_value(state),
                               format_value(states[state]))
                        )
        if any(fleets[f].get("handoff") for f in fnames):
            family = "flexflow_serving_handoff_transfers_total"
            _help_type(lines, family, "counter")
            for f in fnames:
                ho = fleets[f].get("handoff")
                if not ho:
                    continue
                fl = escape_label_value(f)
                transfers = ho.get("transfers", {})
                for outcome in sorted(transfers):
                    lines.append(
                        '%s{model="%s",outcome="%s"} %s'
                        % (family, fl, escape_label_value(outcome),
                           format_value(transfers[outcome]))
                    )
            for short, key in (
                ("handoff_bytes_total", "bytes_total"),
                ("handoff_replay_fallbacks_total", "replay_fallbacks_total"),
            ):
                family = "flexflow_serving_%s" % short
                _help_type(lines, family, "counter")
                for f in fnames:
                    ho = fleets[f].get("handoff")
                    if not ho:
                        continue
                    lines.append(
                        '%s{model="%s"} %s'
                        % (family, escape_label_value(f),
                           format_value(ho.get(key, 0)))
                    )
            family = "flexflow_serving_handoff_latency_seconds"
            _help_type(lines, family, "histogram")
            for f in fnames:
                ho = fleets[f].get("handoff")
                if not ho or ho.get("latency") is None:
                    continue
                ml = 'model="%s"' % escape_label_value(f)
                snap = ho["latency"]
                for le, cum in snap["buckets"]:
                    lines.append(
                        '%s_bucket{%s,le="%s"} %s'
                        % (family, ml,
                           "+Inf" if math.isinf(le) else format_value(le),
                           format_value(cum))
                    )
                lines.append(
                    '%s_sum{%s} %s' % (family, ml, format_value(snap["sum"]))
                )
                lines.append(
                    '%s_count{%s} %s' % (family, ml, format_value(snap["count"]))
                )

    # ---------------------------------------------------------- fault sites
    if fault_sites:
        _help_type(lines, "flexflow_fault_site_calls_total", "counter")
        for site in sorted(fault_sites):
            lines.append(
                'flexflow_fault_site_calls_total{site="%s"} %s'
                % (escape_label_value(site), format_value(fault_sites[site]["calls"]))
            )
        _help_type(lines, "flexflow_fault_site_fires_total", "counter")
        for site in sorted(fault_sites):
            lines.append(
                'flexflow_fault_site_fires_total{site="%s"} %s'
                % (escape_label_value(site), format_value(fault_sites[site]["fires"]))
            )

    # ------------------------------------------------- cost-model truth
    if ledger is not None:
        # bounded cardinality AND bounded lock hold: only keys with
        # joined pairs, capped — a search sweep can register thousands
        # of never-executed ops, and a scrape must not serialize the
        # full table against the measurement hot path
        rep = ledger.scrape_snapshot(128)
        paired = rep["entries"]
        _help_type(lines, "flexflow_sim_prediction_error_ratio", "gauge")
        for e in paired:
            kl = escape_label_value(e["key"])
            for q, field in (("0.5", "rel_err_p50"), ("0.95", "rel_err_p95")):
                if e[field] is not None:
                    lines.append(
                        'flexflow_sim_prediction_error_ratio{key="%s",quantile="%s"} %s'
                        % (kl, q, format_value(e[field]))
                    )
        _help_type(lines, "flexflow_sim_prediction_pairs_total", "counter")
        for e in paired:
            lines.append(
                'flexflow_sim_prediction_pairs_total{key="%s"} %s'
                % (escape_label_value(e["key"]), format_value(e["pairs"]))
            )
        counters = rep["counters"]
        _help_type(lines, "flexflow_sim_prediction_unpredicted_total", "counter")
        lines.append(
            "flexflow_sim_prediction_unpredicted_total %s"
            % format_value(counters["unpredicted_total"])
        )
        _help_type(lines, "flexflow_sim_drift_alarms_total", "counter")
        lines.append(
            "flexflow_sim_drift_alarms_total %s"
            % format_value(counters["drift_alarms_total"])
        )

    return "\n".join(lines) + "\n"


_SAMPLE_RE = re.compile(
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^{}]*\})? [^ ]+( [0-9]+)?$'
)


def validate_exposition(text: str) -> list:
    """Cheap structural validator for the exposition format (used by
    tools/obsreport.py --selfcheck and the golden test): every line must
    be a comment, blank, or a well-formed sample. Returns the list of
    offending lines (empty = valid)."""
    bad = []
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        if not _SAMPLE_RE.match(line):
            bad.append(line)
    return bad
