#!/usr/bin/env python
"""obsreport: the observability CLI for a running (or in-process)
serving stack of the port (port of the JAX package's
``tools/obsreport.py``: given the same JSON payloads, each view prints the
JAX tool's text).

Against a live server (``flexflow_tpu_torch/serving/server.py``):

  python -m flexflow_tpu_torch.tools.obsreport --url http://host:8000
      Summary: per-model request counters, latency / queue-time / TTFT /
      TPOT percentiles, recovery counters.

  python -m flexflow_tpu_torch.tools.obsreport --url ... --request 17
      One request's postmortem: the trace waterfall (accept -> queue ->
      admit -> first token -> progress -> finish) with per-hop deltas —
      the "debug a slow request" view.

  python -m flexflow_tpu_torch.tools.obsreport --url ... --timeline-out timeline.json
      Dump the engine flight recorder as chrome://tracing JSON (open in
      chrome://tracing or https://ui.perfetto.dev).

  python -m flexflow_tpu_torch.tools.obsreport --url ... cache
      Capacity view (GET /v2/debug/cache): per-request block residency
      table, fragmentation, free-block watermarks, pressure time, and
      admission-wait blame — the "why are requests queueing?" answer.

  python -m flexflow_tpu_torch.tools.obsreport --url ... slo
      SLO view (GET /v2/slo): per-objective fast/slow burn rates and
      breach state.

  python -m flexflow_tpu_torch.tools.obsreport --url ... predict
      Cost-model truth view (GET /v2/debug/predictions): per-program
      (predicted, measured) pairs with relative-error distributions,
      and the calibration-drift alarms with blame — the "is the
      simulator lying?" answer.

  python -m flexflow_tpu_torch.tools.obsreport --url ... predict --export ledger.json
      Dump the same ledger snapshot as a flexflow-ledger-export-v1
      document (per-model entries + counters, tagged with each model's
      device kind from its metadata: ``h100`` for an engine on the card,
      ``cpu`` on the CPU) — the calibration artifact
      `flexflow_tpu_torch.sim.SimCosts.from_ledger_export` consumes. The
      loader refuses cross-device loads, the apply_recalibration rule.

  python -m flexflow_tpu_torch.tools.obsreport --url ... overload
      Overload-control view (GET /v2/overload): adaptive-limiter state,
      degrade-ladder level + transition history, the per-reason /
      per-priority shed table, and the fleet autoscale signal — the
      "why is load being refused?" answer.

  python -m flexflow_tpu_torch.tools.obsreport --url ... disagg
      Disaggregated-serving view (GET /v2/fleet): per-pool replica
      states and load, in-flight KV handoffs with deadlines, the
      transfer outcome table (ok/corrupt/error/stalled), delivered
      bytes, replay fallbacks, and handoff latency percentiles — the
      "is the prefill->decode handoff healthy?" answer.

  python -m flexflow_tpu_torch.tools.obsreport --url ... anatomy [--capture K]
      [--anatomy-out anatomy.json]
      Step-anatomy view (GET /v2/debug/anatomy): per-kind phase
      breakdown (p50/mean per schedule/admit/prefix_plan/draft/sample/
      dispatch/block/readback/bookkeep span), the device-bubble ratio
      with host/device-bound classification, and the overlap-headroom
      projection (tokens/s if host phases were hidden behind device
      work) — the "is decode host-bound, and what would overlap buy?"
      answer. --capture K arms a K-step two-lane capture (scrape again
      once the engine has stepped); --anatomy-out dumps the captured
      chrome://tracing timeline.

Self-check (no server needed):

  python -m flexflow_tpu_torch.tools.obsreport --selfcheck [--device cpu]
      Serves a tiny model in-process (on the GPU unless ``--device cpu``)
      over real HTTP, generates, and asserts the observability chain:
      TTFT/TPOT histograms are non-empty, GET /metrics parses as
      Prometheus exposition text, traces carry queue-time/TTFT/TPOT, a
      forced quarantine AND a forced engine restart each capture a
      flight-recorder snapshot containing the failing step, the error
      response embeds the postmortem, cache telemetry conserves blocks,
      a repeated prompt reuses the prefix cache, a forced new decode
      signature leaves a blame string on the program registry, the step
      anatomy reports a finite bubble ratio and a two-lane capture, the
      truth ledger holds (predicted, measured) pairs for prefill/decode/
      verify plus an executor program, a deliberately scaled calibration entry trips the
      calibration-drift alarm with the op-level blame string, and request
      journeys (a client traceparent at ingress, a forced replica
      failover, a warm restart stitched from the on-disk spool) stitch
      gap-free. Exit 1 on any miss.

  python -m flexflow_tpu_torch.tools.obsreport --url ... journey [<id>] [--slow p99]
      [--timeline-out journey.json]
      Fleet-wide request journeys (GET /v2/debug/journey[/{id}]): one
      journey's cross-replica hop table with per-hop deltas and
      handoff/failover/restart annotations (--timeline-out dumps the
      chrome://tracing lanes view), or the stitchable-id listing
      (--slow p99 narrows to tail-latency exemplar journeys).

  python -m flexflow_tpu_torch.tools.obsreport --url ... slow
      Tail-latency exemplar table (GET /v2/debug/slow): each latency
      window's worst-decile samples with their journey ids.
"""
from __future__ import annotations

import argparse
import json
import math
import shutil
import sys
import tempfile
import urllib.error
import urllib.request


def _get(url: str, timeout: float = 30.0):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.read().decode()


def _get_json(url: str, timeout: float = 30.0):
    return json.loads(_get(url, timeout))


# --------------------------------------------------------------- summaries
def _pct_line(name: str, snap: dict) -> str:
    return (
        f"    {name:<14} n={snap['count']:<6} p50={snap['p50_s'] * 1e3:8.2f}ms "
        f"p95={snap['p95_s'] * 1e3:8.2f}ms p99={snap['p99_s'] * 1e3:8.2f}ms "
        f"max={snap['max_s'] * 1e3:8.2f}ms"
    )


def summarize(base: str) -> int:
    stats = _get_json(f"{base}/v2/stats")
    for section in ("models", "generation"):
        for name, snap in sorted(stats.get(section, {}).items()):
            print(f"model {name!r} ({section}):")
            counts = {
                k: snap[k]
                for k in ("admitted", "rejected", "expired", "completed",
                          "failed", "cancelled")
                if k in snap
            }
            print("    " + "  ".join(f"{k}={v}" for k, v in counts.items()))
            if isinstance(snap.get("latency"), dict):
                print(_pct_line("latency", snap["latency"]))
            for w in ("queue_time", "ttft", "tpot"):
                if isinstance(snap.get(w), dict):
                    print(_pct_line(w, snap[w]))
            rec = {
                k: snap[k]
                for k in ("recoveries", "quarantined", "watchdog_trips",
                          "step_retries", "engine_failures", "replayed_tokens")
                if snap.get(k) is not None
            }
            if rec:
                print("    recovery: " + "  ".join(f"{k}={v}" for k, v in rec.items()))
            if section == "generation":
                # serving layout: mesh geometry + the
                # search-chosen (or pinned) tensor-parallel degree
                try:
                    meta = _get_json(f"{base}/v2/models/{name}")
                except Exception:
                    meta = {}
                ss = meta.get("serving_strategy") or {}
                if ss:
                    line = (
                        f"    serving: mesh_devices={ss.get('mesh_devices')}"
                        f"  tp_degree={ss.get('tp_degree')}"
                    )
                    search = ss.get("search") or {}
                    if search:
                        line += (
                            f"  layout={'pinned' if search.get('pinned') else 'searched'}"
                            f"  candidates="
                            f"{[c['tp_degree'] for c in search.get('candidates', [])]}"
                        )
                    chip = (meta.get("compute") or {}).get("chip")
                    if chip:
                        line += f"  chip={chip}"
                    print(line)
    return 0


def show_request(base: str, request_id: int) -> int:
    payload = _get_json(f"{base}/v2/debug/traces?id={request_id}")
    traces = payload.get("traces", [])
    if not traces:
        print(f"no trace retained for request {request_id} "
              f"(ring evicted, or never finished)", file=sys.stderr)
        return 1
    for tr in traces:
        print(f"request {tr['request_id']} model={tr['model']} "
              f"transport={tr.get('transport')} outcome={tr['outcome']}")
        for k in ("queue_time_s", "ttft_s", "tpot_s", "total_s"):
            v = tr.get(k)
            print(f"    {k:<13} {v * 1e3:9.3f}ms" if v is not None else f"    {k:<13} -")
        print(f"    prompt_len={tr['prompt_len']} n_generated={tr['n_generated']} "
              f"preemptions={tr['preemptions']} replays={tr['replays']}")
        events = tr.get("events", [])
        t0 = events[0]["t"] if events else 0.0
        prev = t0
        print("    waterfall:")
        for ev in events:
            extra = {k: v for k, v in ev.items() if k not in ("t", "event")}
            print(f"      +{(ev['t'] - t0) * 1e3:9.3f}ms (Δ{(ev['t'] - prev) * 1e3:8.3f}ms) "
                  f"{ev['event']:<12} {extra if extra else ''}")
            prev = ev["t"]
        if tr.get("error"):
            print(f"    error: {tr['error']}")
    return 0


def show_cache(base: str) -> int:
    """Block-residency table + capacity counters per model."""
    payload = _get_json(f"{base}/v2/debug/cache")
    for name, rep in sorted(payload.get("models", {}).items()):
        blocks = rep["blocks"]
        print(f"model {name!r}: blocks used={blocks['used']}/{blocks['total']} "
              f"free={blocks['free']} (low_water={blocks['low_water']} "
              f"high_water={blocks['high_water']})")
        print(f"    fragmentation={rep['fragmentation_slots']} slot(s)  "
              f"occupancy={rep['occupancy']:.2f}  queue_depth={rep['queue_depth']}")
        p = rep["pressure"]
        print(f"    pressure: under={p['under_pressure']} "
              f"time_at_pressure={p['time_at_pressure_s'] * 1e3:.1f}ms "
              f"(threshold {p['threshold']:.0%} free)")
        c = rep["counters"]
        print(f"    reclaims: preempt={c['preempt_reclaimed_blocks']} blocks "
              f"({c['preempt_reclaims']}x)  trim={c['trimmed_blocks']} blocks "
              f"({c['trims']}x)")
        print(f"    admission waits: {c['admission_waits']} "
              f"({c['admission_wait_s'] * 1e3:.1f}ms total)"
              + (f"  last: {c['last_wait_blame']}" if c.get("last_wait_blame") else ""))
        pc = rep.get("prefix_cache") or {}
        if pc.get("enabled"):
            print(f"    prefix cache: hits={pc['hits']}/{pc['lookups']} "
                  f"(ratio {pc['hit_ratio']:.2f})  "
                  f"reused={pc['tokens_reused_total']} tokens / "
                  f"{pc['blocks_reused_total']} blocks  "
                  f"cow={pc['cow_copies_total']}")
            print(f"    tiers: device={pc['resident_blocks']} block(s) "
                  f"({pc['shared_blocks']} shared)  "
                  f"host={pc['offloaded_blocks']} block(s) "
                  f"({pc['host_bytes']}B of {pc['host_budget_bytes']}B)  "
                  f"swaps in/out={pc['swaps_in_total']}/{pc['swaps_out_total']}  "
                  f"fallbacks={pc['recompute_fallbacks']}")
        rows = rep.get("residency", [])
        if rows:
            print("    residency:")
            print("      req       slot  blocks  shared  alloc_slots  live_tokens  frag")
            for r in rows:
                print(f"      {r['request_id']:<9} {r['slot']:<5} {r['blocks']:<7} "
                      f"{r.get('shared_blocks', 0):<7} "
                      f"{r['allocated_slots']:<12} {r['live_tokens']:<12} "
                      f"{r['frag_slots']}")
        else:
            print("    residency: (no running requests)")
    return 0


def show_slo(base: str) -> int:
    """Burn-rate summary per objective."""
    payload = _get_json(f"{base}/v2/slo")
    for name, rep in sorted(payload.get("models", {}).items()):
        state = "HEALTHY" if rep["healthy"] else f"BREACHING: {rep['breaching']}"
        print(f"model {name!r}: {state} ({rep['observed']} requests observed)")
        for obj in rep["objectives"]:
            thr = f" <= {obj['threshold_s']}s" if obj["threshold_s"] is not None else ""
            fast, slow = obj["fast"], obj["slow"]
            flag = "  << BREACHING" if obj["breaching"] else ""
            print(f"    {obj['name']:<16} {obj['metric']}{thr} target={obj['target']}")
            print(f"        fast {fast['window_s']:.0f}s: burn={fast['burn_rate']:.2f} "
                  f"({fast['bad']}/{fast['events']} bad)   "
                  f"slow {slow['window_s']:.0f}s: burn={slow['burn_rate']:.2f} "
                  f"({slow['bad']}/{slow['events']} bad){flag}")
    return 0


def _predict_rows(rep: dict, indent: str = "    ") -> None:
    entries = [e for e in rep.get("entries", []) if e["pairs"] > 0]
    if not entries:
        print(indent + "(no joined pairs)")
    else:
        print(indent + "key                        pairs  predicted   meas_p50    err_p50  ewma     alarm")
        for e in entries:
            pred = e["predicted_s"]
            p50 = e["measured_p50_s"]
            print(
                f"{indent}{e['key'][:26]:<26} {e['pairs']:<6} "
                f"{pred * 1e3:9.3f}ms {p50 * 1e3:9.3f}ms "
                f"{(e['rel_err_p50'] or 0):+8.0%} {(e['rel_err_ewma'] or 0):+8.0%} "
                f"{'<<' if e['alarming'] else ''}"
            )
    unpred = rep.get("unpredicted", {})
    if unpred:
        total = rep.get("counters", {}).get("unpredicted_total", sum(unpred.values()))
        print(f"{indent}unpredicted measurements: {total} across {len(unpred)} key(s)")
    for a in rep.get("alarms", []):
        print(f"{indent}DRIFT: {a['blame']}")


def show_predictions(base: str) -> int:
    """Predicted-vs-measured table + drift alarms, per model and for
    the process-wide ledger (cost model / calibration / executor)."""
    payload = _get_json(f"{base}/v2/debug/predictions")
    for name, rep in sorted(payload.get("models", {}).items()):
        c = rep["counters"]
        print(f"model {name!r}: {c['pairs_total']} pairs, "
              f"{c['drift_alarms_total']} drift alarm(s)")
        _predict_rows(rep)
    g = payload.get("global")
    if g is not None:
        c = g["counters"]
        print(f"global ledger (cost model / calibration / executor): "
              f"{c['pairs_total']} pairs, {c['drift_alarms_total']} drift alarm(s)")
        _predict_rows(g)
    return 0


LEDGER_EXPORT_SCHEMA = "flexflow-ledger-export-v1"


def export_predictions(base: str, out: str) -> int:
    """Write the ledger snapshot as a ``flexflow-ledger-export-v1``
    document: per-model entries + counters, each model tagged with the
    device kind its engine reported (metadata ``compute.chip``). This
    is the calibration artifact the fleet digital twin loads
    (``SimCosts.from_ledger_export``); the device tag is what lets the
    loader refuse cross-device loads."""
    payload = _get_json(f"{base}/v2/debug/predictions")
    models = {}
    for name, rep in sorted(payload.get("models", {}).items()):
        try:
            meta = _get_json(f"{base}/v2/models/{name}")
            device = meta.get("compute", {}).get("chip") or "unknown"
        except Exception:
            device = "unknown"
        models[name] = {
            "device_kind": device,
            "entries": rep.get("entries", []),
            "counters": rep.get("counters", {}),
        }
    doc = {
        "schema": LEDGER_EXPORT_SCHEMA,
        "exported_from": base,
        "models": models,
        "global": payload.get("global"),
    }
    with open(out, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    pairs = sum(
        m["counters"].get("pairs_total", 0) for m in models.values()
    )
    print(f"exported {len(models)} model ledger(s) ({pairs} pairs) -> {out}")
    return 0


def show_anatomy(base: str, capture=None, out: str = "") -> int:
    """Phase breakdown + bubble/headroom per generation unit."""
    url = f"{base}/v2/debug/anatomy"
    if capture:
        url += f"?capture={int(capture)}"
    payload = _get_json(url)
    for name, unit in sorted(payload.get("models", {}).items()):
        rep = unit["report"]
        if not rep.get("enabled", False):
            print(f"model {name!r}: anatomy disabled (observability off)")
            continue
        print(f"model {name!r}: {rep['steps_observed']} step(s) observed, "
              f"classification={rep['classification']}")
        if unit.get("armed") is not None:
            print(f"    armed a {unit['armed']}-step capture "
                  f"(scrape again after the engine steps)")
        bubble = rep.get("device_bubble_ratio")
        if bubble is not None:
            print(f"    device_bubble_ratio={bubble:.1%} "
                  f"(device idle while the host works, rolling window)")
        for kind, phases in sorted(rep.get("phases", {}).items()):
            print(f"    {kind}:")
            print("        phase         count     mean        p50")
            for phase, p in sorted(phases.items()):
                print(f"        {phase:<12} {p['count']:<7} "
                      f"{p['mean_s'] * 1e3:8.3f}ms {p['p50_s'] * 1e3:8.3f}ms")
        hr = rep.get("headroom", {})
        if hr.get("measured_tokens_per_s") is not None:
            print(f"    overlap headroom ({hr['steps']} hot step(s)): "
                  f"{hr['measured_tokens_per_s']:.1f} -> "
                  f"{hr['projected_tokens_per_s']:.1f} tok/s "
                  f"({hr['projected_speedup']:.2f}x) if host phases were "
                  f"hidden behind device work")
        cap = rep.get("capture", {})
        print(f"    capture: {cap.get('captured', 0)} step(s) retained, "
              f"{cap.get('remaining', 0)} armed")
    if out:
        with open(out, "w") as f:
            json.dump(payload, f, indent=2)
        print(f"wrote anatomy report + two-lane timeline(s) to {out} "
              f"— open a 'trace' block in chrome://tracing")
    return 0


def show_overload(base: str) -> int:
    """Overload-control view (GET /v2/overload): limiter state, ladder
    level + transition history, and the per-reason / per-priority shed
    table — the "why is load being refused?" answer."""
    payload = _get_json(f"{base}/v2/overload")
    for name, rep in sorted(payload.get("models", {}).items()):
        lim = rep["limiter"]
        lad = rep["ladder"]
        print(f"model {name!r}: degrade_level={lad['level']} "
              f"(max seen {lad['max_level_seen']}, "
              f"{lad['transitions_total']} transition(s))  "
              f"pressure={rep['pressure']:.2f}")
        print(f"    limiter: limit={lim['limit']:.0f} "
              f"[{lim['min_limit']:.0f}..{lim['max_limit']:.0f}] "
              f"inflight={lim['inflight']} "
              f"util={lim['utilization']:.2f} last={lim['last_decision']}")
        print(f"    counters: throttled={lim['throttled_total']} "
              f"cuts={lim['cuts_total']} raises={lim['raises_total']}  "
              f"retry_after={rep['retry_after_s']:.1f}s")
        rej = rep.get("rejections", {})
        by_r, by_p = rej.get("by_reason", {}), rej.get("by_priority", {})
        if by_r or by_p:
            print("    refused: "
                  + "  ".join(f"{k}={v}" for k, v in sorted(by_r.items()))
                  + "   by class: "
                  + "  ".join(f"{k}={v}" for k, v in sorted(by_p.items())))
        else:
            print("    refused: (none)")
        hist = lad.get("history", [])
        if hist:
            print("    ladder history:")
            for h in hist[-8:]:
                print(f"      t={h['t']:.2f}s  {h['from']} -> {h['to']} "
                      f"(pressure {h['pressure']:.2f})")
    auto = _get_json(f"{base}/v2/fleet/autoscale").get("models", {})
    for name, rep in sorted(auto.items()):
        print(f"fleet {name!r}: autoscale signal={rep['signal']:+d} "
              f"want_replicas={rep['want_replicas']} "
              f"(current {rep['current_replicas']}, "
              f"sustained {rep['sustained_s']:.1f}s, "
              f"fleet_sheds={rep.get('fleet_sheds', 0)})")
    return 0


def show_disagg(base: str) -> int:
    """Disaggregated-serving view (GET /v2/fleet): pool states + the
    KV handoff protocol counters — the "is the prefill->decode handoff
    healthy?" answer."""
    payload = _get_json(f"{base}/v2/fleet")
    shown = 0
    for name, rep in sorted(payload.get("models", {}).items()):
        if not rep.get("disaggregated"):
            continue
        shown += 1
        print(f"fleet {name!r} (disaggregated):")
        for pool in ("prefill", "decode"):
            prep = rep["pools"][pool]
            states = "  ".join(
                f"{r['id']}={r['state']}(q={r['queue_depth']} "
                f"run={r['running']})"
                for r in prep.get("replicas", [])
            )
            print(f"    {pool:<8} pending={prep.get('pending', 0)}  {states}")
        ho = rep.get("handoffs", {})
        t = ho.get("transfers", {})
        print(f"    handoffs: ok={t.get('ok', 0)} corrupt={t.get('corrupt', 0)} "
              f"error={t.get('error', 0)} stalled={t.get('stalled', 0)}  "
              f"retries={ho.get('retries_total', 0)}  "
              f"replay_fallbacks={ho.get('replay_fallbacks_total', 0)}  "
              f"bytes={ho.get('bytes_total', 0)}")
        lat = ho.get("latency") or {}
        if lat.get("count"):
            mean = lat["sum"] / lat["count"]
            print(f"    handoff latency: n={lat['count']} "
                  f"mean={mean * 1e3:.2f}ms total={lat['sum'] * 1e3:.1f}ms")
        inflight = ho.get("in_flight", [])
        if inflight:
            print("    in flight:")
            for h in inflight:
                dl = h.get("deadline_in_s")
                print(f"      handoff {h['id']} req={h['request_id']} "
                      f"from={h['source']} attempts={h['attempts']} "
                      f"age={h['age_s']:.2f}s "
                      f"deadline_in={'-' if dl is None else f'{dl:.2f}s'} "
                      f"bytes={h['bytes']}")
        else:
            print("    in flight: (none)")
    if not shown:
        print("no disaggregated fleets registered")
    return 0


def show_constrained(base: str) -> int:
    """Constrained-decoding view (GET /v2/stats + model metadata): the
    grammar-cache hit economics, how many masked rows the engine
    stepped, and the dead-end quarantine count — the "are response_format
    requests healthy and cheap?" answer."""
    stats = _get_json(f"{base}/v2/stats")
    shown = 0
    for name, snap in sorted(stats.get("generation", {}).items()):
        hits = snap.get("constrained_grammar_cache_hits_total")
        if hits is None:
            continue
        shown += 1
        misses = snap.get("constrained_grammar_cache_misses_total", 0)
        total = hits + misses
        ratio = (hits / total) if total else 0.0
        print(f"model {name!r} (constrained):")
        print(f"    grammar cache: hits={hits} misses={misses} "
              f"hit_ratio={ratio:.2f} "
              f"compile_s={snap.get('constrained_grammar_compile_seconds_total', 0.0):.3f}")
        print(f"    masked_steps={snap.get('constrained_masked_steps_total', 0)}  "
              f"dead_end_failures={snap.get('constrained_dead_end_failures_total', 0)}")
        try:
            meta = _get_json(f"{base}/v2/models/{name}")
        except Exception:
            meta = {}
        con = meta.get("constrained") or {}
        if con:
            print(f"    cache entries={con.get('grammar_cache_entries')}  "
                  f"vocabulary_tokens={con.get('vocabulary_tokens')}  "
                  f"formats={','.join(con.get('formats', []))}")
    if not shown:
        print("no generation models expose constrained counters")
    return 0


def _print_durable_report(rep: dict, indent: str = "    ") -> None:
    wm = rep.get("watermark", {})
    wal = rep.get("wal", {})
    counts = rep.get("counters", {})
    ri = rep.get("resume_index", {})
    print(f"{indent}wal: dir={rep.get('wal_dir')!r} fsync={rep.get('fsync')} "
          f"segments={rep.get('segments', 0)}")
    print(f"{indent}watermark: segment={wm.get('segment')} "
          f"bytes={wm.get('segment_bytes')} appends={wm.get('appends')} "
          f"unflushed={wm.get('unflushed')} commit_lag={wm.get('commit_lag')} "
          f"open_streams={wm.get('open_streams')}")
    print(f"{indent}writes: appends={wal.get('appends', 0)} "
          f"bytes={wal.get('bytes', 0)} fsyncs={wal.get('fsyncs', 0)} "
          f"fsync_failures={wal.get('fsync_failures', 0)} "
          f"fsync_p50={wal.get('fsync_p50_s', 0.0) * 1e3:.2f}ms "
          f"reaped_segments={wal.get('reaped_segments', 0)}")
    print(f"{indent}replay: streams={counts.get('replayed_streams', 0)} "
          f"tokens={counts.get('replayed_tokens', 0)} "
          f"torn_records={counts.get('torn_records', 0)} "
          f"rolling_restarts={counts.get('rolling_restarts', 0)}")
    print(f"{indent}degraded_streams={rep.get('degraded_streams', 0)}  "
          f"resume_index: live={ri.get('live', 0)} "
          f"terminal={ri.get('terminal', 0)}")


def show_durable(base: str) -> int:
    """Durable-serving view (GET /v2/durable): WAL watermark + write
    counters, warm-restart replay totals, degraded streams, and the
    resume index — the "would a crash right now lose anything, and did
    the last restart replay cleanly?" answer."""
    payload = _get_json(f"{base}/v2/durable")
    shown = 0
    for name, rep in sorted(payload.get("models", {}).items()):
        shown += 1
        if "replicas" in rep:  # fleet: per-replica durability
            print(f"model {name!r} (durable fleet, root={rep.get('root')!r}):")
            for rid, rrep in sorted(rep.get("replicas", {}).items()):
                print(f"  replica {rid}:")
                _print_durable_report(rrep, indent="      ")
        else:
            print(f"model {name!r} (durable):")
            _print_durable_report(rep)
    if not shown:
        print("no models have durability attached")
    return 0


# hop names that mark a journey crossing a process/replica boundary —
# the annotations the hop table calls out loudly
_JOURNEY_ANNOTATIONS = {
    "kv_handoff_pack": "<< HANDOFF (KV packed for the decode pool)",
    "kv_handoff": "<< HANDOFF (KV delivered cross-pool)",
    "kv_handoff_replay": "<< HANDOFF FALLBACK (journal replay)",
    "failover": "<< FAILOVER (replica died mid-stream)",
    "warm_restart": "<< WARM RESTART (WAL replay after process death)",
    "sse_resume": "<< RESUME (client re-attached)",
    "replay": "<< REPLAY (engine restart)",
}


def show_slow(base: str, model=None) -> int:
    """Tail-latency exemplar table (GET /v2/debug/slow): each latency
    window's worst-decile samples with the journey ids they retained —
    a bad percentile links straight to a stitchable journey."""
    url = f"{base}/v2/debug/slow"
    if model:
        url += f"?model={model}"
    payload = _get_json(url)
    shown = 0
    for label, windows in sorted(payload.get("models", {}).items()):
        print(f"model {label!r}:")
        for window, rows in sorted(windows.items()):
            print(f"    {window} worst-decile exemplars:")
            for r in rows:
                shown += 1
                print(f"        {r['seconds'] * 1e3:9.3f}ms  "
                      f"journey {r['journey_id']}")
    if not shown:
        print("no slow exemplars retained (journeys off, or no traffic)")
    return 0


def _exemplar_windows(base: str, journey_id: str) -> list:
    """Which (model, window) latency exemplars retained this journey."""
    try:
        payload = _get_json(f"{base}/v2/debug/slow")
    except Exception:
        return []
    return sorted(
        f"{label}:{window}"
        for label, windows in payload.get("models", {}).items()
        for window, rows in windows.items()
        if any(r.get("journey_id") == journey_id for r in rows)
    )


def show_journey(base: str, journey_id=None, slow=None,
                 timeline_out: str = "") -> int:
    """One journey's cross-replica hop table (or, without an id, the
    listing of stitchable journeys — ``--slow p99`` narrows to the
    tail-latency exemplars)."""
    if not journey_id:
        url = f"{base}/v2/debug/journey"
        if slow:
            url += f"?slow={slow}"
        payload = _get_json(url)
        ids = payload.get("journeys", [])
        if not ids:
            print("no journeys retained" + (" as slow exemplars" if slow else ""))
            return 1
        label = "slow-exemplar journeys" if slow else "journeys (newest first)"
        print(f"{len(ids)} {label}:")
        for jid in ids:
            print(f"    {jid}")
        print(f"inspect one: obsreport.py --url {base} journey <id>")
        return 0
    try:
        payload = _get_json(f"{base}/v2/debug/journey/{journey_id}")
    except urllib.error.HTTPError as e:
        if e.code == 404:
            print(f"unknown journey {journey_id} (spool evicted, or never "
                  f"minted)", file=sys.stderr)
            return 1
        raise
    j = payload["journey"]
    spans = j["spans"]
    verdict = "complete" if j["complete"] else (
        f"INCOMPLETE ({j['n_roots']} root(s); orphaned spans present)"
    )
    print(f"journey {j['journey_id']}: {j['n_spans']} hop(s) across "
          f"lanes {', '.join(j['lanes'])} — {verdict}")
    for w in _exemplar_windows(base, journey_id):
        print(f"    # EXEMPLAR: retained as a worst-decile {w} sample")
    t0 = spans[0]["t0"] if spans else 0.0
    prev = t0
    print("    hop table (causal order):")
    for s in spans:
        extra = {k: v for k, v in (s.get("attrs") or {}).items()}
        note = _JOURNEY_ANNOTATIONS.get(s["name"], "")
        print(f"      +{(s['t0'] - t0) * 1e3:9.3f}ms "
              f"(Δ{(s['t0'] - prev) * 1e3:8.3f}ms) "
              f"[{s['lane']:<10}] {s['name']:<16} "
              f"{extra if extra else ''}{'  ' + note if note else ''}")
        prev = s["t0"]
    if timeline_out:
        with open(timeline_out, "w") as f:
            json.dump(payload["chrome_trace"], f)
        print(f"wrote {len(payload['chrome_trace'].get('traceEvents', []))} "
              f"trace events to {timeline_out} — open in chrome://tracing")
    return 0 if j["complete"] else 1


def dump_timeline(base: str, out: str) -> int:
    payload = _get_json(f"{base}/v2/debug/timeline")
    with open(out, "w") as f:
        json.dump(payload, f)
    print(f"wrote {len(payload.get('traceEvents', []))} trace events "
          f"({len(payload.get('incidents', []))} incidents) to {out} "
          f"— open in chrome://tracing")
    return 0


# --------------------------------------------------------------- selfcheck
def selfcheck(device=None) -> int:
    """End-to-end observability proof on a tiny in-process model (on
    ``device``: the GPU by default; weights seeded)."""
    import numpy as np

    from flexflow_tpu_torch.core.tensor import TensorSpec
    from flexflow_tpu_torch.core.types import DataType, OpType
    from flexflow_tpu_torch.generation import (
        ContinuousBatchingScheduler,
        GenerationEngine,
        RecoveryPolicy,
        SamplingParams,
    )
    from flexflow_tpu_torch.models.transformer import TransformerConfig
    from flexflow_tpu_torch.obs import JourneyIndex, PredictionLedger, validate_exposition
    from flexflow_tpu_torch.ops.base import get_op_def
    from flexflow_tpu_torch.ops.linear import LinearParams
    from flexflow_tpu_torch.runtime.faults import FaultPlan, replica_kill
    from flexflow_tpu_torch.search.calibration import (
        Calibration,
        cost_key,
        detected_device_kind,
        measure_lowered_op,
        op_ledger_key,
    )
    from flexflow_tpu_torch.search.cost_model import CostModel
    from flexflow_tpu_torch.serving import GenerationModel, InferenceServer
    from flexflow_tpu_torch.serving.durable import Durability, DurabilityConfig
    from flexflow_tpu_torch.serving.fleet import Fleet
    from flexflow_tpu_torch.tools._common import seeded_params

    failures = []

    def check(cond, msg):
        if not cond:
            failures.append(msg)
            print(f"FAIL: {msg}", file=sys.stderr)

    cfg = TransformerConfig(
        num_layers=2, hidden_size=32, num_heads=4, ff_size=64,
        seq_length=64, vocab_size=50, causal=True,
    )
    eng = GenerationEngine(seeded_params(cfg), cfg,
                           max_batch_slots=3, block_size=8, device=device)
    eng.generate([[1] * 8], SamplingParams(max_new_tokens=2))  # capture the steps
    model = GenerationModel(eng, name="lm")
    srv = InferenceServer(port=0)
    srv.register_generation(model)
    srv.start()
    base = f"http://127.0.0.1:{srv.port}"

    def post(path, payload, headers=None, return_headers=False):
        req = urllib.request.Request(
            base + path, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json", **(headers or {})},
        )
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                out = r.status, json.loads(r.read()), dict(r.headers)
        except urllib.error.HTTPError as e:
            out = e.code, json.loads(e.read()), dict(e.headers)
        return out if return_headers else out[:2]

    try:
        # ------------------------------------------ healthy generations
        for prompt in ([1, 2, 3], [4, 5, 6, 7], [9, 8, 7]):
            code, resp = post("/v2/models/lm/generate",
                              {"prompt": prompt, "max_new_tokens": 8})
            check(code == 200 and len(resp["tokens"]) == 8,
                  f"generate failed: {code} {resp}")

        # ---------------------------------------------- /metrics parses
        metrics = _get(f"{base}/metrics")
        bad = validate_exposition(metrics)
        check(not bad, f"/metrics has malformed lines: {bad[:3]}")

        def hist_count(name):
            for line in metrics.splitlines():
                if line.startswith(f"flexflow_serving_{name}_seconds_count"):
                    return float(line.rsplit(" ", 1)[1])
            return 0.0

        check(hist_count("ttft") >= 3, "TTFT histogram is empty")
        check(hist_count("tpot") >= 3, "TPOT histogram is empty")
        check(hist_count("queue_time") >= 3, "queue-time histogram is empty")

        # ------------------------------------------------ trace complete
        traces = _get_json(f"{base}/v2/debug/traces")["traces"]
        check(len(traces) >= 3, f"expected >=3 traces, got {len(traces)}")
        tr = traces[0]
        for k in ("queue_time_s", "ttft_s", "tpot_s"):
            check(tr.get(k) is not None, f"trace missing {k}: {tr}")
        names = [e["event"] for e in tr["events"]]
        for needed in ("accept", "transport", "admit", "first_token", "finish"):
            check(needed in names, f"trace missing {needed} event: {names}")

        # --------------------------------------------- timeline is sane
        tl = _get_json(f"{base}/v2/debug/timeline")
        kinds = {e["name"] for e in tl["traceEvents"]}
        check("decode" in kinds and "prefill" in kinds,
              f"timeline missing step kinds: {sorted(kinds)[:10]}")

        # ------------------------------------- forced quarantine (NaN)
        # one request alone in the batch; poison its decode bias -> the
        # blame vector quarantines it and the incident snapshot must
        # hold the failing step
        plan = FaultPlan(seed=0)
        plan.on("generation.decode_step", mode="nan", nth=(0,),
                select=lambda v: np.ones_like(np.asarray(v[1]), bool))
        with plan.active():
            code, resp = post("/v2/models/lm/generate",
                              {"prompt": [3, 1, 4, 1, 5], "max_new_tokens": 8})
        check(code == 500, f"poisoned request returned {code}")
        check(resp.get("type") == "PoisonedRequestError",
              f"expected PoisonedRequestError, got {resp.get('type')}: {resp.get('error')}")
        check(resp.get("trace", {}).get("outcome") == "PoisonedRequestError",
              "error response did not embed the request trace")
        flight = resp.get("flight") or {}
        check(flight.get("kind") == "quarantine" and flight.get("records"),
              "quarantine did not capture a flight-recorder snapshot")
        check(any(r.get("kind") == "decode" for r in flight.get("records", [])),
              "quarantine snapshot does not contain the failing decode step")

        # ------------------------------------ forced restart (crash x2)
        plan = FaultPlan(seed=0)
        plan.on("generation.decode_step", mode="error",
                error=RuntimeError("injected device crash"), nth=(0, 1))
        with plan.active():
            code, resp = post("/v2/models/lm/generate",
                              {"prompt": [2, 7, 1, 8], "max_new_tokens": 8})
        check(code == 200 and len(resp.get("tokens", [])) == 8,
              f"restart did not replay the stream: {code} {resp}")
        incidents = model.flight.incident_snapshots()
        restart = [i for i in incidents if i["kind"] == "restart"]
        check(restart, f"no restart incident recorded: {[i['kind'] for i in incidents]}")
        check(any(r.get("kind") == "step_failed" for r in restart[-1]["records"]),
              "restart snapshot does not contain the failing step")
        check(model.recovery_stats.recoveries >= 1, "recovery counter not bumped")
        metrics = _get(f"{base}/metrics")
        check(not validate_exposition(metrics), "/metrics broke after chaos")

        # -------------------------- capacity: cache telemetry is honest
        cache = _get_json(f"{base}/v2/debug/cache")["models"]["lm"]
        blocks = cache["blocks"]
        # every block ever handed out is accounted as freed, reclaimed
        # by reset, or still resident
        check(blocks["allocated_total"] == blocks["freed_total"]
              + blocks["reset_reclaimed_total"] + blocks["used"],
              f"cache conservation broken: {blocks}")
        # per-request PRIVATE blocks + the radix index's resident blocks
        # == used, and host-tier bytes match its block count
        pc = cache["prefix_cache"]
        private = sum(r["blocks"] - r["shared_blocks"]
                      for r in cache["residency"])
        check(private + pc["resident_blocks"] == blocks["used"],
              f"residency+prefix does not sum to used: "
              f"{cache['residency']} {pc} vs {blocks}")
        check(pc["offloaded_blocks"] * cache["config"]["bytes_per_block"]
              == pc["host_bytes"],
              f"host-tier bytes disagree with offloaded blocks: {pc}")
        check(blocks["low_water"] < blocks["total"],
              "low-water mark never moved despite served requests")
        for series in ("cache_occupancy", "mfu", "goodput_ratio",
                       "slo_breaching_total", "prefix_cache_hit_ratio",
                       "prefix_cache_host_bytes"):
            check(f"flexflow_serving_{series}{{" in metrics,
                  f"/metrics missing {series}")

        # ---------------- prefix caching: reuse is real and byte-exact
        tpl = [5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]  # > 1 block of 8
        code, first = post("/v2/models/lm/generate",
                           {"prompt": tpl, "max_new_tokens": 6})
        check(code == 200, f"templated generate failed: {code}")
        reused_before = eng.prefix_cache.tokens_reused_total
        code, second = post("/v2/models/lm/generate",
                            {"prompt": tpl, "max_new_tokens": 6})
        check(code == 200 and second["tokens"] == first["tokens"],
              "prefix-cached repeat stream differs from first run")
        check(eng.prefix_cache.tokens_reused_total > reused_before,
              "repeat admission did not reuse cached prefix blocks")

        # -------------------- serving-strategy metadata: one GPU
        meta = _get_json(f"{base}/v2/models/lm")
        ss = meta.get("serving_strategy") or {}
        check(ss.get("tp_degree") == 1 and ss.get("mesh_devices") == 1,
              f"single-device serving_strategy block wrong: {ss}")

        # -------------------- program registry: non-empty, blame works
        progs = _get_json(f"{base}/v2/debug/programs")
        entries = progs["models"]["lm"]["programs"]
        names = {p["name"] for p in entries}
        check("decode" in names and any(n.startswith("prefill[") for n in names),
              f"program registry missing engine programs: {sorted(names)}")
        check(all(p["compile_s"] is not None for p in entries
                  if p["name"] == "decode"),
              "decode program has no capture wall time")
        # force a new decode signature (the block table one column wider,
        # every slot inactive: the step writes scratch block 0 only) and
        # require a correct, human-readable blame string on the registry
        b, mb = eng.max_batch_slots, eng.max_blocks_per_seq
        zeros = np.zeros((b,), np.int32)
        eng.decode(zeros, zeros, np.zeros((b, mb + 1), np.int32), np.zeros((b,), bool),
                   np.zeros((b,), np.float32), zeros, zeros.astype(np.uint32), zeros)
        retraces = _get_json(f"{base}/v2/debug/programs")["models"]["lm"]["retraces"]
        check(retraces, "forced new signature produced no registry record")
        blame = retraces[-1]["blame"] if retraces else ""
        check("decode retraced" in blame
              and f"tables int32[{b},{mb}] -> int32[{b},{mb + 1}]" in blame,
              f"new-signature blame string wrong: {blame!r}")

        # -------------------- step anatomy: report + forced capture
        anat = _get_json(f"{base}/v2/debug/anatomy?capture=6")
        check(anat["models"]["lm"].get("armed") == 6,
              f"anatomy capture did not arm: {anat['models']['lm'].get('armed')}")
        code, resp = post("/v2/models/lm/generate",
                          {"prompt": [2, 4, 6, 8], "max_new_tokens": 6})
        check(code == 200, f"anatomy-capture generate failed: {code}")
        anat = _get_json(f"{base}/v2/debug/anatomy")["models"]["lm"]
        rep = anat["report"]
        check(rep["steps_observed"] >= 3,
              f"anatomy observed too few steps: {rep['steps_observed']}")
        bubble = rep.get("device_bubble_ratio")
        check(bubble is not None and math.isfinite(bubble) and 0.0 <= bubble <= 1.0,
              f"device_bubble_ratio not finite in [0,1]: {bubble}")
        hr = rep.get("headroom", {})
        check(hr.get("projected_tokens_per_s") is not None
              and hr.get("projected_speedup") is not None
              and math.isfinite(hr["projected_speedup"]),
              f"overlap-headroom projection missing: {hr}")
        decode_phases = rep.get("phases", {}).get("decode", {})
        for phase in ("dispatch", "execute", "readback", "bookkeep"):
            check(decode_phases.get(phase, {}).get("count", 0) >= 1,
                  f"decode anatomy missing the {phase} phase: "
                  f"{sorted(decode_phases)}")
        check(rep["capture"]["captured"] >= 1,
              f"forced capture retained no steps: {rep['capture']}")
        lanes = {e.get("tid") for e in anat["trace"]["traceEvents"]
                 if e.get("ph") == "X"}
        check({1, 2} <= lanes,
              f"capture timeline is not two-lane (host+device): {lanes}")
        check("flexflow_serving_step_phase_seconds_bucket" in _get(f"{base}/metrics"),
              "/metrics missing the step_phase_seconds histogram")

        # ------------------------------- SLO + readiness rationale sane
        slo = _get_json(f"{base}/v2/slo")["models"]["lm"]
        check(slo["observed"] >= 3 and slo["objectives"],
              f"SLO monitor saw no requests: {slo['observed']}")
        ready = _get_json(f"{base}/v2/health/ready")
        rationale = ready.get("models", {}).get("lm", {})
        check(rationale.get("breaker") == "closed"
              and "slo_breaching" in rationale,
              f"readiness rationale incomplete: {rationale}")

        # --------------------- cost-model truth: ledger joins all paths
        # a speculative request so the verify step pairs too (its first
        # call is a capture and rightly excluded)
        for _ in range(2):
            code, resp = post("/v2/models/lm/generate",
                              {"prompt": [7, 8, 9] * 4, "max_new_tokens": 12,
                               "speculation": {"enabled": True, "k": 2}})
            check(code == 200, f"speculative generate failed: {code} {resp}")
        preds = _get_json(f"{base}/v2/debug/predictions")
        lm = preds["models"]["lm"]
        entries = {e["key"]: e for e in lm["entries"]}
        for k in ("decode", "verify"):
            check(entries.get(k, {}).get("pairs", 0) >= 1,
                  f"no (predicted, measured) pair for {k}: {sorted(entries)}")
        check(any(k.startswith("prefill[") and e["pairs"] >= 1
                  for k, e in entries.items()),
              f"no prefill pair in the ledger: {sorted(entries)}")
        check(all(e["predicted_s"] > 0 for e in entries.values()),
              "ledger entry with non-positive prediction")

        # executor program: a tiny compiled model's train window must
        # join the strategy simulator's compile-time prediction in the
        # process-wide ledger
        from flexflow_tpu_torch.config import FFConfig
        from flexflow_tpu_torch.core.types import ActiMode, LossType
        from flexflow_tpu_torch.generation import prng
        from flexflow_tpu_torch.model import FFModel
        from flexflow_tpu_torch.obs.truth import GLOBAL_LEDGER
        from flexflow_tpu_torch.runtime import SGDOptimizer

        mdl = FFModel(FFConfig(batch_size=8), device=device)
        t = mdl.create_tensor((8, 8))
        t = mdl.dense(t, 8, ActiMode.RELU)
        t = mdl.dense(t, 4)
        t = mdl.softmax(t)
        mdl.compile(optimizer=SGDOptimizer(lr=0.1),
                    loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY)
        xs = np.random.RandomState(0).randn(8, 8).astype(np.float32)
        ys = np.zeros((8,), np.int32)
        rng = prng.key(0)
        mdl.executor.train_batch_repeated([xs], ys, rng, num_steps=2)  # compile
        mdl.executor.train_batch_repeated([xs], ys, rng, num_steps=2)  # measured
        ex_key = f"{mdl.executor._prog_ns}.train_step"
        ex_entry = next((e for e in GLOBAL_LEDGER.report()["entries"]
                         if e["key"] == ex_key), None)
        check(ex_entry is not None and ex_entry["pairs"] >= 1
              and ex_entry["predicted_s"] > 0,
              f"executor program {ex_key} has no (predicted, measured) pair")

        # forced miscalibration: a calibration entry deliberately scaled
        # to 1/4 of the measured op time must trip the drift alarm with
        # op-level blame naming the calibration table
        kind = detected_device_kind()
        led = PredictionLedger()
        drift = []
        led.on_alarm = drift.append
        lp = LinearParams(out_dim=64, use_bias=True, dtype=DataType.FLOAT)
        lspecs = [TensorSpec((128, 64), DataType.FLOAT)]
        lkey = cost_key(OpType.LINEAR, lp, lspecs, 1)
        measured = measure_lowered_op(OpType.LINEAR, lp, lspecs, inner=8)
        if measured is None:
            # below the host's jitter floor: the alarm-path check still
            # runs against a nominal measured value
            measured = 1e-4
        cal = Calibration(device_kind=kind, entries={lkey: measured / 4.0})
        cal.source = "opcosts table (selfcheck: entry scaled /4)"
        cm = CostModel(calibration=cal, ledger=led)
        out_specs = get_op_def(OpType.LINEAR).infer_output_specs(lp, list(lspecs))
        cmets = cm.op_cost_metrics(OpType.LINEAR, lp, lspecs, out_specs, 1)
        check(cmets.prediction_id is not None,
              "CostMetrics not tagged with a prediction id")
        for _ in range(4):
            led.measure(op_ledger_key(kind, OpType.LINEAR, lp, lspecs, 1), measured)
        blame = drift[-1]["blame"] if drift else ""
        check(drift, "scaled calibration entry did not trip the drift alarm")
        check("LINEAR" in blame and "+300%" in blame
              and "calibration table entry" in blame
              and "opcosts table" in blame,
              f"drift blame wrong: {blame!r}")

        # -------------- journeys: ingress joins traceparent, stitches
        client_trace = "0af7651916cd43dd8448eb211c80319c"
        code, resp, hdrs = post(
            "/v2/models/lm/generate",
            {"prompt": [6, 5, 4, 3], "max_new_tokens": 6},
            headers={"traceparent": f"00-{client_trace}-b7ad6b7169203331-01"},
            return_headers=True,
        )
        check(code == 200 and resp.get("journey_id") == client_trace,
              f"ingress did not join the client traceparent: "
              f"{resp.get('journey_id')}")
        check(client_trace in (hdrs.get("traceparent") or ""),
              f"response traceparent missing the journey id: {hdrs}")
        jpayload = _get_json(f"{base}/v2/debug/journey/{client_trace}")
        j = jpayload["journey"]
        names = [s["name"] for s in j["spans"]]
        check(j["complete"] and j["n_roots"] == 1,
              f"HTTP journey did not stitch complete: {j['n_roots']} "
              f"root(s), {names}")
        for needed in ("ingress", "submit", "admit", "prefill", "finish"):
            check(needed in names, f"journey missing the {needed} hop: {names}")
        check({"http", "local"} <= set(j["lanes"]),
              f"journey lanes missing ingress or replica: {j['lanes']}")
        check(jpayload["chrome_trace"]["traceEvents"]
              and jpayload["otlp"]["resourceSpans"],
              "journey renderings empty")
        slow_tbl = _get_json(f"{base}/v2/debug/slow")["models"]
        check(any(rows for rows in slow_tbl.values()),
              "latency windows retained no journey exemplars")
        slow_ids = _get_json(f"{base}/v2/debug/journey?slow=p99")["journeys"]
        check(slow_ids, "?slow=p99 listed no exemplar journeys")
        check("flexflow_serving_journey_spans_total"
              in _get(f"{base}/metrics"),
              "/metrics missing the journey span counter")

        # ------------- journeys: forced failover stitches cross-replica
        # a two-replica fleet, r0 killed mid-flight: every migrated
        # stream's journey must stitch complete WITH the failover hop,
        # crossing lanes, span count == attempted hops
        tiny = TransformerConfig(
            num_layers=1, hidden_size=16, num_heads=2, ff_size=32,
            seq_length=64, vocab_size=40, causal=True,
        )
        tiny_params = seeded_params(tiny, 1)

        def factory():
            return GenerationEngine(tiny_params, tiny, max_batch_slots=3, block_size=8,
                                    device=device)

        fleet = Fleet(
            factory, 2,
            scheduler_kwargs={
                "recovery": RecoveryPolicy(max_restarts=1, sleep=lambda _s: None),
            },
        )
        plan = FaultPlan(seed=0)
        replica_kill(plan, "r0", every=1)
        with plan.active():
            fprompts = [[1, 2, 3], [4, 5, 6, 7], [9, 8, 7, 6], [1, 2, 3, 4]]
            fhandles = [
                fleet.submit(p, SamplingParams(max_new_tokens=8))
                for p in fprompts
            ]
            for _ in range(500):
                if all(h.done() for h in fhandles):
                    break
                fleet.step()
        check(all(h.done() for h in fhandles),
              "fleet failover leg did not finish")
        check(fleet.fleet_stats.snapshot()["failovers"] >= 1,
              "replica kill produced no failover")
        idx = JourneyIndex()
        for rec in fleet.journey_recorders():
            idx.add(rec)
        migrated = [h._request for h in fhandles
                    if h._request.journey.hops and any(
                        s.name == "failover" for rec in
                        fleet.journey_recorders() for s in
                        rec.spans(h._request.journey.journey_id))]
        check(migrated, "no journey recorded a failover hop")
        for req in migrated:
            fj = idx.get(req.journey.journey_id)
            check(fj is not None and fj["complete"],
                  f"failover journey did not stitch gap-free: "
                  f"{fj and fj['n_roots']}")
            if fj is None:
                continue
            check(fj["n_spans"] == req.journey.hops,
                  f"failover journey dropped spans: {fj['n_spans']} "
                  f"stitched vs {req.journey.hops} attempted")
            fnames = [s["name"] for s in fj["spans"]]
            check("failover" in fnames and "adopt" in fnames,
                  f"failover journey missing the handover hops: {fnames}")
            check(len(set(s["lane"] for s in fj["spans"])) >= 2,
                  f"failover journey never crossed lanes: {fnames}")
            ids = {s["span_id"] for s in fj["spans"]}
            dangling = [s for s in fj["spans"]
                        if s["parent_id"] and s["parent_id"] not in ids]
            check(not dangling, f"dangling parent links: {dangling}")

        # ---------------- durable serving: kill + warm restart replays
        # in-process "process death": journal a stream mid-decode, then
        # abandon the scheduler without ENDing it. A fresh attachment on
        # the same WAL directory must warm-restart with a NON-EMPTY
        # replay report, and the pre-crash journey spans must stitch
        # from the on-disk spool alone. The abandoned scheduler's blocks
        # leak by design; this is the last leg.
        wal_root = tempfile.mkdtemp(prefix="obsreport-durable-")
        dead_dur = dur2 = None
        try:
            # sequential: a pipelined step the dead scheduler left in
            # flight would stay its own on this shared engine
            dead = ContinuousBatchingScheduler(eng, overlap=False)
            dead_dur = Durability(dead, DurabilityConfig(wal_dir=wal_root))
            dead.submit([2, 7, 1, 8, 2, 8], SamplingParams(max_new_tokens=10))
            for _ in range(4):
                dead.step()
            sched2 = ContinuousBatchingScheduler(eng)
            dur2 = Durability(sched2, DurabilityConfig(wal_dir=wal_root))
            replay = dur2.warm_restart()
            check(replay["replayed_streams"] >= 1
                  and replay["replayed_tokens"] >= 1,
                  f"warm restart replayed nothing: {replay}")
            adopted = [e.req for e in sched2.journal.entries()]
            for _ in range(200):
                if all(r.handle.done() for r in adopted):
                    break
                if not sched2.step():
                    break
            check(adopted and all(r.handle.done() for r in adopted),
                  "adopted stream did not finish after the warm restart")
            rep = dur2.report()
            check(rep["counters"]["replayed_streams"] >= 1,
                  f"durable report did not count the replay: {rep['counters']}")
            if adopted:
                jreq = adopted[0]
                check(jreq.journey.journey_id is not None,
                      "warm-restarted stream lost its journey identity")
                jidx = JourneyIndex().add(sched2.journeys)
                jidx.add_spool(dur2.journey_spool)
                wj = jidx.get(jreq.journey.journey_id)
                check(wj is not None and wj["complete"] and wj["n_roots"] == 1,
                      f"warm-restart journey did not stitch gap-free: "
                      f"{wj and (wj['n_roots'], [s['name'] for s in wj['spans']])}")
                if wj is not None:
                    wnames = [s["name"] for s in wj["spans"]]
                    check("submit" in wnames and "adopt" in wnames
                          and "warm_restart" in wnames,
                          f"warm-restart journey missing pre-crash or bridge "
                          f"hops: {wnames}")
                    wids = {s["span_id"] for s in wj["spans"]}
                    check(not [s for s in wj["spans"]
                               if s["parent_id"] and s["parent_id"] not in wids],
                          "warm-restart journey has dangling parent links")
        finally:
            # the successor first, then the abandoned one (its WAL's
            # commit thread is joined by close)
            for d in (dur2, dead_dur):
                if d is not None:
                    d.close()
            shutil.rmtree(wal_root, ignore_errors=True)
    finally:
        srv.stop()

    if failures:
        print(f"SELFCHECK FAILED: {len(failures)} check(s)", file=sys.stderr)
        return 1
    print("OK: obsreport selfcheck — traces complete (queue/TTFT/TPOT), "
          "/metrics parses with non-empty histograms, quarantine + restart "
          "each captured a flight-recorder postmortem, cache telemetry "
          "conserves blocks, program registry populated and a forced new "
          "signature produced a correct blame string, SLO + readiness "
          "rationale live, truth ledger joined prefill/decode/verify + an "
          "executor program, a scaled calibration entry tripped the "
          "drift alarm with correct blame, the step-anatomy profiler reported a finite bubble ratio "
          "+ overlap headroom with a successful forced two-lane capture, an "
          "abandoned durable journal warm-restarted with a non-empty replay "
          "report, and request journeys joined the client traceparent, "
          "stitched gap-free through a forced failover AND a warm restart, "
          "with tail-latency exemplars linking to stitchable ids")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("command", nargs="?", default="summary",
                    choices=("summary", "cache", "slo", "predict", "anatomy",
                             "overload", "disagg", "constrained", "durable",
                             "journey", "slow"),
                    help="view: summary (default), cache (block "
                         "residency), slo (burn rates), predict "
                         "(cost-model truth: error table + drift alarms), "
                         "anatomy (step phases, device bubble, overlap "
                         "headroom), overload (limiter state, ladder "
                         "history, shed table, autoscale signal), disagg "
                         "(pool states, KV handoff outcomes + latency, "
                         "in-flight transfers), constrained (grammar-cache "
                         "economics, masked steps, dead-end quarantines), "
                         "durable (WAL watermark, replay totals, resume "
                         "index), journey [<id>] (one request's "
                         "cross-replica hop table, or the stitchable-id "
                         "listing; --slow p99 narrows to tail exemplars), "
                         "slow (tail-latency exemplar table)")
    ap.add_argument("ident", nargs="?", default=None,
                    help="with `journey`: the journey id to stitch")
    ap.add_argument("--url", default="", help="base URL of a running server")
    ap.add_argument("--request", type=int, default=None,
                    help="print one request's trace waterfall")
    ap.add_argument("--timeline-out", default="",
                    help="dump the flight recorder as chrome://tracing JSON")
    ap.add_argument("--capture", type=int, default=None,
                    help="with `anatomy`: arm a K-step detailed capture")
    ap.add_argument("--anatomy-out", default="",
                    help="with `anatomy`: dump the report + two-lane "
                         "capture timeline JSON to this file")
    ap.add_argument("--export", default="",
                    help="with `predict`: write the ledger snapshot as "
                         "a flexflow-ledger-export-v1 JSON document "
                         "(the sim cost-table calibration artifact)")
    ap.add_argument("--slow", default="",
                    help="with `journey` (no id): list only the "
                         "tail-latency exemplar journeys, e.g. --slow p99")
    ap.add_argument("--selfcheck", action="store_true",
                    help="in-process end-to-end observability check")
    ap.add_argument("--device", default=None,
                    help="with --selfcheck: the engine's device (default: the "
                         "GPU; 'cpu' for the CPU)")
    args = ap.parse_args(argv)

    if args.selfcheck:
        return selfcheck(device=args.device)
    if not args.url:
        ap.error("--url required (or --selfcheck)")
    base = args.url.rstrip("/")
    if args.request is not None:
        return show_request(base, args.request)
    if args.command == "journey":
        # --timeline-out here means the journey's chrome trace, not the
        # engine flight recorder
        return show_journey(base, journey_id=args.ident, slow=args.slow,
                            timeline_out=args.timeline_out)
    if args.command == "slow":
        return show_slow(base)
    if args.timeline_out:
        return dump_timeline(base, args.timeline_out)
    if args.command == "cache":
        return show_cache(base)
    if args.command == "slo":
        return show_slo(base)
    if args.command == "predict":
        if args.export:
            return export_predictions(base, args.export)
        return show_predictions(base)
    if args.command == "anatomy":
        return show_anatomy(base, capture=args.capture, out=args.anatomy_out)
    if args.command == "overload":
        return show_overload(base)
    if args.command == "disagg":
        return show_disagg(base)
    if args.command == "constrained":
        return show_constrained(base)
    if args.command == "durable":
        return show_durable(base)
    return summarize(base)


if __name__ == "__main__":
    raise SystemExit(main())
