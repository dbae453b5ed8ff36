"""HTTP front end of the batched models and the generation engine,
speaking the KServe/Triton v2 protocol subset (port of
``flexflow_tpu/serving/server.py``, standard library only):

  GET  /v2/health/live                     -> 200 while the process runs
  GET  /v2/health/ready                    -> 200 only when able to serve
                                              (not draining, no model's
                                              breaker open), with the
                                              per-model rationale
  GET  /v2/stats                           -> per-model serving stats
                                              (counters, latency windows,
                                              tokens/s, cache occupancy,
                                              recovery, overload, SLO,
                                              prefix-cache and constrained
                                              gauges)
  GET  /metrics                            -> Prometheus text exposition
                                              (obs/prom.py)
  GET  /v2/debug/traces[?id=N&model=M&n=K] -> recent per-request traces
  GET  /v2/debug/timeline[?model=M]        -> flight recorder as
                                              chrome://tracing JSON (+ the
                                              recent incident dumps)
  GET  /v2/debug/cache[?model=M]           -> KV-cache block telemetry
  GET  /v2/debug/programs[?model=M]        -> step-program registry
                                              (signatures, capture times,
                                              new-signature blame)
  GET  /v2/debug/predictions[?model=M]     -> predicted vs measured step
                                              times, drift alarms
  GET  /v2/debug/anatomy[?model=M&capture=K] -> step anatomy (with
                                              capture=K, arms a K-step
                                              two-lane capture)
  GET  /v2/debug/slow[?model=M]            -> worst-decile latency samples
                                              with their journey ids
  GET  /v2/debug/journey[?slow=p99&n=K]    -> known journey ids (with
                                              slow=: the exemplars' ids)
  GET  /v2/debug/journey/{id}              -> one stitched journey (HTTP
                                              lane, scheduler lane, the
                                              on-disk spool) with its
                                              chrome://tracing and OTLP
                                              renderings
  GET  /v2/durable                         -> per-model WAL, journal and
                                              warm-restart state
  GET  /v2/generate/resume/{id}            -> SSE replay of a durable
                                              stream from its journaled
                                              tokens, following it live
                                              to its end (Last-Event-ID
                                              skips what the client holds)
  GET  /v2/slo                             -> SLO objectives and burn rates
  GET  /v2/overload[?model=M]              -> overload controller state
  GET  /v2/fleet                           -> per fleet: replica states,
                                              residency, router decisions,
                                              lifecycle events, handoffs
  GET  /v2/fleet/autoscale                 -> per fleet: the want-more /
                                              want-fewer replica signal
  GET  /v2/models                          -> served model names
  GET  /v2/models/{name}                   -> model metadata
  GET  /v2/models/{name}/ready             -> per-model readiness
  POST /v2/models/{name}/infer             -> batched inference (KServe v2
                                              JSON tensors) through the
                                              model's dynamic batcher
  POST /v2/models/{name}/generate          -> generation: one JSON body, or
                                              an SSE token stream with
                                              "stream": true
  POST /v2/repository/index                -> the repository's models and
                                              their state (READY /
                                              UNAVAILABLE)
  POST /v2/repository/models/{name}/load   -> load from the repository and
                                              serve
  POST /v2/repository/models/{name}/unload -> stop serving and drop

A fleet (``serving/fleet.py``) registers like a GenerationModel: each of
its replicas is one unit of the per-engine reports, labeled
``name/replica`` (``?model=name`` matches them all, ``?model=name/r0``
one), and one ``(model, replica)`` entry of ``/metrics``.

A request's deadline rides ``{"parameters": {"timeout_ms": N}}`` or the
``X-Request-Timeout-Ms`` header; its priority class the generate body's
``"priority"``, the infer body's ``{"parameters": {"priority": ...}}``,
or the ``X-Request-Priority`` header. Typed rejections map
to statuses by :func:`~flexflow_tpu_torch.serving.resilience.http_status`
(queue full / limiter / circuit open / draining -> 503, expired deadline
-> 504); overload rejections add ``Retry-After`` and a structured body
(``reason``, ``priority``, ``retry_after_s``). A failed generation embeds
its RequestTrace and, for quarantines and restarts, the flight-recorder
snapshot riding the error. A W3C ``traceparent`` header on a generate
request joins its journey to the client's trace; the response carries
the journey's ``traceparent`` (and ``journey_id`` in the body), and with
durability on an SSE response names its stream in ``X-Durable-Id``.

Not ported yet: ``/v2/fleet*`` and the gRPC front end.
"""
from __future__ import annotations

import json
import math
import threading
from concurrent.futures import TimeoutError as _FuturesTimeout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from ..obs import (
    GLOBAL_LEDGER,
    JourneyIndex,
    JourneyRecorder,
    journey_to_chrome_trace,
    journey_to_otlp,
    parse_traceparent,
    render_prometheus,
)
from ..runtime import faults
from .batcher import DynamicBatcher, make_batcher
from .generation import GenerationModel
from .model import InferenceModel
from .resilience import ResilienceError, http_status, retry_after_s

# the KServe v2 tensor datatypes and numpy's (numpy has no bfloat16: a
# BF16 request tensor arrives as float32, which holds its values)
_V2_DTYPES = {
    "FP32": np.float32, "FP64": np.float64, "FP16": np.float16, "BF16": np.float32,
    "INT32": np.int32, "INT64": np.int64, "BOOL": np.bool_,
}
_NP_TO_V2 = {
    "float32": "FP32", "float64": "FP64", "float16": "FP16",
    "bfloat16": "BF16", "int32": "INT32", "int64": "INT64", "bool": "BOOL",
}


class _HTTPServer(ThreadingHTTPServer):
    # the listen backlog: socketserver's default of 5 drops the SYNs of a
    # burst of concurrent clients past it, which the clients' kernels
    # resend only after a second
    request_queue_size = 128


def _reject_payload(e: ResilienceError) -> dict:
    """Error body for a typed rejection; OverloadedError additionally
    carries the structured reason / priority / retry_after_s fields."""
    payload = {"error": str(e), "type": type(e).__name__}
    for field in ("reason", "priority", "retry_after_s", "predicted_ttft_s"):
        v = getattr(e, field, None)
        if v is not None:
            payload[field] = v
    return payload


def _reject_headers(e: ResilienceError) -> "dict | None":
    """``Retry-After`` for overload rejections (whole seconds, >= 1, per
    RFC 9110)."""
    ra = retry_after_s(e)
    if ra is None:
        return None
    return {"Retry-After": str(max(1, int(math.ceil(ra))))}


class InferenceServer:
    """Serves InferenceModels behind dynamic batchers (``register``) and
    GenerationModels (``register_generation``) over HTTP; ``start()``
    binds ``host:port`` (port 0 picks a free one, read back from
    ``self.port``) and starts every batcher and scheduler.

    With a :class:`~flexflow_tpu_torch.serving.repository.ModelRepository`
    attached, the v2 repository lifecycle routes are live. Each model's
    batcher is built from ``batcher_kwargs`` (``breaker``/``retry`` may be
    zero-arg factories, so each model gets its own; ``clock`` is
    injectable for tests on virtual time)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8000, max_delay_s: float = 0.005,
                 repository=None, max_queue: int = 256, batcher_kwargs: Optional[dict] = None):
        self.host = host
        self.port = port
        self.models: Dict[str, InferenceModel] = {}
        self.batchers: Dict[str, DynamicBatcher] = {}
        self.generators: Dict[str, GenerationModel] = {}
        self.max_delay_s = max_delay_s
        self.repository = repository
        self._batcher_kwargs = dict(batcher_kwargs or {})
        self._batcher_kwargs.setdefault("max_delay_s", max_delay_s)
        self._batcher_kwargs.setdefault("max_queue", max_queue)
        self._draining = False
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        # the HTTP ingress span lane: contexts are minted here (or joined
        # from an inbound traceparent) only for models whose journeys are
        # on, so a journeys-off deployment stays inert
        self.journeys = JourneyRecorder(lane="http")

    def register(self, model: InferenceModel) -> None:
        """Serve an InferenceModel behind its own dynamic batcher; started
        at once if the server runs."""
        self.models[model.name] = model
        b = make_batcher(model, self._batcher_kwargs)
        self.batchers[model.name] = b
        if self._httpd is not None:
            b.start()

    def unregister(self, name: str) -> bool:
        b = self.batchers.pop(name, None)
        if b is not None:
            b.stop()
        return self.models.pop(name, None) is not None

    def register_generation(self, model: GenerationModel) -> None:
        """Serve a GenerationModel, or a fleet of them
        (:class:`~flexflow_tpu_torch.serving.fleet.Fleet`,
        :class:`~flexflow_tpu_torch.serving.fleet.DisaggregatedFleet`);
        started at once if the server runs."""
        self.generators[model.name] = model
        if self._httpd is not None:
            model.start()

    def unregister_generation(self, name: str) -> bool:
        g = self.generators.pop(name, None)
        if g is not None:
            g.stop()
        return g is not None

    # ------------------------------------------------------------- health
    def live(self) -> bool:
        return True

    def ready(self) -> bool:
        """Real readiness: serving, not draining, and no model's circuit
        breaker holding traffic."""
        if self._httpd is None or self._draining:
            return False
        # snapshots: repository load/unload mutates the dicts concurrently
        return all(b.breaker.ready() for b in list(self.batchers.values())) and all(
            g.breaker.ready() for g in list(self.generators.values()))

    def model_ready(self, name: str) -> bool:
        g = self.generators.get(name)
        if g is not None:
            return g.ready()
        b = self.batchers.get(name)
        return b is not None and b.ready()

    def readiness(self) -> Dict:
        """Readiness and, per model, its rationale: a batched model's
        breaker state; a generation model's breaker state,
        watchdog/recovery evidence, SLO burn and degrade level."""
        models: Dict[str, Dict] = {
            n: {"ready": b.ready(), "breaker": b.breaker.state}
            for n, b in list(self.batchers.items())
        }
        models.update({n: g.readiness_rationale() for n, g in list(self.generators.items())})
        return {"ready": self.ready(), "draining": self._draining, "models": models}

    def stats(self) -> Dict:
        """The /v2/stats payload: the batchers' counters, latency and
        queue depth under ``models``, the generation models' under
        ``generation``."""
        return {
            "models": {n: b.stats.snapshot() for n, b in list(self.batchers.items())},
            "generation": {n: g.stats.snapshot() for n, g in list(self.generators.items())},
        }

    # ------------------------------------------------------ observability
    def _units(self, model: Optional[str] = None):
        """(label, GenerationModel) pairs across all generators, filtered
        by ``?model=``: a fleet contributes one unit per replica, labeled
        ``name/replica``, which its plain name matches as a whole and
        ``name/rN`` alone (the per-engine debug, SLO and overload
        reports)."""
        for name, g in sorted(self.generators.items()):
            reps = getattr(g, "replicas", None)
            units = [(name, g)] if reps is None else [
                (f"{name}/{r.id}", r.model) for r in list(reps)]
            for label, unit in units:
                if model is None or label == model or label.split("/", 1)[0] == model:
                    yield label, unit

    def _metric_units(self) -> Dict:
        """The generation units of /metrics by key: a model by its name, a
        fleet's replicas one by one under ``(model, replica)`` keys, so
        every serving family renders with a ``replica`` label."""
        out: Dict = {}
        for n, g in list(self.generators.items()):
            reps = getattr(g, "replicas", None)
            if reps is None:
                out[n] = g
            else:
                out.update({(n, r.id): r.model for r in list(reps)})
        return out

    def _fleets(self) -> Dict:
        """model name -> fleet lifecycle metrics (fleet generators only):
        the ``fleets=`` input to render_prometheus."""
        return {n: g.prom_fleet() for n, g in list(self.generators.items())
                if hasattr(g, "prom_fleet")}

    def metrics_text(self) -> str:
        stats = {n: b.stats for n, b in list(self.batchers.items())}
        units = self._metric_units()
        stats.update({k: u.stats for k, u in units.items()})
        return render_prometheus(
            stats,
            fault_sites=faults.site_counters(),
            ledger=GLOBAL_LEDGER,
            fleets=self._fleets(),
            anatomy={k: u.anatomy.prom_snapshot() for k, u in units.items()
                     if u.anatomy.enabled},
        )

    def debug_traces(self, request_id: Optional[int] = None, model: Optional[str] = None,
                     n: int = 32) -> Dict:
        """Recent finished request traces, most recent first, across the
        generation schedulers and the dynamic batchers."""
        rings = [(name, unit.trace_ring) for name, unit in self._units(model)]
        rings += [(name, b.trace_ring) for name, b in sorted(self.batchers.items())
                  if model is None or name == model]
        traces = []
        for name, ring in rings:
            found = [ring.get(request_id)] if request_id is not None else ring.recent(n)
            for tr in found:
                if tr is not None:
                    d = tr.to_dict()
                    d["model"] = d["model"] or name
                    traces.append(d)
        traces.sort(key=lambda d: d.get("t_finish") or 0, reverse=True)
        return {"traces": traces[:n]}

    def debug_timeline(self, model: Optional[str] = None) -> Dict:
        """Flight recorders as chrome://tracing JSON (one pid per model),
        plus the recent incident snapshots under ``incidents``."""
        events, incidents = [], []
        for pid, (name, unit) in enumerate(self._units(model), start=1):
            events.extend(unit.flight.to_chrome_trace(pid=pid, name=name)["traceEvents"])
            incidents.extend({**inc, "model": name} for inc in unit.flight.incident_snapshots())
        return {"traceEvents": events, "displayTimeUnit": "ms", "incidents": incidents}

    def debug_cache(self, model: Optional[str] = None) -> Dict:
        return {"models": {name: unit.cache_report() for name, unit in self._units(model)}}

    def debug_programs(self, model: Optional[str] = None) -> Dict:
        return {
            "models": {
                name: {"programs": unit.programs.snapshot(),
                       "retraces": unit.programs.recent_retraces()}
                for name, unit in self._units(model)
            }
        }

    def debug_predictions(self, model: Optional[str] = None) -> Dict:
        """Per model, the engine ledger's predicted/measured pairs, error
        distributions and drift alarms; plus the process-wide ledger."""
        out: Dict = {"models": {name: unit.ledger.report() for name, unit in self._units(model)}}
        if model is None:
            out["global"] = GLOBAL_LEDGER.report()
        return out

    def debug_anatomy(self, model: Optional[str] = None, capture: Optional[int] = None) -> Dict:
        """Step anatomy per model; ``capture=K`` first arms a K-step
        capture (the timeline fills as the engine steps: scrape again)."""
        out: Dict = {"models": {}}
        for name, unit in self._units(model):
            an = unit.anatomy
            armed = an.arm_capture(capture) if capture else None
            payload = {"report": an.report(), "trace": an.to_chrome_trace(name=name)}
            if armed is not None:
                payload["armed"] = armed
            out["models"][name] = payload
        return out

    def fleet_report(self) -> Dict:
        """GET /v2/fleet: per fleet, the replica states, residency,
        router score inputs and decisions, and recent lifecycle events
        (a disaggregated fleet: both pools and the handoffs)."""
        return {"models": {name: g.report() for name, g in sorted(self.generators.items())
                           if hasattr(g, "replicas")}}

    def autoscale_report(self) -> Dict:
        """GET /v2/fleet/autoscale: per fleet, the want-more / want-fewer
        replica signal from sustained limiter state."""
        return {"models": {name: g.autoscale_report()
                           for name, g in sorted(self.generators.items())
                           if hasattr(g, "autoscale_report")}}

    def durable_report(self) -> Dict:
        """GET /v2/durable: per-model WAL, journal and warm-restart state
        (commit watermark, counters, degraded streams, resume-index
        sizes); a fleet's, per replica."""
        out: Dict = {"models": {}}
        for name, g in sorted(self.generators.items()):
            dur = getattr(g, "durable", None)
            if dur is not None:
                out["models"][name] = dur.report()
            elif hasattr(g, "durable_report"):
                rep = g.durable_report()
                if rep is not None:
                    out["models"][name] = rep
        return out

    def durable_lookup(self, durable_id: str):
        """The model and resume state owning a durable stream id, across
        plain models and fleets: ``(model_name, ("live", Request) |
        ("done", dict))``, or None."""
        for name, g in sorted(self.generators.items()):
            dur = getattr(g, "durable", None)
            hit = None
            if dur is not None:
                hit = dur.lookup(durable_id)
            elif hasattr(g, "durable_lookup"):
                hit = g.durable_lookup(durable_id)
            if hit is not None:
                return name, hit
        return None

    def journey_index(self) -> JourneyIndex:
        """A fresh stitcher over the CURRENT topology: the HTTP ingress
        lane, every model's recorder (a fleet's router and replica lanes,
        retiring and torn-down replicas included) and every on-disk
        spool, built per query so replica churn never leaves it stale."""
        idx = JourneyIndex().add(self.journeys)
        for g in list(self.generators.values()):
            for rec in g.journey_recorders():
                idx.add(rec)
            for spool in g.journey_spools():
                idx.add_spool(spool)
        return idx

    def debug_journey(self, journey_id: str) -> Optional[Dict]:
        """GET /v2/debug/journey/{id}: the stitched causal timeline (spans
        in parent-chain order with the connectivity verdict) and its
        chrome://tracing and OTLP renderings; None for an unknown id."""
        journey = self.journey_index().get(journey_id)
        if journey is None:
            return None
        return {
            "journey": journey,
            "chrome_trace": journey_to_chrome_trace(journey),
            "otlp": journey_to_otlp(journey),
        }

    def debug_journeys(self, slow: Optional[str] = None, n: int = 32) -> Dict:
        """GET /v2/debug/journey[?slow=p99]: known journey ids, newest
        first; with ``slow=``, only the ids the latency windows kept as
        worst-decile exemplars."""
        if slow:
            rows = self.debug_slow()
            ids: list = []
            for windows in rows["models"].values():
                for entries in windows.values():
                    for e in entries:
                        if e["journey_id"] not in ids:
                            ids.append(e["journey_id"])
            return {"journeys": ids[:n], "slow": rows["models"]}
        return {"journeys": self.journey_index().journey_ids()[:n]}

    def debug_slow(self, model: Optional[str] = None) -> Dict:
        """Per model, each latency window's worst-decile samples with
        their journey ids (the tail-latency exemplar table)."""
        out: Dict = {"models": {}}
        for name, unit in self._units(model):
            rows = unit.stats.slow_exemplars()
            if rows:
                out["models"][name] = rows
        return out

    def slo_report(self) -> Dict:
        return {"models": {name: unit.slo.snapshot() for name, unit in self._units()}}

    def overload_report(self, model: Optional[str] = None) -> Dict:
        return {"models": {name: unit.overload.report() for name, unit in self._units(model)}}

    # ------------------------------------------------------------ control
    def start(self) -> None:
        server = self

        class Handler(BaseHTTPRequestHandler):
            # TCP_NODELAY: a response is a header write and a body write,
            # an SSE stream one small write per token; with Nagle's
            # algorithm each write after the first waits for the ACK of
            # the one before, which the client delays (up to 200 ms)
            disable_nagle_algorithm = True

            def log_message(self, *a):  # quiet
                pass

            def _json(self, code: int, payload: dict, headers=None):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def _text(self, code: int, text: str, content_type: str):
                body = text.encode()
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                url = urlparse(self.path)
                path, query = url.path, parse_qs(url.query)
                model = (query.get("model") or [None])[0]

                def qint(key):
                    try:
                        return int(query[key][0])
                    except (KeyError, IndexError, ValueError):
                        return None

                if path == "/v2/health/live":
                    return self._json(200, {"live": server.live()})
                if path == "/v2/health/ready":
                    payload = server.readiness()
                    return self._json(200 if payload["ready"] else 503, payload)
                if path == "/v2/stats":
                    return self._json(200, server.stats())
                if path == "/metrics":
                    try:
                        text = server.metrics_text()
                    except Exception as e:  # a scrape must fail loudly, not 200-empty
                        return self._json(500, {"error": str(e)})
                    return self._text(200, text, "text/plain; version=0.0.4; charset=utf-8")
                if path == "/v2/debug/traces":
                    return self._json(200, server.debug_traces(
                        request_id=qint("id"), model=model, n=qint("n") or 32))
                if path == "/v2/debug/timeline":
                    return self._json(200, server.debug_timeline(model=model))
                if path == "/v2/debug/cache":
                    return self._json(200, server.debug_cache(model=model))
                if path == "/v2/debug/programs":
                    return self._json(200, server.debug_programs(model=model))
                if path == "/v2/debug/predictions":
                    return self._json(200, server.debug_predictions(model=model))
                if path == "/v2/debug/anatomy":
                    return self._json(200, server.debug_anatomy(
                        model=model, capture=qint("capture")))
                if path == "/v2/debug/slow":
                    return self._json(200, server.debug_slow(model=model))
                if path.startswith("/v2/debug/journey/"):
                    jid = path[len("/v2/debug/journey/"):]
                    payload = server.debug_journey(jid)
                    if payload is None:
                        return self._json(404, {"error": f"unknown journey {jid}"})
                    return self._json(200, payload)
                if path == "/v2/debug/journey":
                    return self._json(200, server.debug_journeys(
                        slow=(query.get("slow") or [None])[0], n=qint("n") or 32))
                if path == "/v2/durable":
                    return self._json(200, server.durable_report())
                if path.startswith("/v2/generate/resume/"):
                    return self._resume(path[len("/v2/generate/resume/"):], query)
                if path == "/v2/slo":
                    return self._json(200, server.slo_report())
                if path == "/v2/overload":
                    return self._json(200, server.overload_report(model=model))
                if path == "/v2/fleet":
                    return self._json(200, server.fleet_report())
                if path == "/v2/fleet/autoscale":
                    return self._json(200, server.autoscale_report())
                if path == "/v2/models":
                    return self._json(200, {"models": sorted(set(server.models)
                                                             | set(server.generators))})
                if path.startswith("/v2/models/"):
                    parts = path.split("/")
                    name = parts[3]
                    g = server.generators.get(name)
                    m = server.models.get(name) or g
                    if m is None:
                        return self._json(404, {"error": f"unknown model {name}"})
                    if len(parts) == 5 and parts[4] == "ready":
                        ok = server.model_ready(name)
                        payload = {"name": name, "ready": ok}
                        if g is not None:
                            payload["rationale"] = g.readiness_rationale()
                        return self._json(200 if ok else 503, payload)
                    return self._json(200, m.metadata())
                return self._json(404, {"error": "not found"})

            def _repository(self, parts):
                """POST /v2/repository/index and
                /v2/repository/models/{name}/{load,unload}."""
                repo = server.repository
                if repo is None:
                    return self._json(400, {"error": "no model repository configured"})
                if len(parts) == 4 and parts[3] == "index":
                    return self._json(200, [
                        {"name": n, "state": "READY" if n in server.models else "UNAVAILABLE"}
                        for n in sorted(set(repo.available()) | set(server.models))
                    ])
                if len(parts) == 6 and parts[3] == "models" and parts[5] in ("load", "unload"):
                    name = parts[4]
                    if parts[5] == "load":
                        try:
                            server.register(repo.load(name))
                        except KeyError as e:
                            return self._json(404, {"error": str(e)})
                        except Exception as e:
                            return self._json(500, {"error": str(e)})
                        return self._json(200, {"name": name, "state": "READY"})
                    if not server.unregister(name):
                        return self._json(404, {"error": f"model {name} not loaded"})
                    return self._json(200, {"name": name, "state": "UNAVAILABLE"})
                return self._json(404, {"error": "not found"})

            def _infer(self, name: str):
                """POST /v2/models/{name}/infer — body: {"inputs": [{"name",
                "shape", "datatype", "data"}], "parameters": {"timeout_ms",
                "priority"}}. Parsing and validation errors -> 400;
                backpressure, breaker and drain -> 503; an expired deadline
                -> 504; a stopped batcher or a failed inference -> 500."""
                batcher = server.batchers.get(name)
                model = server.models.get(name)
                if batcher is None or model is None:
                    return self._json(404, {"error": f"unknown model {name}"})
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(length))
                    params = req.get("parameters") or {}
                    timeout_ms = params.get("timeout_ms", self.headers.get("X-Request-Timeout-Ms"))
                    deadline_s = None if timeout_ms is None else float(timeout_ms) / 1000.0
                    by_name = {t["name"]: t for t in req["inputs"]}
                    arrays = []
                    for meta in model.inputs:
                        t = by_name.get(meta.name)
                        if t is None:
                            raise ValueError(f"missing input {meta.name}")
                        dt = _V2_DTYPES.get(t.get("datatype", "FP32"), np.float32)
                        arrays.append(np.asarray(t["data"], dtype=dt).reshape(t["shape"]))
                    priority = params.get("priority", self.headers.get("X-Request-Priority"))
                    fut = batcher.submit(arrays, deadline_s=deadline_s, transport="http",
                                         priority=priority)
                except ResilienceError as e:  # backpressure / deadline / breaker / drain
                    return self._json(http_status(e), _reject_payload(e),
                                      headers=_reject_headers(e))
                except RuntimeError as e:  # batcher stopped: server-side
                    return self._json(500, {"error": str(e)})
                except Exception as e:
                    return self._json(400, {"error": str(e)})
                try:
                    # a request-supplied deadline owns the wait; 60 s is
                    # only the default for budget-less requests
                    outs = fut.result(timeout=deadline_s if deadline_s is not None else 60.0)
                except ResilienceError as e:
                    return self._json(http_status(e), _reject_payload(e),
                                      headers=_reject_headers(e))
                except (TimeoutError, _FuturesTimeout):
                    # cancel so the abandoned request never occupies space
                    # in a later device batch
                    fut.cancel()
                    return self._json(504, {"error": "inference timed out"})
                except Exception as e:
                    return self._json(500, {"error": str(e)})
                return self._json(200, {
                    "model_name": name,
                    "outputs": [
                        {
                            "name": meta.name,
                            "shape": list(o.shape),
                            # a bfloat16 output comes back widened to float32
                            "datatype": _NP_TO_V2.get(
                                meta.dtype if meta.dtype == "bfloat16" else str(o.dtype), "FP32"),
                            "data": np.asarray(
                                o, dtype=np.float64 if o.dtype.kind == "f" else o.dtype
                            ).reshape(-1).tolist(),
                        }
                        for meta, o in zip(model.outputs, outs)
                    ],
                })

            def _generate(self, name: str):
                """POST /v2/models/{name}/generate — body: {"prompt": [ids],
                "max_new_tokens", "temperature", "top_k", "eos_id", "seed",
                "stream", "priority", "parameters": {"timeout_ms"},
                "speculation": {"enabled", "k", "method", "max_ngram",
                "min_ngram", "adaptive"}, "response_format": {"type":
                "json_schema"|"regex", ...}}. A malformed body or grammar is
                THIS request's 400, never the batch's. Non-streaming: one
                JSON object. "stream": true: SSE — one ``data:`` event per
                token (``id:`` = its index), then a final done event. A
                ``traceparent`` header joins the request's journey to the
                client's trace."""
                gen = server.generators.get(name)
                if gen is None:
                    return self._json(404, {"error": f"unknown generation model {name}"})
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(length))
                    prompt = [int(t) for t in req["prompt"]]
                    sampling = gen.sampling_from(req)
                    stream = bool(req.get("stream", False))
                    timeout_ms = (req.get("parameters") or {}).get(
                        "timeout_ms", self.headers.get("X-Request-Timeout-Ms")
                    )
                    deadline_s = None if timeout_ms is None else float(timeout_ms) / 1000.0
                    speculation = gen.speculation_from(req)
                    # priority class: body field first, then the header
                    priority = req.get("priority", self.headers.get("X-Request-Priority"))
                    response_format = gen.response_format_from(req)
                    # journey ingress: mint (or join the client's W3C
                    # traceparent) only when the model records journeys
                    journey = None
                    if gen.journeys is not None:
                        journey = server.journeys.mint(
                            parent=parse_traceparent(self.headers.get("traceparent")))
                        journey.hop("ingress", transport="http", model=name, stream=stream,
                                    prompt_len=len(prompt))
                    handle = gen.submit(
                        prompt, sampling, deadline_s=deadline_s, speculation=speculation,
                        transport="http", priority=priority, response_format=response_format,
                        journey=journey,
                    )
                except ResilienceError as e:
                    return self._json(http_status(e), _reject_payload(e),
                                      headers=_reject_headers(e))
                except Exception as e:
                    return self._json(400, {"error": str(e)})

                def error_payload(e):
                    """A failed generation ships its postmortem: the
                    request's trace and (quarantine / engine failure) the
                    flight-recorder snapshot riding the exception."""
                    payload = _reject_payload(e)
                    tr = handle.trace_dict()
                    if tr:
                        payload["trace"] = tr
                    flight = getattr(e, "flight_snapshot", None)
                    if flight:
                        payload["flight"] = flight
                    return payload

                wait = deadline_s if deadline_s is not None else 300.0
                if not stream:
                    try:
                        tokens = handle.result(timeout=wait)
                    except ResilienceError as e:
                        return self._json(http_status(e), error_payload(e),
                                          headers=_reject_headers(e))
                    except (TimeoutError, _FuturesTimeout):
                        handle.cancel()
                        return self._json(504, {"error": "generation timed out"})
                    except Exception as e:
                        return self._json(500, error_payload(e))
                    body = {"model_name": name, "tokens": tokens,
                            "num_generated": len(tokens)}
                    if journey is None:
                        return self._json(200, body)
                    body["journey_id"] = journey.journey_id
                    return self._json(200, body,
                                      headers={"traceparent": journey.traceparent()})
                # SSE: status and headers are committed once the first
                # token flushes, so a mid-stream failure is an error event.
                # With durability on, X-Durable-Id names the stream for
                # GET /v2/generate/resume/{id}, whose event ids continue
                # these (the token index)
                durable_id = handle._request.durable_id
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                if durable_id is not None:
                    self.send_header("X-Durable-Id", durable_id)
                if journey is not None:
                    self.send_header("traceparent", journey.traceparent())
                self.end_headers()

                def event(payload: dict, eid=None):
                    head = "" if eid is None else f"id: {eid}\n"
                    self.wfile.write(f"{head}data: {json.dumps(payload)}\n\n".encode())

                count = 0
                try:
                    for tok in handle.tokens(timeout=wait):
                        event({"token": int(tok), "index": count}, eid=count)
                        count += 1
                    done = {"done": True, "tokens": handle.result(timeout=wait)}
                    if durable_id is not None:
                        done["durable_id"] = durable_id
                    if journey is not None:
                        done["journey_id"] = journey.journey_id
                    event(done)
                except Exception as e:
                    handle.cancel()
                    try:
                        event({**error_payload(e), "done": True})
                    except OSError:
                        pass  # client went away mid-stream

            def _resume(self, durable_id: str, query):
                """GET /v2/generate/resume/{durable_id}: SSE replay and
                re-attach. The journaled tokens replay from the resume
                index (event ids continue the original stream's); a live
                stream is then followed to its end. ``Last-Event-ID``
                (header) or ``?last_event_id=`` skips the events the
                client holds."""
                last = self.headers.get("Last-Event-ID")
                if last is None:
                    last = (query.get("last_event_id") or [None])[0]
                try:
                    sent = int(last) + 1 if last is not None else 0
                except ValueError:
                    return self._json(400, {"error": f"bad Last-Event-ID {last!r}"})
                found = server.durable_lookup(durable_id)
                if found is None:
                    return self._json(404, {"error": f"unknown durable stream {durable_id}"})
                name, (state, obj) = found
                # a resumed live stream keeps its journey (the WAL snapshot
                # restored it across a restart): the hop joins that chain
                journey_id = None
                if state == "live" and obj.journey.journey_id is not None:
                    journey_id = obj.journey.journey_id
                    obj.journey.hop("sse_resume", durable_id=durable_id,
                                    last_event_id=last, from_index=sent)
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.send_header("X-Durable-Id", durable_id)
                if journey_id is not None:
                    self.send_header("traceparent", obj.journey.traceparent())
                self.end_headers()

                def event(payload: dict, eid=None):
                    head = "" if eid is None else f"id: {eid}\n"
                    self.wfile.write(f"{head}data: {json.dumps(payload)}\n\n".encode())

                def drain(tokens):
                    nonlocal sent
                    while sent < len(tokens):
                        event({"token": int(tokens[sent]), "index": sent, "model_name": name},
                              eid=sent)
                        sent += 1

                try:
                    if state == "done":
                        tokens = obj["tokens"]
                        drain(tokens)
                        event({"done": True, "tokens": list(tokens), "outcome": obj["outcome"],
                               "durable_id": durable_id})
                        return
                    # live: poll the request's generated list (the handle's
                    # token queue belongs to the original connection). The
                    # scheduler only appends; a prefix read is safe
                    req = obj
                    handle = req.handle
                    # ~300 s ceiling: each poll waits up to 50 ms on the
                    # settle future
                    for _ in range(6000):
                        drain(req.generated)
                        if handle.done():
                            break
                        try:
                            handle.future.exception(timeout=0.05)
                        except _FuturesTimeout:
                            pass
                        except Exception:
                            break  # settled (cancelled counts); drain below
                    drain(req.generated)
                    if not handle.done():
                        event({"done": True, "error": "resume timed out",
                               "durable_id": durable_id})
                        return
                    try:
                        tokens = handle.result(timeout=0)
                        event({"done": True, "tokens": tokens, "outcome": "completed",
                               "durable_id": durable_id})
                    except Exception as e:
                        event({**_reject_payload(e), "done": True,
                               "outcome": type(e).__name__, "durable_id": durable_id})
                except OSError:
                    pass  # client went away mid-replay

            def do_POST(self):
                parts = self.path.split("/")
                if len(parts) >= 3 and parts[1] == "v2" and parts[2] == "repository":
                    return self._repository(parts)
                if len(parts) == 5 and parts[1] == "v2" and parts[2] == "models":
                    if parts[4] == "generate":
                        return self._generate(parts[3])
                    if parts[4] == "infer":
                        return self._infer(parts[3])
                return self._json(404, {"error": "not found"})

        self._httpd = _HTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]  # resolve port 0
        for b in self.batchers.values():
            b.start()
        for g in self.generators.values():
            g.start()
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()

    def stop(self, drain: bool = True) -> None:
        """Graceful by default: readiness flips to 503 first, queued and
        running requests finish, then the listener closes.
        ``drain=False`` fails queued work typed."""
        self._draining = True
        try:
            for b in self.batchers.values():
                b.stop(drain=drain)
            for g in self.generators.values():
                g.stop(drain=drain)
            if self._httpd:
                self._httpd.shutdown()
                self._httpd.server_close()
                self._httpd = None
            if self._thread:
                self._thread.join(timeout=5)
                self._thread = None
        finally:
            self._draining = False

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
