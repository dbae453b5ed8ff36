"""HTTP front end of the generation engine, speaking the KServe/Triton v2
protocol subset (port of ``flexflow_tpu/serving/server.py``, standard
library only):

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
  GET  /v2/models                          -> served model names
  GET  /v2/models/{name}                   -> model metadata
  GET  /v2/models/{name}/ready             -> per-model readiness
  POST /v2/models/{name}/generate          -> generation: one JSON body, or
                                              an SSE token stream with
                                              "stream": true

A request's deadline rides ``{"parameters": {"timeout_ms": N}}`` or the
``X-Request-Timeout-Ms`` header; its priority class the body's
``"priority"`` or the ``X-Request-Priority`` header. Typed rejections map
to statuses by :func:`~flexflow_tpu_torch.serving.resilience.http_status`
(queue full / limiter / circuit open / draining -> 503, expired deadline
-> 504); overload rejections add ``Retry-After`` and a structured body
(``reason``, ``priority``, ``retry_after_s``). A failed generation embeds
its RequestTrace and, for quarantines and restarts, the flight-recorder
snapshot riding the error. A W3C ``traceparent`` header on a generate
request joins its journey to the client's trace; the response carries
the journey's ``traceparent`` (and ``journey_id`` in the body), and with
durability on an SSE response names its stream in ``X-Durable-Id``.

Not ported yet: ``/v2/models/{name}/infer`` (with ``InferenceModel``,
the dynamic batcher and the model repository), ``/v2/repository/*``,
``/v2/fleet*`` and the gRPC front end.
"""
from __future__ import annotations

import json
import math
import threading
from concurrent.futures import TimeoutError as _FuturesTimeout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional
from urllib.parse import parse_qs, urlparse

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
from .generation import GenerationModel
from .resilience import ResilienceError, http_status, retry_after_s


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
    """Serves GenerationModels over HTTP (``register_generation``);
    ``start()`` binds ``host:port`` (port 0 picks a free one, read back
    from ``self.port``) and starts every model's scheduler."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8000):
        self.host = host
        self.port = port
        self.generators: Dict[str, GenerationModel] = {}
        self._draining = False
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        # the HTTP ingress span lane: contexts are minted here (or joined
        # from an inbound traceparent) only for models whose journeys are
        # on, so a journeys-off deployment stays inert
        self.journeys = JourneyRecorder(lane="http")

    def register_generation(self, model: GenerationModel) -> None:
        """Serve a GenerationModel; started at once if the server runs."""
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
        return all(g.breaker.ready() for g in list(self.generators.values()))

    def model_ready(self, name: str) -> bool:
        g = self.generators.get(name)
        return g is not None and g.ready()

    def readiness(self) -> Dict:
        """Readiness and, per model, its rationale: breaker state,
        watchdog/recovery evidence, SLO burn and the degrade level."""
        return {
            "ready": self.ready(),
            "draining": self._draining,
            "models": {n: g.readiness_rationale() for n, g in list(self.generators.items())},
        }

    def stats(self) -> Dict:
        """The /v2/stats payload: one entry per generation model
        (``models`` holds the batched models, none in the port yet)."""
        return {
            "models": {},
            "generation": {n: g.stats.snapshot() for n, g in list(self.generators.items())},
        }

    # ------------------------------------------------------ observability
    def _units(self, model: Optional[str] = None):
        """(name, GenerationModel) pairs, filtered by ``?model=``."""
        for name, g in sorted(self.generators.items()):
            if model is None or name == model:
                yield name, g

    def metrics_text(self) -> str:
        return render_prometheus(
            {n: g.stats for n, g in list(self.generators.items())},
            fault_sites=faults.site_counters(),
            ledger=GLOBAL_LEDGER,
            anatomy={n: g.anatomy.prom_snapshot() for n, g in list(self.generators.items())
                     if g.anatomy.enabled},
        )

    def debug_traces(self, request_id: Optional[int] = None, model: Optional[str] = None,
                     n: int = 32) -> Dict:
        """Recent finished request traces, most recent first."""
        traces = []
        for name, unit in self._units(model):
            ring = unit.trace_ring
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

    def durable_report(self) -> Dict:
        """GET /v2/durable: per-model WAL, journal and warm-restart state
        (commit watermark, counters, degraded streams, resume-index
        sizes)."""
        return {"models": {name: g.durable.report() for name, g in self._units()
                           if g.durable is not None}}

    def durable_lookup(self, durable_id: str):
        """The model and resume state owning a durable stream id:
        ``(model_name, ("live", Request) | ("done", dict))``, or None."""
        for name, g in self._units():
            if g.durable is not None:
                hit = g.durable.lookup(durable_id)
                if hit is not None:
                    return name, hit
        return None

    def journey_index(self) -> JourneyIndex:
        """A fresh stitcher over the HTTP ingress lane, every model's
        recorder and every on-disk spool, built per query."""
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
                if path == "/v2/models":
                    return self._json(200, {"models": sorted(server.generators)})
                if path.startswith("/v2/models/"):
                    parts = path.split("/")
                    name = parts[3]
                    g = server.generators.get(name)
                    if g is None:
                        return self._json(404, {"error": f"unknown model {name}"})
                    if len(parts) == 5 and parts[4] == "ready":
                        ok = server.model_ready(name)
                        payload = {"name": name, "ready": ok,
                                   "rationale": g.readiness_rationale()}
                        return self._json(200 if ok else 503, payload)
                    return self._json(200, g.metadata())
                return self._json(404, {"error": "not found"})

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
                if (len(parts) == 5 and parts[1] == "v2" and parts[2] == "models"
                        and parts[4] == "generate"):
                    return self._generate(parts[3])
                return self._json(404, {"error": "not found"})

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]  # resolve port 0
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
