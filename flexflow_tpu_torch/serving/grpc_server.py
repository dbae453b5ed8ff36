"""gRPC inference server speaking the KServe/Triton v2 gRPC protocol
(port of ``flexflow_tpu/serving/grpc_server.py``).

Reference: the reference's serving story is a Triton backend
(triton/src/backend.cc, instance.cc): a C++ multi-instance server whose
transport IS Triton's v2 gRPC service. This module implements that
service surface over grpcio (wire-compatible messages, the KServe v2
proto compiled into ``kserve_v2_pb2.py``, a byte-for-byte copy of the
JAX package's: both load into protobuf's one default pool), sharing the
SAME InferenceModel/DynamicBatcher instances as the HTTP front end
(serving/server.py) so both transports drain one batching queue per
model.

grpcio and protobuf are optional: this module imports without them
(``flexflow_tpu_torch.serving`` imports where neither is installed),
and only ``GrpcInferenceServer(...)`` raises there. The service stubs
are hand-registered generic handlers (no grpc-tools codegen at run
time).
"""
from __future__ import annotations

import json
import threading
from concurrent import futures
from typing import Dict, Optional

import numpy as np

from ..obs import JourneyRecorder, parse_traceparent
from .batcher import DynamicBatcher, make_batcher
from .model import InferenceModel
from .resilience import ResilienceError, grpc_code, retry_after_s

try:
    from . import kserve_v2_pb2 as pb
except Exception:  # pragma: no cover - regenerate if import ever breaks
    pb = None

_SERVICE = "inference.GRPCInferenceService"

_V2_TO_NP = {
    "FP32": np.float32, "FP64": np.float64, "FP16": np.float16,
    "INT32": np.int32, "INT64": np.int64, "BOOL": np.bool_,
}
_NP_TO_V2 = {
    "float32": "FP32", "float64": "FP64", "float16": "FP16",
    "bfloat16": "BF16", "int32": "INT32", "int64": "INT64", "bool": "BOOL",
}
# which InferTensorContents field carries each v2 datatype
_CONTENTS_FIELD = {
    "FP32": "fp32_contents", "FP64": "fp64_contents",
    "INT32": "int_contents", "INT64": "int64_contents",
    "BOOL": "bool_contents",
}


def _tensor_to_array(t) -> np.ndarray:
    dt = _V2_TO_NP.get(t.datatype or "FP32", np.float32)
    field = _CONTENTS_FIELD.get(t.datatype or "FP32", "fp32_contents")
    data = list(getattr(t.contents, field))
    return np.asarray(data, dtype=dt).reshape(list(t.shape))


def _tensor_from_raw(t, buf: bytes) -> np.ndarray:
    """KServe v2 raw representation: row-major little-endian bytes in
    ModelInferRequest.raw_input_contents[i], typed/shaped by inputs[i]
    (the fast path Triton clients use — protobuf repeated-float packing
    dominates the wire cost at any real payload size). Unknown datatypes
    are REJECTED — silently reinterpreting raw bytes as FP32 would run
    inference on garbage and return it as success."""
    dt = _V2_TO_NP.get(t.datatype or "FP32")
    if dt is None:
        raise ValueError(f"unsupported raw datatype {t.datatype!r}")
    return np.frombuffer(buf, dtype=dt).reshape(list(t.shape)).copy()


def _coerce_v2(arr) -> tuple:
    """(array, v2 datatype) with the shared unknown-dtype fallback to
    FP32 — one rule for both the typed and raw response paths."""
    arr = np.asarray(arr)
    v2 = _NP_TO_V2.get(str(arr.dtype))
    if v2 is None or v2 not in _CONTENTS_FIELD:
        arr = arr.astype(np.float32)
        v2 = "FP32"
    return arr, v2


def _array_to_tensor(out, name: str, arr: np.ndarray):
    arr, v2 = _coerce_v2(arr)
    out.name = name
    out.datatype = v2
    out.shape.extend(arr.shape)
    getattr(out.contents, _CONTENTS_FIELD[v2]).extend(
        arr.reshape(-1).tolist()
    )


class GrpcInferenceServer:
    """KServe v2 gRPC front end.

    ``http_server`` (serving/server.py InferenceServer) may be passed to
    SHARE its models/batchers/repository — one batching queue per model
    across both transports. Standalone use keeps private dicts.
    """

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        max_workers: int = 16,
        max_delay_s: float = 0.005,
        http_server=None,
        repository=None,
        max_queue: int = 256,
        batcher_kwargs: Optional[dict] = None,
    ):
        if pb is None:
            raise RuntimeError(
                "kserve_v2_pb2 unavailable: the gRPC front end needs protobuf installed"
            )
        import grpc  # deferred: serving works without grpcio installed

        self._grpc = grpc
        self.host = host
        self.port = port
        self.max_workers = max_workers
        self.max_delay_s = max_delay_s
        # standalone batcher knobs, same contract as InferenceServer
        # (ignored when sharing an http_server's batchers)
        self._batcher_kwargs = dict(batcher_kwargs or {})
        self._batcher_kwargs.setdefault("max_delay_s", max_delay_s)
        self._batcher_kwargs.setdefault("max_queue", max_queue)
        self._draining = False
        self._shared = http_server
        if http_server is not None:
            self.models = http_server.models
            self.batchers = http_server.batchers
            self.generators = http_server.generators
            self.repository = repository or http_server.repository
        else:
            self.models: Dict[str, InferenceModel] = {}
            self.batchers: Dict[str, DynamicBatcher] = {}
            self.generators: Dict = {}
            self.repository = repository
        # journey ingress recorder (fleet tracing). Shared
        # deployments reuse the HTTP server's "http" lane so one
        # JourneyIndex covers both transports; standalone gets its own.
        if http_server is not None:
            self.journeys = http_server.journeys
        else:
            self.journeys = JourneyRecorder(lane="grpc")
        self._server = None
        self._started = False
        self._lock = threading.Lock()

    # ----------------------------------------------------------- lifecycle
    def register(self, model: InferenceModel):
        if self._shared is not None:
            return self._shared.register(model)
        self.models[model.name] = model
        b = make_batcher(model, self._batcher_kwargs)
        self.batchers[model.name] = b
        if self._started:
            b.start()

    def unregister(self, name: str) -> bool:
        if self._shared is not None:
            return self._shared.unregister(name)
        b = self.batchers.pop(name, None)
        if b is not None:
            b.stop()
        return self.models.pop(name, None) is not None

    def register_generation(self, model):
        """Serve a GenerationModel; its ModelStreamInfer RPC streams one
        ModelInferResponse per generated token."""
        if self._shared is not None:
            return self._shared.register_generation(model)
        self.generators[model.name] = model
        if self._started:
            model.start()

    def start(self):
        grpc = self._grpc
        handlers = {
            "ServerLive": (pb.ServerLiveRequest, self._server_live),
            "ServerReady": (pb.ServerReadyRequest, self._server_ready),
            "ModelReady": (pb.ModelReadyRequest, self._model_ready),
            "ModelMetadata": (pb.ModelMetadataRequest, self._model_metadata),
            "ModelInfer": (pb.ModelInferRequest, self._model_infer),
            "RepositoryIndex": (pb.RepositoryIndexRequest, self._repo_index),
            "RepositoryModelLoad": (pb.RepositoryModelLoadRequest, self._repo_load),
            "RepositoryModelUnload": (pb.RepositoryModelUnloadRequest, self._repo_unload),
        }

        rpc_handlers = {
            meth: grpc.unary_unary_rpc_method_handler(
                fn,
                request_deserializer=req_cls.FromString,
                response_serializer=lambda m: m.SerializeToString(),
            )
            for meth, (req_cls, fn) in handlers.items()
        }
        # per-token generation streaming: same ModelInfer messages, one
        # response per token (Triton's ModelStreamInfer shape)
        rpc_handlers["ModelStreamInfer"] = grpc.unary_stream_rpc_method_handler(
            self._model_stream_infer,
            request_deserializer=pb.ModelInferRequest.FromString,
            response_serializer=lambda m: m.SerializeToString(),
        )
        generic = grpc.method_handlers_generic_handler(_SERVICE, rpc_handlers)
        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=self.max_workers)
        )
        self._server.add_generic_rpc_handlers((generic,))
        self.port = self._server.add_insecure_port(f"{self.host}:{self.port}")
        if self._shared is None:
            for b in self.batchers.values():
                b.start()
            for g in self.generators.values():
                g.start()
        self._started = True
        self._server.start()

    def stop(self, grace: float = 2.0, drain: bool = True):
        """Graceful by default: ServerReady flips false, in-flight RPCs
        get ``grace`` seconds, and the batchers drain their queues."""
        self._draining = True
        try:
            if self._server is not None:
                self._server.stop(grace).wait()
                self._server = None
            if self._shared is None:
                for b in self.batchers.values():
                    b.stop(drain=drain)
                for g in self.generators.values():
                    g.stop(drain=drain)
        finally:
            self._draining = False
        self._started = False

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()

    # ------------------------------------------------------------- health
    def _is_ready(self) -> bool:
        """Real readiness (not a constant): started, not draining (here
        or on the shared HTTP server), and no model breaker open."""
        if not self._started or self._draining:
            return False
        if self._shared is not None and self._shared._draining:
            return False
        # snapshot: repository load/unload mutates the dict concurrently
        return all(b.breaker.ready() for b in list(self.batchers.values())) and all(
            g.breaker.ready() for g in list(self.generators.values())
        )

    def _is_model_ready(self, name: str) -> bool:
        g = self.generators.get(name)
        if g is not None:
            return g.ready()
        b = self.batchers.get(name)
        return b is not None and b.ready()

    # ------------------------------------------------------------ handlers
    def _server_live(self, request, context):
        return pb.ServerLiveResponse(live=True)

    def _server_ready(self, request, context):
        return pb.ServerReadyResponse(ready=self._is_ready())

    def _model_ready(self, request, context):
        return pb.ModelReadyResponse(ready=self._is_model_ready(request.name))

    def _abort(self, context, code, msg, err=None):
        """Abort the RPC; an overload rejection (``err`` carrying
        retry_after_s — serving/overload.py) additionally ships
        retry-info as trailing metadata (``retry-after-ms``, plus the
        structured reason/priority) so clients back off intelligently
        on RESOURCE_EXHAUSTED."""
        if err is not None:
            ra = retry_after_s(err)
            if ra is not None:
                md = [("retry-after-ms", str(int(ra * 1000)))]
                for field in ("reason", "priority"):
                    v = getattr(err, field, None)
                    if v is not None:
                        md.append((f"overload-{field}", str(v)))
                try:
                    context.set_trailing_metadata(tuple(md))
                except Exception:
                    pass  # metadata must never mask the typed status
        context.abort(code, msg)

    def _model_metadata(self, request, context):
        grpc = self._grpc
        g = self.generators.get(request.name)
        if g is not None:
            # generation servable: same discovery surface as the HTTP
            # front end's GET /v2/models/{name}
            md = g.metadata()
            resp = pb.ModelMetadataResponse(
                name=md["name"], versions=["1"], platform=md["platform"]
            )
            for io, dest in ((md["inputs"], resp.inputs), (md["outputs"], resp.outputs)):
                for meta in io:
                    t = dest.add()
                    t.name = meta["name"]
                    t.datatype = meta["datatype"]
                    t.shape.extend(meta["shape"])
            return resp
        m = self.models.get(request.name)
        if m is None:
            self._abort(context, grpc.StatusCode.NOT_FOUND, f"unknown model {request.name}")
        resp = pb.ModelMetadataResponse(
            name=m.name, versions=["1"], platform=m.metadata()["platform"]
        )
        for meta in m.inputs:
            t = resp.inputs.add()
            t.name = meta.name
            t.datatype = _NP_TO_V2.get(meta.dtype, "FP32")
            t.shape.extend(meta.shape)
        for meta in m.outputs:
            t = resp.outputs.add()
            t.name = meta.name
            t.datatype = _NP_TO_V2.get(meta.dtype, "FP32")
            t.shape.extend(meta.shape)
        return resp

    def _model_infer(self, request, context):
        grpc = self._grpc
        name = request.model_name
        model = self.models.get(name)
        batcher = self.batchers.get(name)
        if model is None or batcher is None:
            self._abort(context, grpc.StatusCode.NOT_FOUND, f"unknown model {name}")
        use_raw = bool(request.raw_input_contents)
        try:
            if use_raw:
                # raw bytes pair with inputs[] BY POSITION (KServe v2)
                if len(request.raw_input_contents) != len(request.inputs):
                    raise ValueError(
                        "raw_input_contents length must match inputs"
                    )
                by_name = {
                    t.name: _tensor_from_raw(t, raw)
                    for t, raw in zip(request.inputs, request.raw_input_contents)
                }
            else:
                by_name = {t.name: _tensor_to_array(t) for t in request.inputs}
            arrays = []
            for meta in model.inputs:
                a = by_name.get(meta.name)
                if a is None:
                    raise ValueError(f"missing input {meta.name}")
                arrays.append(a)
            # propagate the client's gRPC deadline into the batcher so a
            # request that expires while queued never reaches the device;
            # the parameters map may carry the priority class
            pp = request.parameters.get("priority") if request.parameters else None
            priority = None
            if pp is not None:
                kind = pp.WhichOneof("parameter_choice")
                priority = getattr(pp, kind) if kind else None
            remaining = context.time_remaining()
            fut = batcher.submit(
                arrays, deadline_s=remaining, transport="grpc",
                priority=priority,
            )
        except ResilienceError as e:  # backpressure/deadline/breaker/drain
            self._abort(context, grpc_code(e, grpc), str(e), err=e)
        except RuntimeError as e:  # batcher stopped
            self._abort(context, grpc.StatusCode.UNAVAILABLE, str(e))
        except Exception as e:
            self._abort(context, grpc.StatusCode.INVALID_ARGUMENT, str(e))
        try:
            # a client deadline owns the wait; 60s only for budget-less calls
            outs = fut.result(timeout=remaining if remaining is not None else 60.0)
        except ResilienceError as e:
            self._abort(context, grpc_code(e, grpc), str(e), err=e)
        except (TimeoutError, futures.TimeoutError):
            # futures.TimeoutError only aliases the builtin from 3.11 on;
            # cancel so the abandoned request never occupies device batch
            # space later
            fut.cancel()
            self._abort(context, grpc.StatusCode.DEADLINE_EXCEEDED, "inference timed out")
        except Exception as e:
            self._abort(context, grpc.StatusCode.INTERNAL, str(e))
        resp = pb.ModelInferResponse(model_name=name, id=request.id)
        for meta, o in zip(model.outputs, outs):
            if use_raw:
                # mirror the request representation (Triton convention):
                # typed/shaped outputs[], data in raw_output_contents
                arr, v2 = _coerce_v2(o)
                t = resp.outputs.add()
                t.name = meta.name
                t.datatype = v2
                t.shape.extend(arr.shape)
                resp.raw_output_contents.append(np.ascontiguousarray(arr).tobytes())
            else:
                _array_to_tensor(resp.outputs.add(), meta.name, o)
        return resp

    def _model_stream_infer(self, request, context):
        """Streaming generation: request carries the prompt as an INT32
        "tokens" input; sampling rides the parameters map
        (max_new_tokens / top_k / eos_id / seed as int64_param,
        temperature as string_param; a constrained request carries its
        ``response_format`` spec JSON-encoded as a string_param — a
        malformed grammar is INVALID_ARGUMENT for this call alone).
        Yields one response per generated token, then a final summary
        response with the full sequence."""
        grpc = self._grpc
        gen = self.generators.get(request.model_name)
        if gen is None:
            self._abort(
                context, grpc.StatusCode.NOT_FOUND,
                f"unknown generation model {request.model_name}",
            )
        try:
            by_name = {t.name: t for t in request.inputs}
            if request.raw_input_contents:
                if len(request.raw_input_contents) != len(request.inputs):
                    raise ValueError("raw_input_contents length must match inputs")
                arrays = {
                    t.name: _tensor_from_raw(t, raw)
                    for t, raw in zip(request.inputs, request.raw_input_contents)
                }
                prompt = [int(x) for x in arrays["tokens"].reshape(-1)]
            else:
                if "tokens" not in by_name:
                    raise ValueError("missing input 'tokens'")
                prompt = [int(x) for x in _tensor_to_array(by_name["tokens"]).reshape(-1)]
            params = {}
            for key, p in request.parameters.items():
                kind = p.WhichOneof("parameter_choice")
                params[key] = getattr(p, kind) if kind else None
            sampling = gen.sampling_from(params)
            rf = params.get("response_format")
            if isinstance(rf, (str, bytes)):
                rf = json.loads(rf)
            response_format = gen.response_format_from(
                {"response_format": rf} if rf is not None else {}
            )
            # journey ingress: join the client's W3C traceparent from
            # invocation metadata, or mint fresh (only when the target
            # unit records journeys — journeys-off stays inert)
            journey = None
            if getattr(gen, "journeys", None) is not None:
                tp = None
                try:
                    for k, v in context.invocation_metadata() or ():
                        if k.lower() == "traceparent":
                            tp = v
                            break
                except Exception:
                    pass  # metadata access must never fail the RPC
                journey = self.journeys.mint(parent=parse_traceparent(tp))
                journey.hop(
                    "ingress", transport="grpc",
                    model=request.model_name, prompt_len=len(prompt),
                )
            remaining = context.time_remaining()
            handle = gen.submit(
                prompt, sampling, deadline_s=remaining, transport="grpc",
                priority=params.get("priority"),
                response_format=response_format,
                journey=journey,
            )
        except ResilienceError as e:
            self._abort(context, grpc_code(e, grpc), str(e), err=e)
        except Exception as e:
            self._abort(context, grpc.StatusCode.INVALID_ARGUMENT, str(e))
        wait = remaining if remaining is not None else 300.0
        try:
            i = 0
            for tok in handle.tokens(timeout=wait):
                resp = pb.ModelInferResponse(model_name=request.model_name, id=request.id)
                t = resp.outputs.add()
                t.name = "token"
                t.datatype = "INT32"
                t.shape.extend([1])
                t.contents.int_contents.append(int(tok))
                yield resp
                i += 1
            final = pb.ModelInferResponse(model_name=request.model_name, id=request.id)
            t = final.outputs.add()
            t.name = "tokens"
            t.datatype = "INT32"
            toks = handle.result(timeout=wait)
            t.shape.extend([len(toks)])
            t.contents.int_contents.extend(int(x) for x in toks)
            # durable serving: the stream's WAL identity —
            # a disconnected client resumes byte-exactly via
            # GET /v2/generate/resume/{durable_id}
            durable_id = handle._request.durable_id
            if durable_id is not None:
                final.parameters["durable_id"].string_param = durable_id
            # journey identity rides the final response + trailing
            # metadata (the gRPC analog of the HTTP traceparent header)
            if journey is not None:
                final.parameters["journey_id"].string_param = (
                    journey.journey_id
                )
                try:
                    context.set_trailing_metadata(
                        (("traceparent", journey.traceparent()),)
                    )
                except Exception:
                    pass  # metadata must never mask the stream payload
            yield final
        except ResilienceError as e:
            handle.cancel()
            self._abort(context, grpc_code(e, grpc), str(e), err=e)
        except Exception as e:
            handle.cancel()
            self._abort(context, grpc.StatusCode.INTERNAL, str(e))

    # ---------------------------------------------------------- repository
    def _repo_index(self, request, context):
        resp = pb.RepositoryIndexResponse()
        repo = self.repository
        names = set(self.models)
        if repo is not None:
            names |= set(repo.available())
        for n in sorted(names):
            mi = resp.models.add()
            mi.name = n
            mi.version = "1"
            mi.state = "READY" if n in self.models else "UNAVAILABLE"
        return resp

    def _repo_load(self, request, context):
        grpc = self._grpc
        if self.repository is None:
            self._abort(context, grpc.StatusCode.FAILED_PRECONDITION, "no model repository configured")
        try:
            self.register(self.repository.load(request.model_name))
        except KeyError as e:
            self._abort(context, grpc.StatusCode.NOT_FOUND, str(e))
        except Exception as e:
            self._abort(context, grpc.StatusCode.INTERNAL, str(e))
        return pb.RepositoryModelLoadResponse()

    def _repo_unload(self, request, context):
        grpc = self._grpc
        if not self.unregister(request.model_name):
            self._abort(context, grpc.StatusCode.NOT_FOUND, f"model {request.model_name} not loaded")
        return pb.RepositoryModelUnloadResponse()
