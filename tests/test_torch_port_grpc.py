"""The port's KServe v2 gRPC front end (``serving/grpc_server.py``)
against the JAX package's, over real gRPC on loopback.

One pair of servers: each package's ``InferenceServer`` (HTTP, never
called here) holds the same MLP (``test_torch_port_infer.py``'s: the JAX
graph and weights carried into the port), a ``GenerationModel`` over the
same tiny decoder weights (``torch_port_chaos.engine``) and a model
repository; each package's ``GrpcInferenceServer`` shares it. The same
requests go to both. Gates: equal responses (typed and raw contents;
float outputs within atol 1e-5, float32 in another summation order),
equal metadata but the platform name, equal repository indexes and
load/unload codes, stream tokens equal to the JAX stream's, the client's
``traceparent`` joined and returned, and equal health and backpressure
codes with their trailing metadata. The card's machine has neither
grpcio nor protobuf, so this is held on the CPU only.
"""
import numpy as np
import pytest

grpc = pytest.importorskip("grpc")

from conftest import FakeClock  # noqa: E402
from flexflow_tpu.serving import CircuitBreaker as JCircuitBreaker  # noqa: E402
from flexflow_tpu.serving import InferenceServer as JInferenceServer  # noqa: E402
from flexflow_tpu.serving import ModelRepository as JModelRepository  # noqa: E402
from flexflow_tpu.serving.generation import GenerationModel as JGenerationModel  # noqa: E402
from flexflow_tpu.serving.grpc_server import GrpcInferenceServer as JGrpcServer  # noqa: E402
from flexflow_tpu_torch.obs import parse_traceparent  # noqa: E402
from flexflow_tpu_torch.serving import CircuitBreaker, GenerationModel, InferenceServer  # noqa: E402
from flexflow_tpu_torch.serving import ModelRepository, resilience  # noqa: E402
from flexflow_tpu_torch.serving.grpc_server import GrpcInferenceServer, pb  # noqa: E402
from flexflow_tpu_torch.serving import kserve_v2_pb2  # noqa: E402
from test_torch_port_infer import _jax_mlp, _port_of  # noqa: E402
from torch_port_chaos import JAX, PORT, engine  # noqa: E402

pytestmark = pytest.mark.torch_port

SERVICE = "/inference.GRPCInferenceService/"


class Side:
    def __init__(self, http, grpc_srv, breaker_cls, gen):
        self.http, self.grpc, self.Breaker, self.gen = http, grpc_srv, breaker_cls, gen
        self.channel = grpc.insecure_channel(f"127.0.0.1:{grpc_srv.port}")

    def call(self, method, req, resp_cls, **kw):
        fn = self.channel.unary_unary(SERVICE + method,
                                      request_serializer=lambda m: m.SerializeToString(),
                                      response_deserializer=resp_cls.FromString)
        return fn(req, timeout=60, **kw)

    def stream(self, req, **kw):
        fn = self.channel.unary_stream(SERVICE + "ModelStreamInfer",
                                       request_serializer=lambda m: m.SerializeToString(),
                                       response_deserializer=pb.ModelInferResponse.FromString)
        return fn(req, timeout=120, **kw)

    def outcome(self, method, req, resp_cls):
        """(status code name, response or None, trailing metadata dict)."""
        try:
            return "OK", self.call(method, req, resp_cls), {}
        except grpc.RpcError as e:
            return e.code().name, None, dict(e.trailing_metadata() or ())


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    """(JAX side, port side), each an HTTP server shared by a gRPC server."""
    root = tmp_path_factory.mktemp("repo")
    jim = _jax_mlp()
    tim = _port_of(jim)
    spare = _jax_mlp(name="spare")
    for sub in ("j", "p"):
        JModelRepository(str(root / sub)).save(spare)
    jhttp = JInferenceServer(port=0, repository=JModelRepository(str(root / "j")))
    phttp = InferenceServer(port=0, repository=ModelRepository(str(root / "p"), device="cpu"))
    jgen = JGenerationModel(engine(JAX)[0], name="lm")
    pgen = GenerationModel(engine(PORT)[0], name="lm")
    for http, im, gen in ((jhttp, jim, jgen), (phttp, tim, pgen)):
        http.register(im)
        http.register_generation(gen)
        http.start()
    jg, pg = JGrpcServer(port=0, http_server=jhttp), GrpcInferenceServer(port=0, http_server=phttp)
    jg.start()
    pg.start()
    out = (Side(jhttp, jg, JCircuitBreaker, jgen), Side(phttp, pg, CircuitBreaker, pgen))
    yield out
    for s in out:
        s.channel.close()
        s.grpc.stop()
        s.http.stop()


def _infer_req(x, raw=False, name="x"):
    req = pb.ModelInferRequest(model_name="mlp", id="r1")
    t = req.inputs.add()
    t.name, t.datatype = name, "FP32"
    t.shape.extend(x.shape)
    if raw:
        req.raw_input_contents.append(np.ascontiguousarray(x).tobytes())
    else:
        t.contents.fp32_contents.extend(x.reshape(-1).tolist())
    return req


def _out(resp, raw):
    o = resp.outputs[0]
    data = (np.frombuffer(resp.raw_output_contents[0], np.float32) if raw
            else np.asarray(o.contents.fp32_contents, np.float32))
    return (o.name, o.datatype, list(o.shape)), data.reshape(list(o.shape))


def test_the_message_module_is_jaxs_copy():
    import flexflow_tpu.serving.kserve_v2_pb2 as jpb

    assert kserve_v2_pb2.DESCRIPTOR.name == "kserve_v2.proto"
    assert kserve_v2_pb2.DESCRIPTOR.package == "inference"
    assert kserve_v2_pb2.DESCRIPTOR.serialized_pb == jpb.DESCRIPTOR.serialized_pb
    # one default pool: the two modules hand out the same message classes
    assert pb.ModelInferRequest.DESCRIPTOR is jpb.ModelInferRequest.DESCRIPTOR


@pytest.mark.parametrize("raw", [False, True], ids=["typed", "raw"])
def test_infer_answers_as_jax(sides, raw):
    x = np.random.RandomState(3).randn(3, 16).astype(np.float32)
    (jmeta, jdata), (pmeta, pdata) = (
        _out(s.call("ModelInfer", _infer_req(x, raw), pb.ModelInferResponse), raw) for s in sides)
    assert pmeta == jmeta == ("output_0", "FP32", [3, 4])
    np.testing.assert_allclose(pdata, jdata, atol=1e-5, rtol=0)
    np.testing.assert_allclose(pdata, sides[1].http.models["mlp"].infer([x])[0], atol=1e-6, rtol=0)


def test_infer_errors_answer_as_jax(sides):
    x = np.zeros((1, 16), np.float32)
    bad_raw = _infer_req(x, raw=True)
    bad_raw.inputs[0].datatype = "BF16"
    unknown = _infer_req(x)
    unknown.model_name = "ghost"
    cases = [unknown, _infer_req(x, name="y"), _infer_req(np.zeros((1, 5), np.float32)), bad_raw]
    for req in cases:
        got = [s.outcome("ModelInfer", req, pb.ModelInferResponse)[0] for s in sides]
        assert got[1] == got[0] != "OK", req


def test_metadata_answers_as_jax_but_the_platform(sides):
    for name in ("mlp", "lm"):
        j, p = (s.call("ModelMetadata", pb.ModelMetadataRequest(name=name),
                       pb.ModelMetadataResponse) for s in sides)
        if name == "mlp":
            assert (j.platform, p.platform) == ("flexflow_tpu", "flexflow_tpu_torch")
        j.platform = p.platform = ""
        assert p == j, name
    codes = [s.outcome("ModelMetadata", pb.ModelMetadataRequest(name="ghost"),
                       pb.ModelMetadataResponse)[0] for s in sides]
    assert codes == ["NOT_FOUND", "NOT_FOUND"]


def test_repository_index_load_unload_answer_as_jax(sides):
    def index(s):
        r = s.call("RepositoryIndex", pb.RepositoryIndexRequest(), pb.RepositoryIndexResponse)
        return [(m.name, m.version, m.state) for m in r.models]

    steps = [
        ("RepositoryModelLoad", pb.RepositoryModelLoadRequest(model_name="spare"),
         pb.RepositoryModelLoadResponse),
        ("RepositoryModelUnload", pb.RepositoryModelUnloadRequest(model_name="spare"),
         pb.RepositoryModelUnloadResponse),
        ("RepositoryModelUnload", pb.RepositoryModelUnloadRequest(model_name="spare"),
         pb.RepositoryModelUnloadResponse),
        ("RepositoryModelLoad", pb.RepositoryModelLoadRequest(model_name="ghost"),
         pb.RepositoryModelLoadResponse),
    ]
    assert index(sides[1]) == index(sides[0]) == [("mlp", "1", "READY"),
                                                  ("spare", "1", "UNAVAILABLE")]
    for i, (method, req, resp_cls) in enumerate(steps):
        got = [s.outcome(method, req, resp_cls)[0] for s in sides]
        assert got[1] == got[0], method
        assert got[0] == ("OK", "OK", "NOT_FOUND", "NOT_FOUND")[i]
        if i == 0:
            assert index(sides[1]) == index(sides[0]) == [("mlp", "1", "READY"),
                                                          ("spare", "1", "READY")]
    assert index(sides[1]) == index(sides[0])


def _stream_req(prompt, **params):
    req = pb.ModelInferRequest(model_name="lm", id="g1")
    t = req.inputs.add()
    t.name, t.datatype = "tokens", "INT32"
    t.shape.extend([len(prompt)])
    t.contents.int_contents.extend(prompt)
    for k, v in params.items():
        if isinstance(v, str):
            req.parameters[k].string_param = v
        else:
            req.parameters[k].int64_param = v
    return req


@pytest.mark.parametrize("params", [dict(max_new_tokens=6),
                                    dict(max_new_tokens=8, top_k=5, seed=7, temperature="0.8")],
                         ids=["greedy", "seeded"])
def test_stream_infer_tokens_equal_jaxs(sides, params):
    streams = []
    for s in sides:
        resps = list(s.stream(_stream_req([1, 2, 3, 4], **params)))
        toks = [r.outputs[0].contents.int_contents[0] for r in resps[:-1]]
        final = resps[-1].outputs[0]
        assert final.name == "tokens" and list(final.contents.int_contents) == toks
        assert all(r.outputs[0].name == "token" for r in resps[:-1])
        streams.append(toks)
    assert streams[1] == streams[0] and len(streams[0]) == params["max_new_tokens"]


def test_traceparent_joins_and_returns_as_jax(sides):
    tp = f"00-{'ab' * 16}-{'cd' * 8}-01"
    seen = []
    for s in sides:
        call = s.stream(_stream_req([7, 8, 9], max_new_tokens=4),
                        metadata=(("traceparent", tp),))
        final = list(call)[-1]
        trailing = dict(call.trailing_metadata() or ())
        seen.append((final.parameters["journey_id"].string_param,
                     parse_traceparent(trailing["traceparent"])[0]))
    assert seen[1] == seen[0] == ("ab" * 16, "ab" * 16)


def test_health_and_breaker_codes_answer_as_jax(sides):
    """Live, ready, model ready; with the MLP's breaker forced open, both
    health calls read not ready and infer answers UNAVAILABLE; after the
    breaker's window a probe closes it again."""
    x = np.zeros((1, 16), np.float32)
    for s in sides:
        assert s.call("ServerLive", pb.ServerLiveRequest(), pb.ServerLiveResponse).live
        assert s.call("ServerReady", pb.ServerReadyRequest(), pb.ServerReadyResponse).ready
    health = []
    for s in sides:
        b = s.http.batchers["mlp"]
        clk = FakeClock()
        old = b.breaker
        b.breaker = s.Breaker(failure_threshold=1, recovery_s=10.0, clock=clk)
        try:
            b.breaker.record_failure()
            health.append((
                s.call("ServerReady", pb.ServerReadyRequest(), pb.ServerReadyResponse).ready,
                s.call("ModelReady", pb.ModelReadyRequest(name="mlp"), pb.ModelReadyResponse).ready,
                s.call("ModelReady", pb.ModelReadyRequest(name="ghost"),
                       pb.ModelReadyResponse).ready,
                s.outcome("ModelInfer", _infer_req(x), pb.ModelInferResponse)[0],
            ))
            clk.advance(11.0)
            assert s.outcome("ModelInfer", _infer_req(x), pb.ModelInferResponse)[0] == "OK"
            assert b.breaker.state == s.Breaker.CLOSED
        finally:
            b.breaker = old
    assert health[1] == health[0] == (False, False, False, "UNAVAILABLE")


def test_overload_rejection_codes_and_metadata_answer_as_jax(sides):
    """The generation model's limiter at 0: RESOURCE_EXHAUSTED with the
    same retry-after and overload metadata."""
    got = []
    for s in sides:
        lim = s.gen.scheduler.overload.limiter
        with lim._lock:
            old, lim._limit = lim._limit, 0.0
        try:
            with pytest.raises(grpc.RpcError) as ei:
                list(s.stream(_stream_req([1, 2, 3], priority="best_effort")))
        finally:
            with lim._lock:
                lim._limit = old
        md = dict(ei.value.trailing_metadata() or ())
        got.append((ei.value.code().name, md["overload-reason"], md["overload-priority"],
                    int(md["retry-after-ms"]) >= 1000))
    assert got[1] == got[0] == ("RESOURCE_EXHAUSTED", "limiter", "best_effort", True)


@pytest.mark.parametrize("err,code", [
    ("DeadlineExceededError", "DEADLINE_EXCEEDED"),
    ("QueueFullError", "RESOURCE_EXHAUSTED"),
    ("OverloadedError", "RESOURCE_EXHAUSTED"),
    ("CircuitOpenError", "UNAVAILABLE"),
    ("ShuttingDownError", "UNAVAILABLE"),
])
def test_grpc_code_maps_as_jaxs(err, code):
    from flexflow_tpu.serving import resilience as jres

    for mod in (jres, resilience):
        cls = getattr(mod, err)
        e = cls("x") if err != "OverloadedError" else cls("x", reason="limiter",
                                                           priority="best_effort",
                                                           retry_after_s=1.0)
        assert mod.grpc_code(e, grpc).name == code
