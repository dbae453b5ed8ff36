"""The port's batched serving path (``serving/model.py``, ``batcher.py``,
``repository.py`` and the ``/infer`` and ``/v2/repository/*`` routes of
``serving/server.py``) against the JAX package's on the CPU.

The model is ``tests/test_serving.py``'s MLP (dense 16 -> 32 relu, dense
-> 4, softmax; max batch 8), compiled for inference in the JAX package;
the port serves the same graph (read from the JAX graph's JSON, guids
kept) with the same weights. Each case of ``test_serving.py`` without
gRPC, and the batcher cases of ``test_chaos.py``, runs through both
packages: outputs agree within atol 1e-5 (float32 in another summation
order), and statuses, error bodies, metadata (but the platform name),
repository indexes and the batchers' counters are equal. Chaos cases run
on virtual clocks and gates, one scenario function for both packages.
"""
import json
import threading
import time
import types
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import FakeClock
from flexflow_tpu import CompMode as JCompMode
from flexflow_tpu import DataType as JDataType
from flexflow_tpu import FFConfig as JFFConfig
from flexflow_tpu import FFModel as JFFModel
from flexflow_tpu.runtime import faults as jfaults
from flexflow_tpu.serving import CircuitBreaker as JCircuitBreaker
from flexflow_tpu.serving import DynamicBatcher as JDynamicBatcher
from flexflow_tpu.serving import InferenceModel as JInferenceModel
from flexflow_tpu.serving import InferenceServer as JInferenceServer
from flexflow_tpu.serving import ModelRepository as JModelRepository
from flexflow_tpu.serving import RetryPolicy as JRetryPolicy
from flexflow_tpu.serving import resilience as jresilience
from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.core.graph import PCGraph
from flexflow_tpu_torch.core.types import CompMode, DataType
from flexflow_tpu_torch.model import FFModel
from flexflow_tpu_torch.runtime import faults
from flexflow_tpu_torch.runtime.convert import to_tensor
from flexflow_tpu_torch.serving import (
    CircuitBreaker,
    DynamicBatcher,
    InferenceModel,
    InferenceServer,
    ModelRepository,
    RetryPolicy,
    load_model,
    resilience,
    save_model,
)

pytestmark = pytest.mark.torch_port


def _jax_mlp(name="mlp", batch=8, feat=16):
    ff = JFFModel(JFFConfig(batch_size=batch, workers_per_node=1))
    x = ff.create_tensor([batch, feat], name="x")
    t = ff.dense(x, 32, activation="relu")
    t = ff.dense(t, 4)
    out = ff.softmax(t)
    ff.compile(comp_mode=JCompMode.INFERENCE, outputs=[out])
    return JInferenceModel(ff, name=name, max_batch=batch)


def _port_of(jim):
    """The JAX model's graph and weights as a port InferenceModel."""
    jm = jim.model
    tm = FFModel.from_graph(PCGraph.from_json(jm.graph.to_json()),
                            FFConfig(batch_size=jm.config.batch_size), device="cpu")
    tm.compile(comp_mode=CompMode.INFERENCE,
               outputs=tm.output_tensors([(t.node.guid, t.idx) for t in jm._outputs]))
    with torch.no_grad():
        for key, ws in jm.executor.params.items():
            for w, a in ws.items():
                tm.executor.params[key][w].copy_(to_tensor(np.array(a)))
    return InferenceModel(tm, name=jim.name, max_batch=jim.max_batch)


@pytest.fixture(scope="module")
def models():
    jim = _jax_mlp()
    return jim, _port_of(jim)


def _x(n=1, seed=0):
    return np.random.RandomState(seed).randn(n, 16).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


# the two packages' classes, so a case is written once
JAX = types.SimpleNamespace(
    name="jax", faults=jfaults, Batcher=JDynamicBatcher, Server=JInferenceServer,
    Breaker=JCircuitBreaker, Retry=JRetryPolicy, errors=jresilience)
PORT = types.SimpleNamespace(
    name="port", faults=faults, Batcher=DynamicBatcher, Server=InferenceServer,
    Breaker=CircuitBreaker, Retry=RetryPolicy, errors=resilience)


def _fast_retry(side, **kw):
    kw.setdefault("max_attempts", 3)
    kw.setdefault("sleep", lambda _s: None)
    return side.Retry(**kw)


def _wait(cond, what):
    deadline = time.monotonic() + 10
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.001)


# ------------------------------------------------------------- the model
def test_inference_model_pads_slices_and_matches_jax(models):
    jim, tim = models
    x = _x(3)
    (out,) = tim.infer([x])
    assert out.shape == (3, 4) and out.dtype == np.float32
    _close(out, jim.infer([x])[0])
    (full,) = tim.infer([np.concatenate([x, x[:1]], axis=0)])
    np.testing.assert_array_equal(out, full[:3])  # padding changes no row


def test_inference_model_validates_like_jax(models):
    for im in models:
        with pytest.raises(ValueError, match="exceeds max_batch"):
            im.infer([np.zeros((9, 16), np.float32)])
        with pytest.raises(ValueError, match="expected"):
            im.infer([np.zeros((2, 7), np.float32)])
        with pytest.raises(ValueError, match="inputs"):
            im.infer([])


def test_metadata_equals_jax_but_the_platform(models):
    jim, tim = models
    jmd, tmd = jim.metadata(), tim.metadata()
    assert tmd.pop("platform") == "flexflow_tpu_torch"
    jmd.pop("platform")
    assert json.loads(json.dumps(tmd)) == json.loads(json.dumps(jmd))
    assert tmd["inputs"][0]["shape"] == (16,) and tmd["max_batch_size"] == 8


def test_from_onnx_is_not_ported(tmp_path):
    # from_onnx is ported (tests/test_torch_port_onnx.py), its strategy
    # file too (tests/test_torch_port_strategy.py): the file is opened
    # after the graph is built, so a missing one raises there, in both
    # packages
    from flexflow_tpu_torch.tools.frontend_probe import bert_onnx_graph

    proto = bert_onnx_graph(0, vocab=20, layers=1, hidden=16, heads=2, ff=32)
    missing = str(tmp_path / "strategy.json")
    with pytest.raises(FileNotFoundError):
        JInferenceModel.from_onnx(proto, {"ids": (4,)}, strategy_file=missing,
                                  input_dtypes={"ids": JDataType.INT32})
    with pytest.raises(FileNotFoundError):
        InferenceModel.from_onnx(proto, {"ids": (4,)}, strategy_file=missing,
                                 input_dtypes={"ids": DataType.INT32}, device="cpu")


# ------------------------------------------------------------- the batcher
def test_batcher_coalesces_and_scatters_like_jax(models):
    jim, tim = models
    xs = [_x(2, seed=i) for i in range(4)]
    outs = {}
    for side, im in ((JAX, jim), (PORT, tim)):
        b = side.Batcher(im, max_delay_s=0.05)
        b.start()
        try:
            futs = [b.submit([x]) for x in xs]
            outs[side.name] = [f.result(timeout=30)[0] for f in futs]
            outs[side.name + "_counters"] = b.stats.counters()
        finally:
            b.stop()
    for got, want in zip(outs["port"], outs["jax"]):
        _close(got, want)
    assert outs["port_counters"] == outs["jax_counters"]
    assert outs["port_counters"]["completed"] == 4


def test_batcher_concurrent_clients_match_jax(models):
    jim, tim = models
    b = DynamicBatcher(tim, max_delay_s=0.01)
    b.start()
    results, errs = {}, []

    def client(seed):
        try:
            results[seed] = b.infer([_x(1, seed)], timeout=30)[0]
        except Exception as e:  # pragma: no cover
            errs.append(e)

    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        b.stop()
    assert not errs, errs
    for seed, out in results.items():
        _close(out, jim.infer([_x(1, seed)])[0])
    assert b.batched_requests == 8 and 1 <= b.device_calls <= 8


def test_batcher_rejects_bad_shape_without_poisoning_batch(models):
    jim, tim = models
    b = DynamicBatcher(tim, max_delay_s=0.02)
    b.start()
    try:
        good = b.submit([_x()])
        with pytest.raises(ValueError):
            b.submit([np.zeros((1, 5), np.float32)])
        _close(good.result(timeout=30)[0], jim.infer([_x()])[0])
    finally:
        b.stop()


def test_batcher_restart_after_stop(models):
    _, tim = models
    b = DynamicBatcher(tim, max_delay_s=0.01)
    b.start()
    b.infer([_x()], timeout=30)
    b.stop()
    b.start()
    (out,) = b.infer([_x()], timeout=30)
    assert out.shape == (1, 4)
    b.stop()


def test_batcher_holds_over_nonfitting_request(models):
    jim, tim = models
    rs = np.random.RandomState(4)
    xs = [rs.randn(n, 16).astype(np.float32) for n in (5, 6, 1)]
    b = DynamicBatcher(tim, max_delay_s=0.05)
    b.start()
    try:
        outs = [f.result(timeout=30)[0] for f in [b.submit([x]) for x in xs]]
        assert [o.shape[0] for o in outs] == [5, 6, 1]
        assert b._pending is None
    finally:
        b.stop()
    for x, o in zip(xs, outs):
        _close(o, jim.infer([x])[0])


# ------------------------------------------------------------------- HTTP
def _request(base, path, body=None, method=None):
    """(status, parsed JSON body, headers) of one HTTP call."""
    data = None if body is None else (body if isinstance(body, bytes) else json.dumps(body).encode())
    req = urllib.request.Request(base + path, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read()), r.headers
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), e.headers


def _infer_body(x, name="x"):
    return {"inputs": [{"name": name, "shape": list(x.shape), "datatype": "FP32",
                        "data": x.reshape(-1).tolist()}]}


def _without_data(resp):
    return {**resp, "outputs": [{k: v for k, v in o.items() if k != "data"}
                                for o in resp["outputs"]]}


@pytest.fixture
def server_pair(models):
    jim, tim = models
    js, ps = JInferenceServer(port=0), InferenceServer(port=0)
    js.register(jim)
    ps.register(tim)
    with js, ps:
        yield f"http://127.0.0.1:{js.port}", f"http://127.0.0.1:{ps.port}", js, ps


def test_http_v2_protocol_answers_as_jax(server_pair):
    jbase, pbase, _, ps = server_pair
    for path in ("/v2/health/ready", "/v2/models", "/v2/models/mlp/ready"):
        assert _request(pbase, path)[:2] == _request(jbase, path)[:2], path
    jc, jmd, _ = _request(jbase, "/v2/models/mlp")
    pc, pmd, _ = _request(pbase, "/v2/models/mlp")
    assert pc == jc == 200 and {**pmd, "platform": 0} == {**jmd, "platform": 0}
    x = _x(3, seed=3)
    jc, jr, _ = _request(jbase, "/v2/models/mlp/infer", _infer_body(x))
    pc, pr, _ = _request(pbase, "/v2/models/mlp/infer", _infer_body(x))
    assert pc == jc == 200 and _without_data(pr) == _without_data(jr)
    _close(np.asarray(pr["outputs"][0]["data"]), np.asarray(jr["outputs"][0]["data"]))
    assert _request(pbase, "/v2/stats")[1]["models"]["mlp"]["completed"] == 1
    metrics = urllib.request.urlopen(pbase + "/metrics").read().decode()
    assert 'flexflow_serving_requests_total{model="mlp",outcome="completed"} 1' in metrics
    assert 'flexflow_serving_queue_depth{model="mlp"}' in metrics
    assert any(t["model"] == "mlp" for t in _request(pbase, "/v2/debug/traces")[1]["traces"])


def test_http_errors_answer_as_jax(server_pair):
    jbase, pbase, js, ps = server_pair
    cases = [
        ("/v2/models/nope", None, None),
        ("/v2/models/nope/infer", _infer_body(_x()), None),
        ("/v2/models/mlp/infer", {"inputs": []}, None),
        ("/v2/models/mlp/infer", b"not json", None),
        ("/v2/models/mlp/infer", _infer_body(_x(), name="y"), None),
        ("/v2/models/mlp/infer", _infer_body(np.zeros((1, 5), np.float32)), None),
        ("/v2/repository/index", {}, "POST"),
        ("/v2/nothing", {}, "POST"),
    ]
    for path, body, method in cases:
        jr, pr = _request(jbase, path, body, method), _request(pbase, path, body, method)
        assert pr[:2] == jr[:2], path
    # a stopped batcher is the server's fault: 500
    js.batchers["mlp"].stop()
    ps.batchers["mlp"].stop()
    jr = _request(jbase, "/v2/models/mlp/infer", _infer_body(_x()))
    pr = _request(pbase, "/v2/models/mlp/infer", _infer_body(_x()))
    assert pr[:2] == jr[:2] and pr[0] == 500


# ------------------------------------------------------------- repository
def test_repository_round_trip_both_ways(models, tmp_path):
    jim, tim = models
    x = _x(2, seed=1)
    want = jim.infer([x])[0]
    # the JAX package saves, the port loads
    JModelRepository(str(tmp_path / "j")).save(jim)
    repo = ModelRepository(str(tmp_path / "j"), device="cpu")
    assert repo.available() == ["mlp"]
    loaded = repo.load("mlp")
    _close(loaded.infer([x])[0], want)
    for key, ws in jim.model.executor.params.items():
        for w, a in ws.items():
            np.testing.assert_array_equal(loaded.model.executor.params[key][w].detach().numpy(),
                                          np.asarray(a))
    # the port saves, the JAX package loads (the same weights, the same graph)
    save_model(tim, str(tmp_path / "p"))
    assert not (tmp_path / "p" / "mlp" / "weights.npz.tmp").exists()
    back = JModelRepository(str(tmp_path / "p")).load("mlp")
    _close(np.asarray(back.infer([x])[0]), want)
    assert back.metadata()["inputs"] == jim.metadata()["inputs"]
    with pytest.raises(KeyError):
        repo.load("ghost")


def test_repository_bf16_from_jax_loads_bit_for_bit(tmp_path):
    # the MLP in bf16: bf16 input and dense layers
    ff = JFFModel(JFFConfig(batch_size=8, workers_per_node=1))
    x = ff.create_tensor([8, 16], JDataType.BFLOAT16, name="x")
    t = ff.dense(x, 32, activation="relu", datatype=JDataType.BFLOAT16)
    out = ff.softmax(ff.dense(t, 4, datatype=JDataType.BFLOAT16))
    ff.compile(comp_mode=JCompMode.INFERENCE, outputs=[out])
    jbf = JInferenceModel(ff, name="bf", max_batch=8)
    save = JModelRepository(str(tmp_path))
    save.save(jbf)
    with np.load(tmp_path / "bf" / "weights.npz") as z:
        assert {z[k].dtype.str for k in z.files} == {"|V2"}
    tim = load_model(str(tmp_path), "bf", device="cpu")
    for key, ws in ff.executor.params.items():
        for w, a in ws.items():
            p = tim.model.executor.params[key][w]
            assert p.dtype == torch.bfloat16
            np.testing.assert_array_equal(p.detach().view(torch.int16).numpy().view(np.uint16),
                                          np.asarray(a).view(np.uint16))
    xb = jnp.asarray(_x(3), jnp.bfloat16)
    want = np.asarray(jnp.asarray(jbf.infer([np.asarray(xb)])[0], jnp.float32))
    got = tim.infer([np.asarray(xb)])[0]
    assert got.dtype == np.float32
    # bf16 outputs: one bf16 ulp of probabilities below 1, plus 1e-6
    np.testing.assert_allclose(got, want, atol=2.0 ** -8 + 1e-6, rtol=0)
    # and the port writes bf16 back in the same form, read by the JAX package
    save_model(tim, str(tmp_path / "again"))
    with np.load(tmp_path / "again" / "bf" / "weights.npz") as z:
        assert {z[k].dtype.str for k in z.files} == {"|V2"}


def test_repository_http_lifecycle_answers_as_jax(models, tmp_path):
    jim, _ = models
    for sub in ("j", "p"):
        JModelRepository(str(tmp_path / sub)).save(jim)
    js = JInferenceServer(port=0, repository=JModelRepository(str(tmp_path / "j")))
    ps = InferenceServer(port=0, repository=ModelRepository(str(tmp_path / "p"), device="cpu"))
    x = _x(1, seed=2)
    steps = [
        ("/v2/repository/index", {}),
        ("/v2/repository/models/mlp/load", {}),
        ("/v2/repository/index", {}),
        ("/v2/models/mlp/ready", None),
        ("/v2/models/mlp/infer", _infer_body(x)),
        ("/v2/repository/models/mlp/unload", {}),
        ("/v2/models/mlp/infer", _infer_body(x)),
        ("/v2/models/mlp/ready", None),
        ("/v2/repository/models/mlp/unload", {}),
        ("/v2/repository/models/ghost/load", {}),
        ("/v2/repository/index", {}),
    ]
    with js, ps:
        jbase, pbase = f"http://127.0.0.1:{js.port}", f"http://127.0.0.1:{ps.port}"
        for path, body in steps:
            jr = _request(jbase, path, body, "POST" if body is not None else None)
            pr = _request(pbase, path, body, "POST" if body is not None else None)
            assert pr[0] == jr[0], path
            if path.endswith("/infer") and pr[0] == 200:
                assert _without_data(pr[1]) == _without_data(jr[1])
                _close(np.asarray(pr[1]["outputs"][0]["data"]),
                       np.asarray(jr[1]["outputs"][0]["data"]))
            else:  # (an error names its own repository's directory)
                assert (json.dumps(pr[1]).replace(str(tmp_path / "p"), "<root>")
                        == json.dumps(jr[1]).replace(str(tmp_path / "j"), "<root>")), path


# ------------------------------------------------------------------ chaos
@pytest.fixture(autouse=True)
def _no_leaked_plan():
    yield
    assert faults.active_plan() is None and jfaults.active_plan() is None


def _queue_full(side, im):
    gate = threading.Event()
    plan = side.faults.FaultPlan().on("serving.batcher.dispatch", mode="stall", gate=gate)
    b = side.Batcher(im, max_queue=2, max_delay_s=0.001, retry=_fast_retry(side))
    b.start()
    try:
        with plan.active():
            first = b.submit([_x()])
            _wait(lambda: plan.fired("serving.batcher.dispatch") >= 1, "never dispatched")
            q = [b.submit([_x(seed=1)]), b.submit([_x(seed=2)])]
            with pytest.raises(side.errors.QueueFullError) as ei:
                b.submit([_x(seed=3)])
            gate.set()
            outs = [f.result(timeout=30)[0] for f in [first] + q]
    finally:
        gate.set()
        b.stop()
    return {"error": type(ei.value).__name__, "reason": ei.value.reason, "outs": outs,
            "counters": b.stats.counters(), "calls": plan.calls("serving.model.infer")}


def _queue_full_http(side, im):
    gate = threading.Event()
    plan = side.faults.FaultPlan().on("serving.batcher.dispatch", mode="stall", gate=gate)
    srv = side.Server(port=0, batcher_kwargs={"max_queue": 1, "max_delay_s": 0.001})
    srv.register(im)
    results = []
    with srv:
        base = f"http://127.0.0.1:{srv.port}"

        def post():
            results.append(_request(base, "/v2/models/mlp/infer", _infer_body(_x()))[0])

        with plan.active():
            t1 = threading.Thread(target=post)
            t1.start()
            _wait(lambda: plan.fired("serving.batcher.dispatch") >= 1, "never dispatched")
            t2 = threading.Thread(target=post)
            t2.start()
            _wait(lambda: srv.batchers["mlp"]._q.qsize() >= 1, "never queued")
            code, body, headers = _request(base, "/v2/models/mlp/infer", _infer_body(_x()))
            gate.set()
            t1.join(timeout=30)
            t2.join(timeout=30)
        counters = srv.batchers["mlp"].stats.counters()
    gate.set()
    return {"code": code, "body": body, "retry_after": headers.get("Retry-After"),
            "others": sorted(results), "counters": counters}


def _expired_deadline(side, im):
    clk = FakeClock()
    gate = threading.Event()
    plan = side.faults.FaultPlan().on("serving.batcher.dispatch", mode="stall", gate=gate)
    b = side.Batcher(im, clock=clk, max_delay_s=0.001, retry=_fast_retry(side))
    b.start()
    try:
        with plan.active():
            first = b.submit([_x()])
            _wait(lambda: plan.fired("serving.batcher.dispatch") >= 1, "never dispatched")
            doomed = b.submit([_x(seed=1)], deadline_s=1.0)
            clk.advance(2.0)
            gate.set()
            out = first.result(timeout=30)[0]
            with pytest.raises(side.errors.DeadlineExceededError):
                doomed.result(timeout=30)
            with pytest.raises(side.errors.DeadlineExceededError):
                b.submit([_x()], deadline_s=0)
            calls = plan.calls("serving.model.infer")
    finally:
        gate.set()
        b.stop()
    return {"out": out, "calls": calls, "counters": b.stats.counters()}


def _poisoned(side, im):
    plan = side.faults.FaultPlan().on(
        "serving.model.infer", mode="error",
        when=lambda xs: any(np.isnan(np.asarray(x)).any() for x in xs))
    b = side.Batcher(im, max_delay_s=0.05, retry=_fast_retry(side))
    b.start()
    try:
        with plan.active():
            f1 = b.submit([_x(2, seed=1)])
            f2 = b.submit([np.full((1, 16), np.nan, np.float32)])
            f3 = b.submit([_x(1, seed=2)])
            outs = [f1.result(timeout=30)[0], f3.result(timeout=30)[0]]
            with pytest.raises(side.faults.FaultInjected):
                f2.result(timeout=30)
            calls, fired = plan.calls("serving.model.infer"), plan.fired("serving.model.infer")
    finally:
        b.stop()
    return {"outs": outs, "calls": calls, "fired": fired, "counters": b.stats.counters(),
            "breaker": b.breaker.state}


def _breaker(side, im):
    clk = FakeClock()
    breaker = side.Breaker(failure_threshold=2, recovery_s=10.0, clock=clk)
    srv = side.Server(port=0, batcher_kwargs={
        "breaker": breaker, "clock": clk, "max_delay_s": 0.001,
        "retry": _fast_retry(side, max_attempts=1)})
    srv.register(im)
    plan = side.faults.FaultPlan().on("serving.model.infer", mode="error", max_fires=2)
    seen = []
    with srv:
        base = f"http://127.0.0.1:{srv.port}"
        b = srv.batchers["mlp"]

        def health():
            seen.append(tuple(_request(base, p)[0] for p in (
                "/v2/health/ready", "/v2/health/live", "/v2/models/mlp/ready")))

        health()
        with plan.active():
            for _ in range(2):
                with pytest.raises(side.faults.FaultInjected):
                    b.infer([_x()], timeout=30)
        state_open = breaker.state
        health()
        code, body, _ = _request(base, "/v2/models/mlp/infer", _infer_body(_x()))
        with pytest.raises(side.errors.CircuitOpenError):
            b.submit([_x()])
        clk.advance(11.0)
        out = b.infer([_x()], timeout=30)[0]
        health()
        counters = b.stats.counters()
        readiness = _request(base, "/v2/health/ready")[1]
    return {"open": state_open, "closed": breaker.state, "health": seen, "code": code,
            "body": body, "out": out, "counters": counters, "readiness": readiness}


CHAOS = {"queue_full": _queue_full, "queue_full_http_503": _queue_full_http,
         "expired_deadline_never_reaches_device": _expired_deadline,
         "poisoned_request_fails_alone": _poisoned, "breaker_and_health": _breaker}


def _same(got, want, path="result"):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        _close(np.asarray(got), want)
    else:
        assert got == want, f"{path}: {got!r} != {want!r}"


@pytest.mark.parametrize("case", list(CHAOS))
def test_batcher_chaos_matches_jax(models, case):
    """Each chaos scenario of ``test_chaos.py`` through both packages: the
    same outcomes, statuses, bodies, fault-site calls and counters."""
    jim, tim = models
    want = CHAOS[case](JAX, jim)
    got = CHAOS[case](PORT, tim)
    _same(got, want)
    if case == "expired_deadline_never_reaches_device":
        assert got["calls"] == 1 and got["counters"]["expired"] == 2
    if case == "poisoned_request_fails_alone":
        assert got["counters"]["failed"] == 1 and got["counters"]["completed"] == 2
    if case == "breaker_and_health":
        assert got["health"] == [(200, 200, 200), (503, 200, 503), (200, 200, 200)]
        assert got["code"] == 503 and got["open"] == "open" and got["closed"] == "closed"
    if case == "queue_full_http_503":
        assert got["code"] == 503 and got["retry_after"] == "1"
