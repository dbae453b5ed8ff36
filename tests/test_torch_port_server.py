"""The port's HTTP front end (``flexflow_tpu_torch/serving/server.py``,
``serving/generation.py``) against the JAX package's: one
``InferenceServer`` of each package on loopback, each serving a
``GenerationModel`` over the same weights (the JAX parameters converted
with ``decoder_params_from_numpy``; both models with request journeys
off, which ``test_torch_port_journey.py`` holds against each other). The
same requests must give the same tokens, the same SSE event streams, the
same statuses and error bodies (400, 504, 503 with ``Retry-After``), and
``/v2/stats``, ``/v2/models/{name}`` and ``/metrics`` must carry the same
keys and families."""
import json
import re
import urllib.error
import urllib.request

import pytest

from flexflow_tpu.generation.constrained import decode_text, validate_json
from flexflow_tpu.serving import InferenceServer as JInferenceServer
from flexflow_tpu.serving.generation import GenerationModel as JGenerationModel
from flexflow_tpu_torch.generation.constrained import default_vocabulary
from flexflow_tpu_torch.obs import validate_exposition
from flexflow_tpu_torch.serving import GenerationModel, InferenceServer
from torch_port_chaos import CFG_KW, JAX, PORT, engine

pytestmark = pytest.mark.torch_port

VOCAB = default_vocabulary(CFG_KW["vocab_size"])
SCHEMA = {"type": "object", "properties": {"ok": {"type": "boolean"}, "n": {"type": "integer"}}}
SPEC = {"type": "json_schema", "json_schema": SCHEMA}


@pytest.fixture(scope="module")
def servers():
    """(JAX base URL, port base URL, JAX model, port model)."""
    jmodel = JGenerationModel(engine(JAX)[0], name="lm", journeys=False)
    pmodel = GenerationModel(engine(PORT)[0], name="lm", journeys=False)
    jsrv, psrv = JInferenceServer(port=0), InferenceServer(port=0)
    jsrv.register_generation(jmodel)
    psrv.register_generation(pmodel)
    jsrv.start()
    psrv.start()
    yield (f"http://127.0.0.1:{jsrv.port}", f"http://127.0.0.1:{psrv.port}", jmodel, pmodel)
    psrv.stop()
    jsrv.stop()


def post(base, body, headers=None, raw=False):
    """(status, body: parsed JSON, or the raw text with ``raw``, headers)."""
    req = urllib.request.Request(
        base + "/v2/models/lm/generate",
        data=body if isinstance(body, bytes) else json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
    )
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            code, text, hdrs = r.status, r.read().decode(), r.headers
    except urllib.error.HTTPError as e:
        code, text, hdrs = e.code, e.read().decode(), e.headers
    return code, (text if raw else json.loads(text)), hdrs


def get(base, path, raw=False):
    try:
        with urllib.request.urlopen(base + path, timeout=60) as r:
            code, text = r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        code, text = e.code, e.read().decode()
    return code, (text if raw else json.loads(text))


def both_post(servers, body, **kw):
    jbase, pbase, _, _ = servers
    j, p = post(jbase, body, **kw), post(pbase, body, **kw)
    assert p[:2] == j[:2]
    return p


REQUESTS = [
    {"prompt": [1, 2, 3, 4], "max_new_tokens": 6},
    {"prompt": [5, 9, 2], "max_new_tokens": 8, "temperature": 0.8, "top_k": 5, "seed": 7},
    {"prompt": [3] * 20, "max_new_tokens": 5, "eos_id": 0, "priority": "interactive"},
]


@pytest.mark.parametrize("body", REQUESTS, ids=["greedy", "seeded", "eos"])
def test_json_generate_same_tokens(servers, body):
    code, resp, _ = both_post(servers, body)
    assert code == 200 and resp["num_generated"] == len(resp["tokens"]) > 0


@pytest.mark.parametrize("body", REQUESTS, ids=["greedy", "seeded", "eos"])
def test_sse_generate_same_events(servers, body):
    code, text, hdrs = both_post(servers, dict(body, stream=True), raw=True)
    assert code == 200 and hdrs["Content-Type"] == "text/event-stream"
    chunks = text.strip().split("\n\n")
    events = [json.loads(c.split("data: ", 1)[1]) for c in chunks]
    assert events[-1]["done"] is True
    assert [e["token"] for e in events[:-1]] == events[-1]["tokens"]
    assert [c.split("\n")[0] for c in chunks[:-1]] == [f"id: {i}" for i in range(len(chunks) - 1)]


@pytest.mark.parametrize("block", [{"k": 3}, {"k": 2, "adaptive": False}, {"enabled": False}])
def test_speculation_block_same_tokens(servers, block):
    body = {"prompt": [7, 8, 9, 7, 8, 9, 7, 8], "max_new_tokens": 12, "speculation": block}
    code, resp, _ = both_post(servers, body)
    assert code == 200
    plain = both_post(servers, {"prompt": body["prompt"], "max_new_tokens": 12})[1]
    assert resp["tokens"] == plain["tokens"]  # exact: greedy speculation is plain decode


@pytest.mark.parametrize("stream", [False, True])
@pytest.mark.parametrize("spec", [SPEC, {"type": "regex", "pattern": "(ab|ba)+c?"}],
                         ids=["json_schema", "regex"])
def test_response_format_same_tokens(servers, spec, stream):
    body = {"prompt": [1, 2, 3], "max_new_tokens": 24, "response_format": spec,
            "stream": stream}
    code, resp, _ = both_post(servers, body, raw=stream)
    assert code == 200
    if stream:
        resp = json.loads(resp.strip().split("\n\n")[-1].split("data: ", 1)[1])
    text = decode_text(VOCAB, resp["tokens"], None)
    if spec is SPEC:
        assert validate_json(text, SCHEMA) == [], text
    else:
        assert re.fullmatch("(ab|ba)+c?", text) or re.fullmatch("(ab|ba)*(a|b)?", text), text
    _, pbase, _, _ = servers
    stats = get(pbase, "/v2/stats")[1]["generation"]["lm"]
    assert stats["constrained_masked_steps_total"] >= 1


@pytest.mark.parametrize("body", [
    b"not json",
    {"max_new_tokens": 2},
    {"prompt": "abc"},
    {"prompt": [1, 2], "response_format": {"type": "csv"}},
    {"prompt": [1, 2], "response_format": {"type": "regex", "pattern": ""}},
    {"prompt": [1, 2], "response_format": 7},
    {"prompt": [1, 2], "priority": "urgent"},
    {"prompt": []},
    {"prompt": [1] * 70},
], ids=["json", "no_prompt", "str_prompt", "csv", "empty_regex", "format_type", "priority",
        "empty_prompt", "too_long"])
def test_malformed_requests_same_400(servers, body):
    code, resp, _ = both_post(servers, body)
    assert code == 400 and resp["error"]


@pytest.mark.parametrize("where", ["body", "header"])
def test_expired_timeout_same_504(servers, where):
    body = {"prompt": [1, 2, 3], "max_new_tokens": 2}
    headers = None
    if where == "body":
        body["parameters"] = {"timeout_ms": 0}
    else:
        headers = {"X-Request-Timeout-Ms": "0"}
    code, resp, _ = both_post(servers, body, headers=headers)
    assert code == 504 and resp["type"] == "DeadlineExceededError"


@pytest.mark.parametrize("priority", ["best_effort", "interactive"])
def test_overloaded_same_503_with_retry_after(servers, priority):
    jbase, pbase, jmodel, pmodel = servers
    limiters = [m.scheduler.overload.limiter for m in (jmodel, pmodel)]
    saved = [(lim._limit, lim.max_limit) for lim in limiters]
    for lim in limiters:
        with lim._lock:
            # every admission throttles; the ceiling too, or the loop
            # thread's next healthy interval raises the limit again
            lim._limit = lim.max_limit = 0.0
    try:
        body, headers = {"prompt": [1, 2, 3], "max_new_tokens": 2}, {"X-Request-Priority": priority}
        _, jresp, jhdrs = post(jbase, body, headers=headers)
        code, resp, hdrs = post(pbase, body, headers=headers)
    finally:
        for lim, (limit, ceiling) in zip(limiters, saved):
            with lim._lock:
                lim._limit, lim.max_limit = limit, ceiling
    assert resp == jresp
    assert code == 503 and resp["reason"] == "limiter" and resp["priority"] == priority
    assert hdrs["Retry-After"] == jhdrs["Retry-After"] and int(hdrs["Retry-After"]) >= 1
    jrep, prep = (get(b, "/v2/overload")[1]["models"]["lm"] for b in (jbase, pbase))
    assert prep["rejections"] == jrep["rejections"]


def _keys(d, prefix=""):
    """Every key path of a nested dict."""
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict):
            out |= _keys(v, prefix + k + ".")
    return out


def test_stats_and_metadata_same_keys(servers):
    jbase, pbase, _, _ = servers
    post(pbase, {"prompt": [1, 2, 3], "max_new_tokens": 3})
    post(jbase, {"prompt": [1, 2, 3], "max_new_tokens": 3})
    (jc, js), (pc, ps) = get(jbase, "/v2/stats"), get(pbase, "/v2/stats")
    assert jc == pc == 200 and js.keys() == ps.keys()
    jlm, plm = js["generation"]["lm"], ps["generation"]["lm"]
    assert set(plm) == set(jlm)
    (_, jm), (_, pm) = get(jbase, "/v2/models/lm"), get(pbase, "/v2/models/lm")
    assert _keys(pm) == _keys(jm)
    assert pm["platform"] == "flexflow_tpu_torch_generation" and pm["durable"]["enabled"] is False
    assert pm["serving_strategy"] == {"tp_degree": 1, "mesh_devices": 1}


def test_metrics_same_families(servers):
    jbase, pbase, _, _ = servers
    post(pbase, {"prompt": [1, 2, 3], "max_new_tokens": 3, "stream": True}, raw=True)
    post(jbase, {"prompt": [1, 2, 3], "max_new_tokens": 3, "stream": True}, raw=True)
    (_, jt), (pc, pt) = get(jbase, "/metrics", raw=True), get(pbase, "/metrics", raw=True)
    assert pc == 200 and validate_exposition(pt) == []

    def families(text):
        return {ln.split()[2] for ln in text.splitlines() if ln.startswith("# TYPE ")}

    assert families(pt) == families(jt)


@pytest.mark.parametrize("path", [
    "/v2/health/live", "/v2/health/ready", "/v2/models", "/v2/models/lm/ready",
    "/v2/debug/traces?n=4", "/v2/debug/timeline", "/v2/debug/cache", "/v2/debug/anatomy",
    "/v2/debug/predictions?model=lm", "/v2/debug/programs?model=lm", "/v2/debug/slow",
    "/v2/slo", "/v2/overload", "/v2/models/nope", "/v2/nope",
])
def test_debug_and_health_routes_same_shape(servers, path):
    jbase, pbase, _, _ = servers
    (jc, jb), (pc, pb) = get(jbase, path), get(pbase, path)
    assert pc == jc
    assert _keys(pb) == _keys(jb) or path.startswith("/v2/debug/")
    assert pb.keys() == jb.keys()
