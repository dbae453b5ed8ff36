"""The port's obsreport views (``flexflow_tpu_torch/tools/obsreport.py``)
against the JAX package's ``tools/obsreport.py``.

A port ``InferenceServer`` on the CPU (a ``GenerationModel`` with
durability and journeys on) serves a few requests, a constrained one, a
traced one and an armed anatomy capture; every endpoint the views read
is then recorded once and served back from a stub server, so both
packages' views read the very same JSON: each view prints the JAX tool's
text, returns its exit code and writes the same files (the ledger export
included).
"""
import http.server
import json
import threading
import urllib.error
import urllib.request

import pytest

import torch_port_chaos as chaos
from flexflow_tpu_torch.generation import SamplingParams
from flexflow_tpu_torch.serving import GenerationModel, InferenceServer
from flexflow_tpu_torch.serving.durable import DurabilityConfig
from flexflow_tpu_torch.tools import obsreport as tobs
from tools import obsreport as jobs

pytestmark = pytest.mark.torch_port

TRACE = "4bf92f3577b34da6a3ce929d0e0e4736"


def _post(base, body, headers=None):
    req = urllib.request.Request(base + "/v2/models/lm/generate", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def _fetch(url):
    try:
        with urllib.request.urlopen(url, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    """{path: (status, body)} of every endpoint the views read, from a
    port server after traffic; plus a request id and a journey id."""
    eng, _ = chaos.engine(chaos.PORT, slots=3, num_blocks=40, prefix_cache=True)
    eng.generate([[1] * 8], SamplingParams(max_new_tokens=2))
    model = GenerationModel(eng, name="lm")
    dur = model.enable_durability(DurabilityConfig(
        wal_dir=str(tmp_path_factory.mktemp("wal")), fsync=False))
    srv = InferenceServer(port=0)
    srv.register_generation(model)
    srv.start()
    base = f"http://127.0.0.1:{srv.port}"
    try:
        for p in ([1, 2, 3], [5, 6, 7, 8, 9, 10, 11, 12, 13, 14], [5, 6, 7, 8, 9, 10, 11, 12, 2]):
            _post(base, {"prompt": p, "max_new_tokens": 6})
        _post(base, {"prompt": [4, 4], "max_new_tokens": 30, "response_format": {
            "type": "json_schema", "json_schema": {
                "type": "object", "properties": {"ok": {"type": "boolean"}}}}})
        _post(base, {"prompt": [7, 8], "max_new_tokens": 6},
              headers={"traceparent": f"00-{TRACE}-b7ad6b7169203331-01"})
        _fetch(base + "/v2/debug/anatomy?capture=4")
        _post(base, {"prompt": [3, 3, 3], "max_new_tokens": 6})
        traces = json.loads(_fetch(base + "/v2/debug/traces")[1])["traces"]
        rid = traces[0]["request_id"]
        paths = ["/v2/stats", "/v2/models/lm", f"/v2/debug/traces?id={rid}",
                 "/v2/debug/traces?id=999999", "/v2/debug/cache", "/v2/slo",
                 "/v2/debug/predictions", "/v2/debug/anatomy", "/v2/overload",
                 "/v2/fleet/autoscale", "/v2/fleet", "/v2/durable", "/v2/debug/slow",
                 "/v2/debug/journey", "/v2/debug/journey?slow=p99",
                 f"/v2/debug/journey/{TRACE}", "/v2/debug/journey/0000",
                 "/v2/debug/timeline"]
        rec = {p: _fetch(base + p) for p in paths}
    finally:
        srv.stop()
        dur.close()
    return rec, rid


@pytest.fixture(scope="module")
def stub(recorded):
    rec, _ = recorded

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            status, body = rec.get(self.path, (404, b'{"error": "not recorded"}'))
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):
            pass

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()
    th.join(timeout=10)


VIEWS = {
    "summary": lambda m, b, d, rid: m.summarize(b),
    "request": lambda m, b, d, rid: m.show_request(b, rid),
    "request-evicted": lambda m, b, d, rid: m.show_request(b, 999999),
    "cache": lambda m, b, d, rid: m.show_cache(b),
    "slo": lambda m, b, d, rid: m.show_slo(b),
    "predict": lambda m, b, d, rid: m.show_predictions(b),
    "anatomy": lambda m, b, d, rid: m.show_anatomy(b, out=str(d / "anatomy.json")),
    "overload": lambda m, b, d, rid: m.show_overload(b),
    "disagg": lambda m, b, d, rid: m.show_disagg(b),
    "constrained": lambda m, b, d, rid: m.show_constrained(b),
    "durable": lambda m, b, d, rid: m.show_durable(b),
    "slow": lambda m, b, d, rid: m.show_slow(b),
    "journey-list": lambda m, b, d, rid: m.show_journey(b),
    "journey-slow": lambda m, b, d, rid: m.show_journey(b, slow="p99"),
    "journey": lambda m, b, d, rid: m.show_journey(b, TRACE, timeline_out=str(d / "j.json")),
    "journey-unknown": lambda m, b, d, rid: m.show_journey(b, "0000"),
    "timeline": lambda m, b, d, rid: m.dump_timeline(b, str(d / "timeline.json")),
    "export": lambda m, b, d, rid: m.export_predictions(b, str(d / "ledger.json")),
}


@pytest.mark.parametrize("view", sorted(VIEWS))
def test_view_prints_jax_text(view, recorded, stub, tmp_path, capsys):
    _, rid = recorded
    outs = []
    for name, mod in (("jax", jobs), ("port", tobs)):
        d = tmp_path / name
        d.mkdir()
        rc = VIEWS[view](mod, stub, d, rid)
        cap = capsys.readouterr()
        files = {p.name: p.read_bytes() for p in sorted(d.iterdir())}
        outs.append((rc, cap.out.replace(str(d), "<dir>"), cap.err, files))
    assert outs[1] == outs[0]
    assert outs[1][1] or outs[1][2]  # the view said something


def test_export_document(recorded, stub, tmp_path):
    assert tobs.export_predictions(stub, str(tmp_path / "x.json")) == 0
    doc = json.loads((tmp_path / "x.json").read_text())
    assert doc["schema"] == tobs.LEDGER_EXPORT_SCHEMA == jobs.LEDGER_EXPORT_SCHEMA
    lm = doc["models"]["lm"]
    assert lm["device_kind"] == "cpu"
    assert any(e["key"] == "decode" and e["pairs"] > 0 for e in lm["entries"])
