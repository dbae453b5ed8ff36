"""The port's simfleet (``flexflow_tpu_torch/tools/simfleet.py``) against
the JAX package's ``tools/simfleet.py``.

``demo``, ``sweep --demo-costs`` and a 2-point ``tune`` write the same
documents; ``simcheck``'s twin replay, live storm and divergence equal
the JAX tool's (the live storm runs the port's engine on the CPU on the
virtual clock, the JAX tool's its engine: TTFTs in virtual time do not
depend on the weights); a ledger export written by the port's obsreport
from a port server loads in both packages' ``from_ledger_export`` under
its device tag and is refused under another device's; ``tp`` raises.
"""
import argparse
import json
import urllib.request

import pytest

import torch_port_chaos as chaos
from flexflow_tpu import sim as jsim
from flexflow_tpu_torch import sim as tsim
from flexflow_tpu_torch.generation import SamplingParams
from flexflow_tpu_torch.serving import GenerationModel, InferenceServer
from flexflow_tpu_torch.tools import _common
from flexflow_tpu_torch.tools import obsreport as tobsreport
from flexflow_tpu_torch.tools import simfleet as tsimfleet
from tools import simfleet as jsimfleet

pytestmark = pytest.mark.torch_port


def _doc(path):
    with open(path) as f:
        return json.load(f)


def _both(tmp_path, cmd, **kw):
    docs, rcs = [], []
    for name, mod, schedule in (("jax", jsimfleet, jsimfleet.STORM_SCHEDULE),
                                ("port", tsimfleet, _common.STORM_SCHEDULE)):
        out = str(tmp_path / f"{name}-{cmd}.json")
        args = argparse.Namespace(schedule=schedule, out=out, **kw)
        rcs.append(getattr(mod, f"cmd_{cmd}")(args))
        docs.append(_doc(out))
    return docs, rcs


def test_demo_equals_jax(tmp_path):
    (j, t), rcs = _both(tmp_path, "demo")
    assert t == j and rcs == [0, 0]


def test_sweep_demo_costs_equals_jax(tmp_path):
    kw = dict(costs="", model="", expect_device="", demo_costs=True, arms="unified,disagg",
              replicas="1,2", prefill=1, decode=1, slots=4, max_queue=16, num_blocks=64,
              traffic_x=1.5, target_ttft_p99=0.5, target_shed=0.0)
    (j, t), rcs = _both(tmp_path, "sweep", **kw)
    assert t == j and rcs == [0, 0]


def test_tune_two_points_equals_jax(tmp_path):
    kw = dict(traffic="0.5,1.0", up_thresholds="0.8,0.9", down_thresholds="0.3",
              min_queue_fracs="0.125", allow_drift=True)
    (j, t), rcs = _both(tmp_path, "tune", **kw)
    assert t == j and rcs[0] == rcs[1]


def test_simcheck_equals_jax(tmp_path):
    docs, rcs = [], []
    for name, mod, extra in (("jax", jsimfleet, {}), ("port", tsimfleet, {"device": "cpu"})):
        out = str(tmp_path / f"{name}.json")
        schedule = jsimfleet.STORM_SCHEDULE if mod is jsimfleet else _common.STORM_SCHEDULE
        args = argparse.Namespace(schedule=schedule, bound=jsimfleet.DEFAULT_BOUND_S, out=out,
                                  **extra)
        rcs.append(mod.cmd_simcheck(args))
        docs.append(_doc(out))
    j, t = docs
    assert rcs == [0, 0] and t["ok"] and j["ok"]
    for key in ("sim", "live", "divergence", "ledger_keys", "bound_s"):
        assert t[key] == j[key], key
    assert tsimfleet.DEFAULT_BOUND_S == jsimfleet.DEFAULT_BOUND_S == 0.06
    assert tsimfleet.STORM_OVERLOAD == jsimfleet.STORM_OVERLOAD


def test_tp_raises():
    with pytest.raises(NotImplementedError, match="queue 1, item 4"):
        tsimfleet.cmd_tp(argparse.Namespace())


def test_port_ledger_export_loads_in_both(tmp_path, capsys):
    eng, _ = chaos.engine(chaos.PORT, slots=3, num_blocks=40)
    eng.generate([[1] * 8], SamplingParams(max_new_tokens=2))
    srv = InferenceServer(port=0)
    srv.register_generation(GenerationModel(eng, name="lm"))
    srv.start()
    try:
        for p in ([1, 2, 3], [4, 5, 6, 7, 8, 9, 10, 11, 12], [9, 8]):
            req = urllib.request.Request(
                f"http://127.0.0.1:{srv.port}/v2/models/lm/generate",
                data=json.dumps({"prompt": p, "max_new_tokens": 6}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as r:
                assert r.status == 200
        path = str(tmp_path / "ledger.json")
        assert tobsreport.export_predictions(f"http://127.0.0.1:{srv.port}", path) == 0
    finally:
        srv.stop()
    doc = _doc(path)
    assert doc["models"]["lm"]["device_kind"] == "cpu"
    costs = [pkg.SimCosts.from_ledger_export(path, expect_device="cpu").describe()
             for pkg in (jsim, tsim)]
    assert costs[0] == costs[1]
    for pkg in (jsim, tsim):
        with pytest.raises(ValueError, match="refusing"):
            pkg.SimCosts.from_ledger_export(path, expect_device="h100")
