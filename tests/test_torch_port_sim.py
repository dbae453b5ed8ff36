"""The port's fleet digital twin (``flexflow_tpu_torch/sim``) against the
JAX package's on the CPU.

Both twins replay the same pinned storm (``tests/data/storm_schedule.json``)
with the same cost table (``tools/simfleet.py::demo_costs``'s values, the
port's built from its own ``SimCosts``) and the same scenarios. The twin
is deterministic and reads no clock, so the gate is exact: the rendered
report dict for dict, ``trace_digest`` included, in the unified and the
disaggregated arms and in tick mode; a sweep's ranking; the cross-device
refusal of a ledger export; the ``sim:`` ledger pairs; the advisor's ramp
signals step for step.
"""
import json
import sys
from pathlib import Path

import pytest

from flexflow_tpu.obs import PredictionLedger as JLedger
from flexflow_tpu.serving.overload import AutoscaleAdvisor as JAdvisor
from flexflow_tpu.serving.overload import OverloadConfig as JOverload
from flexflow_tpu import sim as jsim
from flexflow_tpu.sim.report import measure_live as jmeasure_live
from flexflow_tpu_torch.obs import PredictionLedger as TLedger
from flexflow_tpu_torch.serving.overload import AutoscaleAdvisor as TAdvisor
from flexflow_tpu_torch.serving.overload import OverloadConfig as TOverload
from flexflow_tpu_torch import sim as tsim
from flexflow_tpu_torch.sim.report import SIM_PROVENANCE, measure_live as tmeasure_live

pytestmark = pytest.mark.torch_port

ROOT = Path(__file__).resolve().parent.parent
STORM = str(ROOT / "tests" / "data" / "storm_schedule.json")
sys.path.insert(0, str(ROOT))
from tools.simfleet import STORM_DT, STORM_OVERLOAD, demo_costs  # noqa: E402

# (package, overload config class, ledger class)
SIDES = ((jsim, JOverload, JLedger), (tsim, TOverload, TLedger))


def _port_demo_costs():
    """``demo_costs``'s table, built by the port's SimCosts."""
    return tsim.SimCosts(
        device_kind="v5e-sim",
        prefill_s={8: 0.004, 128: 0.045},
        decode_s=0.030,
        kv_swap_in_s=0.002,
        handoff_per_block_s=0.0005,
        source="pinned demo table (simfleet demo)",
    )


def _costs(pkg, tick=False):
    if tick:
        return pkg.SimCosts.fixed_tick(STORM_DT)
    return demo_costs() if pkg is jsim else _port_demo_costs()


def _render(pkg, ov_cls, tick=False, **kw):
    if "overload" in kw:
        kw["overload"] = ov_cls(**kw["overload"])
    sc = pkg.Scenario(**kw)
    return pkg.run_scenario(STORM, _costs(pkg, tick), sc).render()


def test_port_demo_costs_are_the_tools_table():
    assert _port_demo_costs().describe() == demo_costs().describe()


SCENARIOS = {
    "unified-x2": dict(name="u2", arm="unified", replicas=2),
    "unified-x1-ramp": dict(name="ramp", arm="unified", replicas=1,
                            overload=dict(autoscale_up_hold_s=0.3)),
    "unified-x2-traffic-x2": dict(name="x2", arm="unified", replicas=2, traffic_x=2.0),
    "disagg-1p1d": dict(name="d", arm="disagg", n_prefill=1, n_decode=1),
    "disagg-2p1d": dict(name="d2", arm="disagg", n_prefill=2, n_decode=1),
}


@pytest.mark.parametrize("case", sorted(SCENARIOS))
def test_report_equals_jaxs(case):
    """The rendered report, dict for dict (digest, events, percentiles,
    per-priority counts, overload activations, autoscale trace)."""
    j, t = (_render(pkg, ov, **SCENARIOS[case]) for pkg, ov, _ in SIDES)
    assert t == j
    assert t["trace_digest"] == j["trace_digest"] and t["events"] > 0


def test_tick_mode_report_equals_jaxs():
    kw = dict(name="tick", arm="unified", replicas=1, slots=3, max_queue=16,
              num_blocks=25, block_size=8, overload=dict(STORM_OVERLOAD))
    j, t = (_render(pkg, ov, tick=True, **dict(kw)) for pkg, ov, _ in SIDES)
    assert t == j
    assert t["costs"]["mode"] == "tick"


def test_sweep_ranking_equals_jaxs():
    outs = []
    for pkg, _, _ in SIDES:
        scens = [pkg.Scenario(name=f"unified-x{n}", arm="unified", replicas=n)
                 for n in (1, 2, 3)]
        scens.append(pkg.Scenario(name="disagg-1p1d", arm="disagg", n_prefill=1, n_decode=1))
        outs.append(pkg.sweep(STORM, _costs(pkg), scens, target_ttft_p99_s=1.0))
    j, t = outs
    assert json.dumps(t, sort_keys=True) == json.dumps(j, sort_keys=True)
    assert [r["scenario"] for r in t["ranked"]][-1] == "unified-x1"


def test_scale_schedule_equals_jaxs():
    from flexflow_tpu.sim.sweep import coerce_schedule as jcoerce
    from flexflow_tpu_torch.sim.sweep import coerce_schedule as tcoerce

    j = jsim.scale_schedule(jcoerce(STORM), 3.0)
    t = tsim.scale_schedule(tcoerce(STORM), 3.0)
    assert [vars(s) for s in t] == [vars(s) for s in j]
    with pytest.raises(ValueError, match="positive"):
        tsim.scale_schedule(t, 0.0)


def _export(tmp_path, device):
    doc = {
        "schema": "flexflow-ledger-export-v1",
        "models": {"lm": {"device_kind": device, "entries": [
            {"key": "prefill[8]", "predicted_s": 0.004, "pairs": 3, "measured_p50_s": 0.005},
            {"key": "decode", "predicted_s": 0.002, "pairs": 0, "measured_p50_s": None},
        ]}},
    }
    p = tmp_path / f"ledger-{device.replace(':', '_')}.json"
    p.write_text(json.dumps(doc))
    return str(p)


def test_ledger_export_loads_and_refuses_as_jax(tmp_path):
    path = _export(tmp_path, "chip:v5e")
    j = jsim.SimCosts.from_ledger_export(path, expect_device="chip:v5e")
    t = tsim.SimCosts.from_ledger_export(path, expect_device="chip:v5e")
    assert t.describe() == j.describe()
    assert (t.prefill_s[8], t.decode_s) == (0.005, 0.002)  # measured wins when paired
    msgs = []
    for pkg in (jsim, tsim):
        with pytest.raises(ValueError, match="device") as e:
            pkg.SimCosts.from_ledger_export(path, expect_device="v6e")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    with pytest.raises(ValueError, match="not a ledger export"):
        tsim.SimCosts.from_ledger_export({"schema": "x"})


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_from_strategy_prices_as_jaxs(tp):
    """``SimCosts.from_strategy``: the serving-layout search's prefill and
    decode seconds at the degree, per bucket, as the JAX twin's."""
    from flexflow_tpu.models.transformer import TransformerConfig as JConfig
    from flexflow_tpu_torch.models.transformer import TransformerConfig as TConfig

    kw = dict(num_layers=2, hidden_size=32, num_heads=4, ff_size=64, seq_length=64,
              vocab_size=61, causal=True)
    costs = [pkg.SimCosts.from_strategy(C(**kw), tp=tp, mesh_devices=4, buckets=[16, 64])
             for pkg, C in ((jsim, JConfig), (tsim, TConfig))]
    j, t = (vars(c) for c in costs)
    assert set(t) == set(j)
    for key in t:
        if key == "prefill_s":
            assert t[key].keys() == j[key].keys()
            assert all(abs(t[key][b] - j[key][b]) <= 1e-12 * j[key][b] for b in j[key])
        elif isinstance(t[key], float):
            assert abs(t[key] - j[key]) <= 1e-12 * abs(j[key]), key
        else:
            assert t[key] == j[key], key
    msgs = []
    for pkg, C in ((jsim, JConfig), (tsim, TConfig)):
        with pytest.raises(ValueError) as e:
            pkg.SimCosts.from_strategy(C(**kw), tp=3, mesh_devices=4, buckets=[16])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_sim_ledger_pairs_equal_jaxs():
    reports = []
    for pkg, _, ledger_cls in SIDES:
        ledger = ledger_cls(clock=lambda: 0.0)
        rep = pkg.run_scenario(STORM, _costs(pkg), pkg.Scenario(name="h", arm="unified",
                                                                replicas=2))
        keys = rep.register_predictions(ledger, prefix="t", alarm=False)
        measure = jmeasure_live if pkg is jsim else tmeasure_live
        paired = measure(ledger, prefix="t", live_metrics={"ttft_p50_s": 0.01})
        entries = {e["key"]: e for e in ledger.report()["entries"]}
        reports.append((keys, paired, {k: (entries[k]["provenance"], entries[k]["pairs"],
                                           entries[k]["predicted_s"]) for k in keys}))
    assert reports[1] == reports[0]
    keys, paired, entries = reports[1]
    assert paired == ["sim:t:ttft_p50_s"]
    assert all(p == SIM_PROVENANCE for p, _, _ in entries.values())


def test_advisor_ramp_hysteresis_equals_jaxs():
    """Idle, then saturated past ``up_hold_s``, then idle past
    ``down_hold_s``: the same signals step for step, want-more once,
    no flap, the first saturated observation held back."""
    runs = []
    for adv_cls in (JAdvisor, TAdvisor):
        clock = [0.0]
        adv = adv_cls(clock=lambda: clock[0], up_hold_s=1.0, down_hold_s=5.0, low_util=0.25)
        signals = []
        for duration, sat, util in ((2.0, 0.0, 0.1), (3.0, 1.0, 1.0), (8.0, 0.0, 0.05)):
            end = clock[0] + duration
            while clock[0] < end:
                signals.append(adv.observe(sat, util))
                clock[0] += 0.25
        runs.append(signals)
    assert runs[1] == runs[0]
    signals = runs[1]
    assert 1 in signals and -1 in signals and signals[8] == 0
    assert not any(a != 0 and b != 0 and a != b for a, b in zip(signals, signals[1:]))
