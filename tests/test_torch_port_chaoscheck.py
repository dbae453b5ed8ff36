"""The port's chaoscheck recovery sweep
(``flexflow_tpu_torch/tools/chaoscheck.py::run_recovery_sweep``) against
the JAX package's ``tools/chaoscheck.py``.

Both sweeps run in process on the CPU over the same weights (the JAX
tool's ``jax.random.key(0)`` draws, converted for the port): crash,
stall (a real watchdog on real clocks), nan, double fault, budget and the
combined case. Every case's counters (recoveries, quarantined, watchdog
trips, replayed tokens, engine failures, typed failures) and its
exactness flags equal the JAX sweep's (the two real-clock cases' trip
and replay counts at least 1 on both sides), and both pass.
"""
import json

import jax
import numpy as np
import pytest

from flexflow_tpu.generation import init_decoder_params as jinit
from flexflow_tpu.models.transformer import TransformerConfig as JConfig
from flexflow_tpu_torch.generation import decoder_params_from_numpy
from flexflow_tpu_torch.tools import chaoscheck as tchaos
from tools import chaoscheck as jchaos

pytestmark = pytest.mark.torch_port

CFG = dict(num_layers=2, hidden_size=32, num_heads=4, ff_size=64, seq_length=64,
           vocab_size=50, causal=True)


def test_recovery_sweep_counters_equal_jax(capsys):
    assert jchaos.run_recovery_sweep()
    out = capsys.readouterr().out
    jreport = json.loads(out[:out.rindex("}") + 1])["recovery_sweep"]
    params = decoder_params_from_numpy(
        jax.tree.map(np.asarray, jinit(jax.random.key(0), JConfig(**CFG))))
    report = tchaos.run_recovery_sweep(device="cpu", params=params)
    assert report["ok"] and jreport["ok"]
    assert set(report) == set(jreport) == {
        "reference", "crash", "stall", "nan", "double_fault", "budget", "combined", "ok"}
    for case in ("reference", "crash", "nan", "double_fault", "budget"):
        assert report[case] == jreport[case], case
    # stall and combined run a real watchdog on real clocks: their flags
    # and quarantine count are exact; a loaded host may trip the watchdog
    # (and so replay) once more on either side
    for case in ("stall", "combined"):
        timed = {"watchdog_trips", "recoveries", "replayed_tokens"}
        assert ({k: v for k, v in report[case].items() if k not in timed}
                == {k: v for k, v in jreport[case].items() if k not in timed}), case
        assert all(min(report[case][k], jreport[case][k]) >= 1
                   for k in ("watchdog_trips", "recoveries") if k in report[case]), case
    assert report["crash"]["recoveries"] == 1 and report["nan"]["quarantined"] == 1


def test_mesh_raises():
    with pytest.raises(NotImplementedError, match="queue 1, item 4"):
        tchaos.main(["--mesh", "2"])
