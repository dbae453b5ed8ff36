"""The port's evidence runner (``flexflow_tpu_torch/tools/evidence.py``)
and its watcher against the JAX package's ``tools/tpu_evidence.py`` and
``tools/evidence_watcher.sh`` on the CPU.

The file mechanics are JAX's: ``_append`` writes the same file for the
same entries, by an atomic replace; ``_graceful_run`` answers a child
that outlives its timeout the same way (SIGINT first: a Python child
unwinds with KeyboardInterrupt); a lever runs in a child process of its
own and lands in the file; a rerun skips it; a lever child killed at its
timeout leaves the file valid JSON with its error. The runner exits 2
when the probe finds no card (nothing recorded), and the watcher retries
on 2 and 3, stops on anything else and exits with the runner's last
code. The levers run a one-layer 32-wide model here (``--tiny``).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from flexflow_tpu_torch.tools import evidence
from tools import tpu_evidence

pytestmark = pytest.mark.torch_port

REPO = Path(__file__).resolve().parent.parent
WATCHER = REPO / "flexflow_tpu_torch" / "tools" / "evidence_watcher.sh"


def test_append_writes_the_file_jax_writes(tmp_path, monkeypatch):
    monkeypatch.setattr(tpu_evidence, "EVIDENCE", tmp_path / "jax.json")
    monkeypatch.setattr(evidence, "EVIDENCE", str(tmp_path / "port.json"))
    entries = [{"phase": "lever", "config": "bert_base_b32_dp", "step_ms": 16.5},
               {"phase": "lever", "config": "bert_base_b64_dp", "error": "timeout 1200s"}]
    for e in entries:
        tpu_evidence._append(e)
        evidence._append(e)
    jdata = json.loads((tmp_path / "jax.json").read_text())
    tdata = json.loads((tmp_path / "port.json").read_text())
    assert jdata["runs"] == tdata["runs"] == entries
    assert (tmp_path / "jax.json").read_text().endswith("}\n")
    assert (tmp_path / "port.json").read_text().endswith("}\n")
    assert not list(tmp_path.glob("*.tmp"))
    # a corrupt file is started afresh by both, as JAX's _load does
    (tmp_path / "port.json").write_text("{not json")
    (tmp_path / "jax.json").write_text("{not json")
    assert evidence._load()["runs"] == tpu_evidence._load()["runs"] == []


def test_graceful_run_answers_a_timeout_as_jax(monkeypatch):
    sleeper = [sys.executable, "-c", "import time; print('up', flush=True); time.sleep(30)"]
    got = evidence._graceful_run(sleeper, timeout=1.0, grace=10.0)
    want = tpu_evidence._graceful_run(sleeper, timeout=1.0)
    assert got[3] is want[3] is True
    # SIGINT first: the child unwinds through KeyboardInterrupt, then
    # exits by SIGINT (Python's exit for an uncaught KeyboardInterrupt)
    assert got[0] == want[0] == -2
    assert "KeyboardInterrupt" in got[2] and "KeyboardInterrupt" in want[2]
    ok = [sys.executable, "-c", "print('done')"]
    assert evidence._graceful_run(ok)[:2] == tpu_evidence._graceful_run(ok)[:2] == (0, "done\n")


def _runner(tmp_path, *extra):
    return evidence.main(["--device", "cpu", "--tiny", "--quick", "--iters", "2",
                          "--out", str(tmp_path / "evidence.json"), *extra])


def test_a_lever_lands_and_a_rerun_skips_it(tmp_path):
    assert _runner(tmp_path) == 0
    runs = json.loads((tmp_path / "evidence.json").read_text())["runs"]
    assert [(r["phase"], r["config"]) for r in runs] == [("lever", "bert_base_b32_dp")]
    lever = runs[0]
    assert lever["backend"] == "cpu" and lever["batch"] == 32 and lever["step_ms"] > 0
    assert lever["strategy_axes"] == {"data": 1} and lever["params"] > 0
    assert _runner(tmp_path) == 0
    assert json.loads((tmp_path / "evidence.json").read_text())["runs"] == runs


def test_a_killed_child_leaves_the_file_valid(tmp_path):
    """A lever child past its timeout (0.5 s: the child is still importing
    torch) is killed; its error is recorded, the probe answers again, the
    runner completes."""
    assert _runner(tmp_path, "--child-timeout", "0.5") == 0
    runs = json.loads((tmp_path / "evidence.json").read_text())["runs"]
    assert [(r["phase"], r["config"], r["error"]) for r in runs] == [
        ("lever", "bert_base_b32_dp", "timeout 0.5s")]
    assert not list(tmp_path.glob("*.tmp"))


def test_the_full_sweep_records_the_flash_lever_as_not_applicable(tmp_path, monkeypatch):
    """Without --quick every lever runs (stubbed here) and the flash
    block sweep, which the port's wrapper does not expose, is recorded as
    not applicable; the profile phase runs mfu_profile --large."""
    seen, cmds = [], []
    monkeypatch.setattr(evidence, "_run_child",
                        lambda payload, timeout: (seen.append(payload) or {"step_ms": 1.0}, None))
    monkeypatch.setattr(evidence, "_graceful_run",
                        lambda cmd, env=None, timeout=0: (cmds.append(cmd) or (0, "{}\n", "", False)))
    assert evidence.main(["--device", "cpu", "--tiny", "--skip-calibration",
                          "--out", str(tmp_path / "e.json")]) == 0
    runs = json.loads((tmp_path / "e.json").read_text())["runs"]
    jax_levers = ["bert_base_b16_dp", "bert_base_b32_dp", "bert_base_b64_dp",
                  "bert_large_b16_dp", "bert_large_b32_dp", "bert_base_b32_searched",
                  "bert_large_b16_searched"]
    assert [r["config"] for r in runs if r["phase"] == "lever"] == jax_levers
    assert [p["batch"] for p in seen] == [16, 32, 64, 16, 32, 32, 16]
    assert [bool(p.get("searched")) for p in seen] == [False] * 5 + [True, True]
    sweep = [r for r in runs if r["phase"] == "flash_block_sweep"]
    assert len(sweep) == 1 and sweep[0]["not_applicable"] and "tile" in sweep[0]["reason"]
    assert [r["phase"] for r in runs][-1] == "mfu_profile_large" and runs[-1]["rc"] == 0
    assert "flexflow_tpu_torch.tools.mfu_profile" in cmds[-1] and "--large" in cmds[-1]
    # a rerun records nothing new
    assert evidence.main(["--device", "cpu", "--tiny", "--skip-calibration",
                          "--out", str(tmp_path / "e.json")]) == 0
    assert json.loads((tmp_path / "e.json").read_text())["runs"] == runs


@pytest.mark.parametrize("case", ["complete", "no_card", "crash"])
def test_watcher_exit_codes(case, tmp_path):
    """The watcher retries on 2 and 3, stops on 0 and on any other code,
    and exits with the runner's last code (JAX's watcher's rules)."""
    if case == "no_card" and torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    quick = ["--device", "cpu", "--tiny", "--quick"]
    # the quick lever already recorded: the runner has nothing to run
    (tmp_path / "e.json").write_text(json.dumps({"runs": [
        {"phase": "lever", "config": "bert_base_b32_dp", "step_ms": 1.0}]}))
    (tmp_path / "dir.json").mkdir()
    args = {"complete": quick + ["--out", str(tmp_path / "e.json")],
            "no_card": ["--out", str(tmp_path / "e.json")],
            # the evidence file is a directory: reading it raises (rc 1)
            "crash": quick + ["--out", str(tmp_path / "dir.json")]}[case]
    env = dict(os.environ, FF_EVIDENCE_ATTEMPTS="2", FF_EVIDENCE_SLEEP="0",
               PYTHONPATH=str(REPO))
    log = REPO / "torch_tools_out" / "evidence.log"
    start = log.stat().st_size if log.exists() else 0
    proc = subprocess.run(["bash", str(WATCHER), *args], env=env, capture_output=True,
                          text=True, timeout=300)
    with open(log) as f:
        f.seek(start)
        tail = f.read()
    want_rc, attempts = {"complete": (0, 1), "no_card": (2, 2), "crash": (1, 1)}[case]
    assert proc.returncode == want_rc, (proc.stderr, tail[-2000:])
    assert tail.count("=== runner rc=") == attempts, tail[-2000:]
    assert ("not an outage, stopping" in tail) == (case == "crash")
    # no card: the runner recorded nothing, nor did the completed rerun
    assert len(json.loads((tmp_path / "e.json").read_text())["runs"]) == 1
    jax_watcher = (REPO / "tools" / "evidence_watcher.sh").read_text()
    for rule in ("if [ $rc -eq 0 ]; then break; fi", "[ $rc -ne 2 ] && [ $rc -ne 3 ]"):
        assert rule in jax_watcher and rule in WATCHER.read_text(), rule
