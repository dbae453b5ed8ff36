"""The executor's program registry and truth-ledger leg, the server's and
obsreport's executor views, ``strategy.json`` in the model repository and
the overload storm, the port against the JAX package on the CPU.

One model, JAX's obsreport self-check model (dense 8 -> 8 ReLU -> 4,
softmax, batch 8, SGD 0.1, sparse categorical cross-entropy), built by
the JAX package and read into the port from its graph's JSON, so both
share node guids. The same call sequence on both sides (eager
``train_batch`` steps, ``fit(trace_window=4)`` over six batches: one
window and two tail steps, ``train_batch_repeated``, ``eval_window``,
``eval_batch``, ``predict`` at two batch sizes) registers the same
programs with the same trace counts and the same retrace blame, the
namespace ``executor[n]`` stripped. The strategy simulator's step
prediction equals JAX's at rel 1e-12 on the same calibration table and
the same machine (the JAX executor's machine holds the test mesh's 8
virtual devices: the port's device count is set to it). Sampling: the
first four calls of a program and every eighth, a tracing call never.
"""
import ast
import gc
import json
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu import ActiMode as JActiMode
from flexflow_tpu import FFConfig as JFFConfig
from flexflow_tpu import FFModel as JFFModel
from flexflow_tpu import LossType as JLossType
from flexflow_tpu import SGDOptimizer as JSGDOptimizer
from flexflow_tpu.core.types import CompMode as JCompMode
from flexflow_tpu.obs.capacity import GLOBAL_PROGRAMS as JPROGRAMS
from flexflow_tpu.obs.truth import GLOBAL_LEDGER as JLEDGER
from flexflow_tpu.search import calibration as jcal
from flexflow_tpu.serving import InferenceModel as JInferenceModel
from flexflow_tpu.serving import InferenceServer as JInferenceServer
from flexflow_tpu.serving import ModelRepository as JModelRepository
from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.core.graph import PCGraph
from flexflow_tpu_torch.core.types import CompMode, LossType
from flexflow_tpu_torch.generation import prng
from flexflow_tpu_torch.model import FFModel
from flexflow_tpu_torch.obs.capacity import GLOBAL_PROGRAMS
from flexflow_tpu_torch.obs.truth import GLOBAL_LEDGER
from flexflow_tpu_torch.runtime import SGDOptimizer
from flexflow_tpu_torch.runtime import executor as texecutor
from flexflow_tpu_torch.search import calibration as tcal
from flexflow_tpu_torch.serving import InferenceModel, InferenceServer, ModelRepository
from flexflow_tpu_torch.serving.repository import save_model

pytestmark = pytest.mark.torch_port

REPO = Path(__file__).resolve().parent.parent
NS = re.compile(r"executor\[\d+\]")


def _jax_model(batch=8, workers=1, inference=False):
    jm = JFFModel(JFFConfig(batch_size=batch, workers_per_node=workers))
    t = jm.create_tensor((batch, 8), name="x")
    t = jm.dense(t, 8, JActiMode.RELU)
    t = jm.dense(t, 4)
    t = jm.softmax(t)
    if inference:
        jm.compile(comp_mode=JCompMode.INFERENCE, outputs=[t])
    else:
        jm.compile(optimizer=JSGDOptimizer(lr=0.1),
                   loss_type=JLossType.SPARSE_CATEGORICAL_CROSSENTROPY)
    return jm


def _port_model(jm):
    tm = FFModel.from_graph(PCGraph.from_json(jm.graph.to_json()),
                            FFConfig(batch_size=jm.config.batch_size), device="cpu")
    tm.compile(optimizer=SGDOptimizer(lr=0.1),
               loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY)
    return tm


def _data(n=48, seed=0):
    rs = np.random.RandomState(seed)
    return rs.randn(n, 8).astype(np.float32), rs.randint(0, 4, (n,)).astype(np.int32)


def _strip(s):
    return NS.sub("executor[*]", s) if isinstance(s, str) else s


def _programs(registry, ns):
    return [{k: _strip(v) for k, v in e.items() if k != "compile_s"}
            for e in registry.snapshot() if e["name"].startswith(ns + ".")]


def _retraces(registry, ns):
    return [{k: _strip(v) for k, v in r.items() if k != "t"}
            for r in registry.recent_retraces() if r["program"].startswith(ns + ".")]


def _entry(ledger, ns):
    return next((e for e in ledger.report()["entries"] if e["key"] == f"{ns}.train_step"), None)


@pytest.fixture
def pair():
    jm = _jax_model()
    return jm, _port_model(jm)


def test_registry_names_traces_and_blame_equal_jax(pair):
    jm, tm = pair
    x, y = _data()
    for m in (jm, tm):
        m.fit(x, y, epochs=1, trace_window=4, verbose=False)
    jex, tex = jm.executor, tm.executor
    jx, jy = jnp.asarray(x[:8]), jnp.asarray(y[:8])
    for _ in range(2):
        jex.train_batch_repeated([jx], jy, jax.random.key(0), num_steps=2)
        tex.train_batch_repeated([x[:8]], y[:8], prng.key(0), num_steps=2)
    jex.eval_window([jnp.asarray(x[:16].reshape(2, 8, 8))], jnp.asarray(y[:16].reshape(2, 8)))
    tex.eval_window([x[:16].reshape(2, 8, 8)], y[:16].reshape(2, 8))
    jex.eval_batch([jx], jy)
    tex.eval_batch([x[:8]], y[:8])
    for rows in (8, 4, 8):
        jex.predict([jnp.asarray(x[:rows])])
        tex.predict([x[:rows]])
    got = _programs(GLOBAL_PROGRAMS, tex._prog_ns)
    want = _programs(JPROGRAMS, jex._prog_ns)
    assert got == want
    assert {e["name"]: e["traces"] for e in got} == {
        "executor[*].eval_step": 1, "executor[*].eval_window[2]": 1,
        "executor[*].forward": 2, "executor[*].train_repeat[2]": 1,
        "executor[*].train_step": 1, "executor[*].train_window[4]": 1}
    assert _retraces(GLOBAL_PROGRAMS, tex._prog_ns) == _retraces(JPROGRAMS, jex._prog_ns)
    assert [r["blame"] for r in _retraces(GLOBAL_PROGRAMS, tex._prog_ns)] == [
        "executor[*].forward retraced: arg2 pytree(1 leaves, 64 elems) -> "
        "pytree(1 leaves, 32 elems)"]
    # every trace stamped its call's wall time
    assert all(e["compile_s"] > 0 for e in GLOBAL_PROGRAMS.snapshot()
               if e["name"].startswith(tex._prog_ns + "."))
    # the same sampled, non-tracing calls measured
    assert _entry(GLOBAL_LEDGER, tex._prog_ns)["pairs"] == _entry(JLEDGER, jex._prog_ns)["pairs"]


@pytest.mark.parametrize("table", ["analytic", "cpu"])
def test_step_prediction_equals_jax(table, monkeypatch):
    """The ledger's prediction on the same calibration table (the
    analytic default, the factory CPU table) and the same machine."""
    jtable = jcal.Calibration() if table == "analytic" else jcal.load_calibration("cpu")
    ttable = tcal.Calibration() if table == "analytic" else tcal.load_calibration("cpu")
    assert jtable.to_json() == ttable.to_json()
    monkeypatch.setattr(jcal, "load_or_calibrate", lambda *a, **k: jtable)
    monkeypatch.setattr(tcal, "load_or_calibrate", lambda *a, **k: ttable)
    monkeypatch.setattr(texecutor, "_device_count", lambda device: len(jax.devices()))
    jm = _jax_model()
    tm = _port_model(jm)
    je, te = _entry(JLEDGER, jm.executor._prog_ns), _entry(GLOBAL_LEDGER, tm.executor._prog_ns)
    assert je["predicted_s"] > 0
    assert abs(te["predicted_s"] - je["predicted_s"]) <= 1e-12 * je["predicted_s"]
    # the same text but for the package's own copy of the table
    assert te["provenance"].replace("flexflow_tpu_torch/", "flexflow_tpu/") == je["provenance"]
    assert te["label"].endswith("(strategy step)")


def test_port_machine_is_its_one_device():
    """Without the test's alignment the port predicts for the one device
    it runs on (the CPU preset over the fitted contention)."""
    jm = _jax_model()
    tm = _port_model(jm)
    assert texecutor._device_count(tm.device) == 1
    assert _entry(GLOBAL_LEDGER, tm.executor._prog_ns)["predicted_s"] > 0


def test_sampling_and_a_capturing_call_are_never_measured(pair, monkeypatch):
    _, tm = pair
    ex = tm.executor
    x, y = _data(8)
    key = f"{ex._prog_ns}.train_step"
    calls = []
    real = texecutor.GLOBAL_LEDGER.measure
    monkeypatch.setattr(texecutor.GLOBAL_LEDGER, "measure",
                        lambda k, s: (calls.append(k), real(k, s)))
    measured_at = []
    for i in range(17):
        n = len(calls)
        ex.train_batch([x], y)
        if len(calls) > n:
            measured_at.append(i)
    # sampled at calls 0-3, 8 and 16; call 0 traced the program
    assert measured_at == [1, 2, 3, 8, 16]
    assert ex._truth_counts[key] == 17 and GLOBAL_PROGRAMS.trace_count(key) == 1
    # a window call that captures its step graph (faked: the CPU has no
    # graphs) is a trace: registered with blame, stamped, not measured
    words = ex._split_words(prng.key(1), 2)
    x, y = torch.from_numpy(x), torch.from_numpy(y)
    ex._window("train", [x], y, words, per_step=False)  # call 0: traces
    prog = f"{ex._prog_ns}.train_repeat[2]"
    real_steps = ex._window_steps

    def capturing(*a, **k):
        ex.graph_captures += 1
        return real_steps(*a, **k)

    monkeypatch.setattr(ex, "_window_steps", capturing)
    n = len(calls)
    ex._window("train", [x], y, words, per_step=False)  # call 1: sampled, captures
    assert len(calls) == n and GLOBAL_PROGRAMS.trace_count(prog) == 2
    assert GLOBAL_PROGRAMS.recent_retraces()[-1]["blame"] == (
        f"{prog} retraced: identical signature")
    monkeypatch.setattr(ex, "_window_steps", real_steps)
    ex._window("train", [x], y, words, per_step=False)  # call 2: sampled, measured
    assert len(calls) == n + 1


def test_namespace_evicted_when_the_executor_is_collected():
    tm = _port_model(_jax_model())
    x, y = _data(8)
    tm.executor.train_batch([x], y)
    tm.executor.train_batch([x], y)
    ns = tm.executor._prog_ns
    assert _programs(GLOBAL_PROGRAMS, ns) and _entry(GLOBAL_LEDGER, ns) is not None
    del tm
    gc.collect()
    assert not _programs(GLOBAL_PROGRAMS, ns) and _entry(GLOBAL_LEDGER, ns) is None


def test_debug_programs_executor_leg_equals_jax(pair):
    jm, tm = pair
    x, y = _data(8)
    jm.executor.train_batch([jnp.asarray(x)], jnp.asarray(y), jax.random.key(0))
    tm.executor.train_batch([x], y)
    jv = JInferenceServer(port=0).debug_programs()
    tv = InferenceServer(port=0).debug_programs()
    assert set(tv) == set(jv) == {"models", "executor"}
    assert set(tv["executor"]) == {"programs", "retraces"}
    mine = [{k: _strip(v) for k, v in e.items() if k != "compile_s"}
            for e in tv["executor"]["programs"] if e["name"].startswith(tm.executor._prog_ns)]
    theirs = [{k: _strip(v) for k, v in e.items() if k != "compile_s"}
              for e in jv["executor"]["programs"] if e["name"].startswith(jm.executor._prog_ns)]
    assert mine == theirs and mine
    assert "executor" not in InferenceServer(port=0).debug_programs(model="lm")


def test_obsreport_selfcheck_joins_an_executor_program(capsys):
    from flexflow_tpu_torch.tools import obsreport

    assert obsreport.selfcheck(device="cpu") == 0
    out = capsys.readouterr().out
    assert "truth ledger joined prefill/decode/verify + an executor program" in out
    jax_src = (REPO / "tools" / "obsreport.py").read_text()
    port_src = (REPO / "flexflow_tpu_torch" / "tools" / "obsreport.py").read_text()
    for text in ('f"executor program {ex_key} has no (predicted, measured) pair"',
                 '"rationale live, truth ledger joined prefill/decode/verify + an "',
                 '"executor program, a scaled calibration entry tripped the "'):
        assert text in jax_src and text in port_src, text


# ------------------------------------------------------------- strategy.json
def test_strategy_json_round_trips_in_jax_format(tmp_path):
    jim = JInferenceModel(_jax_model(inference=True), name="mlp", max_batch=8)
    JModelRepository(str(tmp_path / "j")).save(jim)
    jtext = (tmp_path / "j" / "mlp" / "strategy.json").read_text()
    # the port reads the JAX-written strategy and compiles with it
    loaded = ModelRepository(str(tmp_path / "j"), device="cpu").load("mlp")
    assert loaded.model.strategy.to_json() == jtext
    x = _data(8)[0]
    np.testing.assert_allclose(loaded.infer([x])[0], np.asarray(jim.infer([x])[0]),
                               rtol=1e-5, atol=1e-6)
    # the port writes the same file, which the JAX package reads
    save_model(loaded, str(tmp_path / "p"))
    assert (tmp_path / "p" / "mlp" / "strategy.json").read_text() == jtext
    back = JModelRepository(str(tmp_path / "p")).load("mlp")
    assert back.model.strategy.to_json() == jtext
    # a model compiled without a strategy file still loads (data parallel)
    (tmp_path / "p" / "mlp" / "strategy.json").unlink()
    assert ModelRepository(str(tmp_path / "p"), device="cpu").load("mlp").model.strategy.to_json() \
        == jtext


def test_strategy_json_for_too_many_devices_is_refused(tmp_path):
    jim = JInferenceModel(_jax_model(inference=True, workers=8), name="wide", max_batch=8)
    JModelRepository(str(tmp_path)).save(jim)
    assert json.loads((tmp_path / "wide" / "strategy.json").read_text())["axis_sizes"] == {
        "data": 8}
    with pytest.raises(ValueError, match="mesh needs 8 devices, have 1"):
        ModelRepository(str(tmp_path), device="cpu").load("wide")


# ------------------------------------------------------------- overload storm
def _storm(out: str) -> dict:
    start = out.index('{\n  "overload_sweep"')
    return json.JSONDecoder().raw_decode(out[start:])[0]["overload_sweep"]


def test_overload_storm_report_equals_jax(capsys):
    """ROADMAP queue 3 item 5, pinned: both packages run the storm on the
    virtual clock and report the same storm, its failing ladder gate
    included (the reference decides: ``up_threshold`` 0.9 and the gate
    stay as they are)."""
    from flexflow_tpu_torch.tools import chaoscheck as tchaos
    from tools import chaoscheck as jchaos

    jok = jchaos.run_overload_sweep()
    jreport = _storm(capsys.readouterr().out)
    report = tchaos.run_overload_sweep(device="cpu")
    capsys.readouterr()
    assert not jok and jreport["ok"] is False and report["ok"] is False
    assert report == jreport
    storm = report["storm"]
    per = storm["summary"]["per_priority"]
    assert storm["ladder"]["max_level_seen"] == 1
    assert storm["summary"]["submitted"] == 111
    assert per["best_effort"]["shed"] == 53 and storm["activations"]["throttled"] == 52


# ------------------------------------------------------------- import pin
NEW_MODULES = [
    "flexflow_tpu_torch/obs/capacity.py", "flexflow_tpu_torch/obs/__init__.py",
    "flexflow_tpu_torch/runtime/executor.py", "flexflow_tpu_torch/runtime/dataloader.py",
    "flexflow_tpu_torch/model.py", "flexflow_tpu_torch/serving/server.py",
    "flexflow_tpu_torch/serving/repository.py", "flexflow_tpu_torch/_native/__init__.py",
    "flexflow_tpu_torch/tools/obsreport.py", "flexflow_tpu_torch/tools/_bench.py",
    "flexflow_tpu_torch/tools/mfu_profile.py", "flexflow_tpu_torch/tools/calib_debug.py",
    "flexflow_tpu_torch/tools/evidence.py", "flexflow_tpu_torch/tools/programs_probe.py",
    "flexflow_tpu_torch/tools/loader_probe.py",
    "chip_smoke.py",
]


@pytest.mark.parametrize("path", NEW_MODULES)
def test_new_and_changed_modules_import_no_jax_bench_or_tools(path):
    """No import of jax, the JAX package, ``bench.py`` or ``tools/``
    anywhere in the module (function bodies included)."""
    for node in ast.walk(ast.parse((REPO / path).read_text())):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module]
        else:
            continue
        for mod in mods:
            assert mod.split(".")[0] not in ("jax", "jaxlib", "flexflow_tpu", "bench", "tools"), (
                path, mod)
