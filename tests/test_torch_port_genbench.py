"""The port's genbench (``flexflow_tpu_torch/tools/genbench.py``) against
the JAX package's ``tools/genbench.py``, base mode, at a tiny geometry.

The JAX tool runs in process (its own weights from ``jax.random.key(0)``);
the port's base mode runs on the CPU over the same weights converted.
The deterministic fields of the two reports are equal: the request and
token counts, scheduler steps and preemptions, the engine's captures per
step kind against the JAX engine's trace counts (one per prefill bucket,
one decode, none in steady state), and the self-healing / overload
counters (all zero). The port's streams equal the JAX engine's for the
same prompts. ``--mesh 2`` gates the tp=2 engine's streams as the JAX
tool gates its tp=2 engine's.
"""
import json
import sys

import jax
import numpy as np
import pytest

from flexflow_tpu.generation import GenerationEngine as JEngine
from flexflow_tpu.generation import SamplingParams as JSamplingParams
from flexflow_tpu.generation import init_decoder_params as jinit
from flexflow_tpu.models.transformer import TransformerConfig as JConfig
from flexflow_tpu_torch.generation import decoder_params_from_numpy
from flexflow_tpu_torch.tools import genbench as tgen
from tools import genbench as jgen

pytestmark = pytest.mark.torch_port

ARGS = ["--requests", "5", "--max-new", "6", "--layers", "1", "--hidden", "32", "--heads", "4",
        "--vocab", "64", "--seq-len", "64", "--bench-out", "", "--history-out", ""]
DETERMINISTIC = ("requests", "prompt_tokens", "generated_tokens", "scheduler_steps",
                 "preemptions", "trace_counts", "steady_state_retraces", "recompiles",
                 "engine_restarts", "quarantined", "watchdog_trips", "supervisor_step_retries",
                 "overload_activations")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("genbench") / "jax.json"
    old, sys.argv = sys.argv, ["genbench"] + ARGS + ["--out", str(out)]
    try:
        assert jgen.main() == 0
    finally:
        sys.argv = old
    jreport = json.loads(out.read_text())
    args = tgen.parse_args(ARGS + ["--device", "cpu"])
    cfg = tgen.model_config(args)
    jcfg = JConfig(num_layers=cfg.num_layers, hidden_size=cfg.hidden_size,
                   num_heads=cfg.num_heads, ff_size=cfg.ff_size, seq_length=cfg.seq_length,
                   vocab_size=cfg.vocab_size, causal=True)
    jparams = jinit(jax.random.key(0), jcfg)
    params = decoder_params_from_numpy(jax.tree.map(np.asarray, jparams))
    report, ok, outs, engine, prompts = tgen.base_bench(args, cfg, params)
    return dict(jreport=jreport, report=report, ok=ok, outs=outs, engine=engine,
                prompts=prompts, jparams=jparams, jcfg=jcfg, args=args)


def test_base_mode_fields_equal_jax(runs):
    report, jreport = runs["report"], runs["jreport"]
    assert runs["ok"]
    for key in DETERMINISTIC:
        assert report[key] == jreport[key], key
    assert report["trace_counts"]["decode"] == 1
    assert not report["steady_state_retraces"]
    assert report["backend"] == "cpu"


def test_streams_equal_jax(runs):
    jeng = JEngine(runs["jparams"], runs["jcfg"], max_batch_slots=4, block_size=16,
                   prefix_cache=False)
    want = jeng.generate(runs["prompts"], JSamplingParams(max_new_tokens=runs["args"].max_new))
    assert runs["outs"] == want


MESH_KEYS = ("requests", "mesh_devices", "generated_tokens", "exact", "exact_speculative",
             "steady_state_retraces", "engine_restarts", "quarantined", "watchdog_trips",
             "supervisor_step_retries", "overload_activations")


def test_mesh_gate_equals_jax(tmp_path, capsys):
    """``--mesh 2``: the tp=2 engine's streams byte-identical to the
    single-device engine's (mixed sampling and speculative), in both
    tools, with the same deterministic report fields; the port's ranks
    and transport printed (two CPU ranks over gloo)."""
    args = ARGS + ["--mesh", "2", "--requests", "4", "--max-new", "4"]
    jout, tout = tmp_path / "jax.json", tmp_path / "port.json"
    old, sys.argv = sys.argv, ["genbench"] + args + ["--out", str(jout)]
    try:
        assert jgen.main() == 0
    finally:
        sys.argv = old
    assert tgen.main(args + ["--device", "cpu", "--out", str(tout)]) == 0
    assert "mesh: 2 ranks on ['cpu', 'cpu'] over gloo" in capsys.readouterr().out
    j, t = json.loads(jout.read_text()), json.loads(tout.read_text())
    assert {k: t[k] for k in MESH_KEYS} == {k: j[k] for k in MESH_KEYS}
    assert t["exact"] and t["exact_speculative"] and t["chip"] == "cpu x2"
    assert t["serving_strategy"]["tp_degree"] == j["serving_strategy"]["tp_degree"] == 2
    assert t["serving_strategy"]["layout"] == j["serving_strategy"]["layout"]
    with pytest.raises(ValueError, match="backend='gloo'"):
        tgen.tool_mesh(2, devices=["cuda:0", "cuda:0"])
