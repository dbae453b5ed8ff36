"""Tensor-parallel serving through the port's serving layers on the CPU:
one HTTP generate on a tp-2 ``GenerationModel``, a ``DisaggregatedFleet``
whose prefill pool serves at tp 2 and decode pool at tp 1 (the wire's
full-head blocks re-split on import), and ``obsreport --selfcheck`` over
a tp-2 engine. Streams are held against the port's single-device
engine (which the engine tests hold against the JAX package's) over the
JAX package's weights.
"""
import json
import urllib.request

import jax
import numpy as np
import pytest

from conftest import FakeClock
from flexflow_tpu.generation import init_decoder_params as jinit_decoder_params
from flexflow_tpu.models.transformer import TransformerConfig as JTransformerConfig
from flexflow_tpu_torch.generation import (
    GenerationEngine,
    RecoveryPolicy,
    SamplingParams,
    decoder_params_from_numpy,
)
from flexflow_tpu_torch.models.transformer import TransformerConfig
from flexflow_tpu_torch.serving import GenerationModel, InferenceServer
from flexflow_tpu_torch.serving.fleet import DisaggregatedFleet
from flexflow_tpu_torch.tools import obsreport

pytestmark = [pytest.mark.torch_port, pytest.mark.mesh]

CFG_KW = dict(num_layers=2, hidden_size=32, num_heads=4, ff_size=64, seq_length=64,
              vocab_size=61, causal=True)
ENGINE_KW = dict(max_batch_slots=2, block_size=8, prompt_buckets=(8, 32, 64))
PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 8, 9, 10, 11, 12, 13], [9, 8, 7, 6, 5], list(range(1, 20))]


@pytest.fixture(scope="module")
def weights():
    jp = jinit_decoder_params(jax.random.key(0), JTransformerConfig(**CFG_KW))
    return jp, decoder_params_from_numpy(jax.tree.map(np.asarray, jp))


@pytest.fixture(scope="module")
def reference(weights):
    """The single-device engine's greedy streams, one prompt at a time."""
    eng = GenerationEngine(weights[1], TransformerConfig(**CFG_KW), device="cpu", **ENGINE_KW)
    return [eng.generate([p], SamplingParams(max_new_tokens=10))[0] for p in PROMPTS]


def test_http_generate_on_a_tp2_model(weights, reference):
    eng = GenerationEngine(weights[1], TransformerConfig(**CFG_KW), tp_degree=2, device="cpu",
                           **ENGINE_KW)
    srv = InferenceServer(port=0)
    srv.register_generation(GenerationModel(eng, name="lm"))
    srv.start()
    try:
        base = f"http://127.0.0.1:{srv.port}"
        req = urllib.request.Request(
            base + "/v2/models/lm/generate",
            data=json.dumps({"prompt": PROMPTS[1], "max_new_tokens": 10}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            body = json.loads(r.read())
        with urllib.request.urlopen(base + "/v2/models/lm", timeout=60) as r:
            meta = json.loads(r.read())
    finally:
        srv.stop()
        eng.close()
    assert body["tokens"] == reference[1]
    ss = meta["serving_strategy"]
    assert (ss["tp_degree"], ss["layout"]["kv_heads_per_shard"], ss["transport"]) == (2, 2, "gloo")


def test_disagg_pools_of_different_degrees(weights, reference):
    """Prefill at tp 2, decode at tp 1: the decode replica imports the
    prefill pool's full-head blocks (every rank's heads gathered on the
    wire) into its whole-head cache; the streams are the single
    engine's, with no rejected import."""
    cfg = TransformerConfig(**CFG_KW)
    engines = []

    def factory(tp):
        def make():
            eng = GenerationEngine(weights[1], cfg, tp_degree=tp, device="cpu", **ENGINE_KW)
            engines.append(eng)
            return eng
        return make

    d = DisaggregatedFleet(factory(2), factory(1), n_prefill=1, n_decode=1, clock=FakeClock(),
                           handoff_backoff_s=0.0,
                           scheduler_kwargs=dict(recovery=RecoveryPolicy(sleep=lambda _s: None)))
    try:
        (pre,), (dec,) = d.prefill._replicas_snapshot(), d.decode._replicas_snapshot()
        assert (pre.engine.tp_degree, dec.engine.tp_degree) == (2, 1)
        before = dec.scheduler.recovery_stats.kv_imports
        handles = [d.submit(p, SamplingParams(max_new_tokens=10)) for p in PROMPTS]
        for _ in range(500):
            if all(h.done() for h in handles):
                break
            d.step()
        streams = [h.result(timeout=0) for h in handles]
        rs = dec.scheduler.recovery_stats
        assert streams == reference
        assert rs.kv_imports - before == len(PROMPTS) and rs.kv_imports_rejected == 0
        assert d.handoff.replay_fallbacks == 0
    finally:
        d.stop()
        for eng in engines:
            eng.close()


def test_obsreport_selfcheck_at_tp2(capsys):
    """The whole observability proof (traces, metrics, quarantine and
    restart, durable warm restart, journeys) over a tp-2 engine, its
    metadata checked against the engine's mesh."""
    assert obsreport.selfcheck(device="cpu", tp_degree=2) == 0
    assert "OK: obsreport selfcheck" in capsys.readouterr().out
