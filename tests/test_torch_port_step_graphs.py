"""The engine's step bodies, as the CUDA graphs capture them, on the CPU.

On a CUDA device each step kind replays a captured graph; on the CPU the
same bodies run eagerly, through the same packed input buffer and the
same readback, and are held here against the JAX package: the prefill
length on the device, every slot's Gumbel noise drawn inside the step,
the one readback of tokens and finiteness flags. The card-only checks
(replay bit-identical to eager, one capture per signature, launches per
replay) are in ``tests/test_torch_port_cuda.py``.
"""
import ast
import os

import jax
import numpy as np
import pytest
import torch

from flexflow_tpu.generation import GenerationEngine as JGenerationEngine
from flexflow_tpu.generation import SamplingParams as JSamplingParams
from flexflow_tpu.generation import forward_full as jforward_full
from flexflow_tpu.generation import init_decoder_params as jinit_decoder_params
from flexflow_tpu.models.transformer import TransformerConfig as JTransformerConfig
from flexflow_tpu_torch.generation import (
    GenerationEngine,
    SamplingParams,
    decoder_params_from_numpy,
)
from flexflow_tpu_torch.generation import prng
from flexflow_tpu_torch.generation.decoder import decode_step
from flexflow_tpu_torch.generation.engine import _sample, derive_keys
from flexflow_tpu_torch.generation.step_graphs import StepLayout, StepRunner
from flexflow_tpu_torch.models.transformer import TransformerConfig

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG_KW = dict(
    num_layers=2, hidden_size=32, num_heads=4, ff_size=64,
    seq_length=64, vocab_size=50, causal=True,
)
BUCKETS = (8, 16, 32, 64)
BLOCK = 8


@pytest.fixture(scope="module")
def both_params():
    jparams = jinit_decoder_params(jax.random.key(0), JTransformerConfig(**CFG_KW))
    return jparams, decoder_params_from_numpy(jax.tree.map(np.asarray, jparams))


def _engines(both_params, slots=3):
    jparams, params = both_params
    jeng = JGenerationEngine(jparams, JTransformerConfig(**CFG_KW), max_batch_slots=slots,
                             block_size=BLOCK, prompt_buckets=BUCKETS, prefix_cache=False)
    eng = GenerationEngine(params, TransformerConfig(**CFG_KW), max_batch_slots=slots,
                           block_size=BLOCK, prompt_buckets=BUCKETS, device="cpu")
    return jeng, eng


def test_step_layout_packs_every_4_byte_dtype_by_bits():
    arrays = {
        "tokens": np.asarray([[3, -1, 2**31 - 1]], np.int32),
        "temps": np.asarray([0.0, -0.5, 1e-30, np.inf], np.float32),
        "seeds": np.asarray([0, 2**31, 2**32 - 1], np.uint32),
    }
    layout = StepLayout(arrays)
    assert layout.size == 10
    buf = np.zeros((layout.size,), np.int32)
    layout.pack(buf, arrays)
    views = layout.unpack(torch.from_numpy(buf))
    np.testing.assert_array_equal(views["tokens"].numpy(), arrays["tokens"])
    np.testing.assert_array_equal(views["temps"].numpy(), arrays["temps"])
    assert views["temps"].dtype == torch.float32
    # uint32 travels as its int32 bits; the keys fold it back to 32 bits
    np.testing.assert_array_equal(views["seeds"].numpy().view(np.uint32), arrays["seeds"])
    k1, k2 = prng.key(views["seeds"])
    np.testing.assert_array_equal(k2.numpy(), arrays["seeds"].astype(np.int64))
    with pytest.raises(ValueError, match="signature"):
        layout.pack(buf, dict(arrays, tokens=np.zeros((1, 4), np.int32)))
    with pytest.raises(TypeError, match="4-byte"):
        StepLayout({"x": np.zeros((2,), np.int64)})
    with pytest.raises(ValueError, match="CUDA device"):
        StepRunner(torch.device("cpu"), graphs=True)


def test_eager_steps_is_the_only_path_on_the_cpu(both_params):
    _, params = both_params
    cfg = TransformerConfig(**CFG_KW)
    for eager in (False, True):
        eng = GenerationEngine(params, cfg, max_batch_slots=2, prompt_buckets=BUCKETS,
                               device="cpu", eager_steps=eager)
        assert not eng.graphs


@pytest.mark.parametrize("sp", [
    SamplingParams(),
    SamplingParams(temperature=0.9, top_k=7, seed=2**32 + 11),
], ids=["greedy", "seeded"])
def test_prefill_with_the_length_on_the_device_matches_jax(both_params, sp):
    """Prompt lengths at and across the 8/16/32 bucket edges: the first
    token equals the JAX engine's, the last-position logits the JAX
    forward's within 1e-5; one signature per bucket."""
    jparams, _ = both_params
    jeng, eng = _engines(both_params)
    rs = np.random.RandomState(4)
    jsp = JSamplingParams(temperature=sp.temperature, top_k=sp.top_k, seed=sp.seed)
    for n in (1, 7, 8, 9, 16, 17, 33):
        prompt = rs.randint(0, 50, n).tolist()
        jb = jeng.allocator.allocate(jeng.cache_config.blocks_for(n + 1))
        blocks = eng.allocator.allocate(eng.cache_config.blocks_for(n + 1))
        key = jax.random.fold_in(jax.random.key(sp.seed & 0xFFFFFFFF), 3)
        assert eng.prefill_one(prompt, blocks, sp, sample_index=3) == jeng.prefill_one(
            prompt, jb, jsp, key)
        want = np.asarray(jforward_full(jparams, np.asarray([prompt], np.int32)))[0, -1]
        assert eng.last_logits.shape == (50,)
        np.testing.assert_allclose(eng.last_logits.numpy(), want, atol=1e-5, rtol=0)
        assert eng.last_finite.tolist() == [True]
        np.testing.assert_allclose(eng.cache.k.numpy(), np.asarray(jeng.cache.k), atol=1e-5)
    assert {k: v for k, v in eng.trace_counts.items()} == {
        "prefill[8]": 1, "prefill[16]": 1, "prefill[32]": 1, "prefill[64]": 1}
    assert eng.step_counts["prefill"] == 7


def test_decode_draws_noise_for_every_slot_and_samples_as_before(both_params):
    """A batch of a greedy slot, two seeded slots and an inactive one:
    the tokens equal those of the JAX engine's decode and of the step as
    it was before (noise drawn only for the live sampled rows), the
    finiteness flags and logits come back with them; an inactive slot's
    noise changes nothing."""
    jeng, eng = _engines(both_params, slots=4)
    prompts = [[1, 2, 3, 4, 5], [9, 8, 7], list(range(10, 27))]
    sps = [SamplingParams(), SamplingParams(temperature=0.8, top_k=10, seed=42),
           SamplingParams(temperature=1.3, seed=2**31 - 1)]
    b, mb = 4, eng.max_blocks_per_seq
    tables = np.zeros((b, mb), np.int32)
    tokens = np.zeros((b,), np.int32)
    positions = np.zeros((b,), np.int32)
    active = np.asarray([True, True, True, False])
    temps = np.asarray([sp.temperature for sp in sps] + [0.9], np.float32)
    top_ks = np.asarray([sp.top_k for sp in sps] + [5], np.int32)
    seeds = np.asarray([sp.seed for sp in sps] + [77], np.uint32)
    for i, (p, sp) in enumerate(zip(prompts, sps)):
        blocks = eng.allocator.allocate(eng.cache_config.blocks_for(len(p) + 4))
        assert jeng.allocator.allocate(len(blocks)) == blocks
        tables[i, : len(blocks)] = blocks
        jsp = JSamplingParams(temperature=sp.temperature, top_k=sp.top_k, seed=sp.seed)
        tokens[i] = eng.prefill_one(p, blocks, sp, 0)
        assert tokens[i] == jeng.prefill_one(p, blocks, jsp, jax.random.fold_in(
            jax.random.key(sp.seed), 0))
        positions[i] = len(p)
    tables[3] = tables[0]  # an inactive slot with a real table writes only scratch
    for step in range(3):
        counts = np.asarray([1 + step] * 3 + [5], np.int32)
        ck, cv = eng.cache.k.clone(), eng.cache.v.clone()
        out = eng.decode(tokens, positions, tables, active, temps, top_ks, seeds, counts)
        jout = jeng.decode(tokens, positions, tables, active, temps, top_ks, seeds, counts)
        np.testing.assert_array_equal(out[active], np.asarray(jout)[active])
        assert eng.last_finite.tolist() == [True] * 4
        # the step before: noise for the live sampled rows only, zeros elsewhere
        x = eng.decode_arrays(tokens, positions, tables, active)
        logits, _, _ = decode_step(eng.params, *(torch.from_numpy(x[k]) for k in (
            "tokens", "positions")), ck, cv, torch.from_numpy(x["tables"]),
            torch.from_numpy(x["context_lens"]))
        noise = torch.zeros((b, 50))
        rows = np.flatnonzero(active & (temps > 0))
        noise[rows] = prng.gumbel(derive_keys(torch.from_numpy(seeds[rows].astype(np.int64)),
                                              torch.from_numpy(counts[rows])), (50,))
        before = _sample(logits, torch.from_numpy(temps), torch.from_numpy(top_ks), noise)
        np.testing.assert_array_equal(out[active], before.numpy()[active])
        torch.testing.assert_close(eng.last_logits, logits, atol=0, rtol=0)
        tokens = np.where(active, out, 0).astype(np.int32)
        positions = positions + active
    assert eng.trace_counts["decode"] == 1 and eng.recompiles() == {}


def test_finiteness_flags_come_back_with_the_tokens(both_params):
    """A slot whose cache holds NaN is flagged in last_finite; the others,
    and an inactive slot that attends to nothing, stay finite."""
    _, eng = _engines(both_params)
    b, mb = 3, eng.max_blocks_per_seq
    tables = np.zeros((b, mb), np.int32)
    for i, p in enumerate(([1, 2, 3], [4, 5, 6, 7])):
        blocks = eng.allocator.allocate(1)
        tables[i, :1] = blocks
        eng.prefill_one(p, blocks, SamplingParams(), 0)
    eng.cache.k[:, tables[1, 0]] = float("nan")
    active = np.asarray([True, True, False])
    eng.decode(np.asarray([1, 2, 0]), np.asarray([3, 4, 0]), tables, active,
               np.zeros((b,), np.float32), np.zeros((b,), np.int32),
               np.zeros((b,), np.uint32), np.zeros((b,), np.int32))
    assert eng.last_finite.tolist() == [True, False, True]


def test_chip_smoke_imports_neither_jax_nor_the_jax_package():
    """chip_smoke.py drives the port alone: no import of jax or of
    flexflow_tpu anywhere in it."""
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    assert "flexflow_tpu_torch" in names and "torch" in names
    assert not names & {"jax", "jaxlib", "flexflow_tpu"}, names
