"""The port's constrained decoding against the JAX package.

* the grammar units (``generation/constrained``): the same regexes,
  schemas and vocabularies compile to the same automata and the same
  mask rows, bit for bit, in both packages;
* the four step bodies with a non-zero grammar mask against the JAX
  engine's ``_prefill_impl``, ``_decode_impl``, ``_verify_impl`` and
  ``_prefix_prefill_impl``: tokens equal, logits within 1e-5;
* the scheduler cases of ``tests/test_constrained.py`` (greedy across
  overlap x speculation x prefix cache, seeded temperature, no new
  captures, crash replay, an unconstrained companion, the two mask fault
  sites, the vocabulary check) through ``tests/torch_port_chaos.py``:
  streams AND counters (constrained and recovery stats, pipeline
  dispatches / drains / discards, calls and fires per fault site) equal
  the JAX scheduler's.

The size is ``tests/test_constrained.py``'s: 2 layers, hidden 32,
vocabulary 50, block 8.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_port_chaos as chaos
from flexflow_tpu.generation import GenerationEngine as JGenerationEngine
from flexflow_tpu.generation import SamplingParams as JSamplingParams
from flexflow_tpu.generation import constrained as jcon
from flexflow_tpu.generation import decoder as jdec
from flexflow_tpu.models.transformer import TransformerConfig as JTransformerConfig
from flexflow_tpu.serving.stats import ConstrainedStats as JConstrainedStats
from flexflow_tpu_torch.generation import (
    ContinuousBatchingScheduler,
    GenerationEngine,
    SamplingParams,
    SpeculationConfig,
    decoder_params_from_numpy,
)
from flexflow_tpu_torch.generation import constrained as con
from flexflow_tpu_torch.models.transformer import TransformerConfig
from flexflow_tpu_torch.runtime import faults
from flexflow_tpu_torch.serving.stats import ConstrainedStats

pytestmark = pytest.mark.torch_port

CFG_KW = dict(
    num_layers=2, hidden_size=32, num_heads=4, ff_size=64,
    seq_length=64, vocab_size=50, causal=True,
)
V = CFG_KW["vocab_size"]
BUCKETS = chaos.BUCKETS
BLOCK = chaos.BLOCK
LOGITS_ATOL = 1e-5
VOCAB = con.default_vocabulary(V)
SCHEMA = {
    "type": "object",
    "properties": {"ok": {"type": "boolean"}, "n": {"type": "integer"}},
}
SPEC = {"type": "json_schema", "json_schema": SCHEMA}
REGEX = {"type": "regex", "pattern": "[a-z]{1,8}-[0-9]{2,4}"}
# an EOS id the object grammar never spells ('_'), as in the JAX tests
EOS = VOCAB.index("_")
SPECS = [
    SPEC,
    REGEX,
    {"type": "regex", "pattern": "(yes|no|maybe)"},
    {"type": "regex", "pattern": "(aZ)?b"},
    {"type": "json_schema", "json_schema": {
        "type": "object",
        "properties": {"name": {"type": "string", "maxLength": 4},
                       "tags": {"type": "array", "items": {"type": "integer"},
                                "minItems": 1, "maxItems": 2},
                       "kind": {"enum": ["a", "b"]}, "none": {"type": "null"},
                       "x": {"type": "number"}},
    }},
]
SPEC_IDS = ["object", "regex", "alternation", "pruned", "nested"]
BAD_SPECS = [
    42,
    {"type": "csv"},
    {"type": "json_schema"},
    {"type": "json_schema", "json_schema": []},
    {"type": "regex", "pattern": ""},
    {"type": "regex", "pattern": "(ab"},
    {"type": "regex", "pattern": "a{3,1}"},
    {"type": "json_schema", "json_schema": {"type": "object", "properties": {"s": {}}}},
    {"type": "regex", "pattern": "Z"},
]


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    yield
    assert faults.active_plan() is None and chaos.jfaults.active_plan() is None


def _compile(spec):
    return con.compile_response_format(spec, VOCAB), jcon.compile_response_format(spec, VOCAB)


def _walk(text):
    """Token ids spelling ``text`` one character at a time."""
    return [VOCAB.index(c) for c in text]


# ---------------------------------------------------------------------------
# grammar units
# ---------------------------------------------------------------------------


def test_default_vocabulary_is_jaxs_and_short_at_gpt2_width():
    """The port's table equals JAX's at every width, including the short
    table both give at GPT-2's 50257 (a discrepancy inside the reference,
    kept as it is)."""
    for n in (1, 50, 64, 1422, 50257):
        assert con.default_vocabulary(n) == jcon.default_vocabulary(n)
    assert len(con.default_vocabulary(50257)) == 1422
    assert con.grammar_alphabet(VOCAB) == jcon.grammar_alphabet(VOCAB)
    ids = [VOCAB.index(c) for c in '{"ok"'] + [EOS]
    assert con.decode_text(VOCAB, ids, EOS) == jcon.decode_text(VOCAB, ids, EOS) == '{"ok"'


@pytest.mark.parametrize("spec", SPECS, ids=SPEC_IDS)
def test_char_dfa_and_schema_regex_equal_jaxs(spec):
    """The same pattern (a regex, or the schema's lowering) compiles to the
    same character automaton: states, start, accepting set, transitions."""
    if spec["type"] == "json_schema":
        pattern = con.schema_to_regex(spec["json_schema"])
        assert pattern == jcon.schema_to_regex(spec["json_schema"])
    else:
        pattern = spec["pattern"]
    alphabet = con.grammar_alphabet(VOCAB)
    ours, theirs = con.compile_regex(pattern, alphabet), jcon.compile_regex(pattern, alphabet)
    assert isinstance(ours, con.CharDFA)
    assert (ours.start, ours.accepting, ours.transitions, ours.pattern) == (
        theirs.start, theirs.accepting, theirs.transitions, theirs.pattern)
    for word in ("yes", "no", "maybe", "ye", "", "b", "ab", "abc-12", "x-1", '{"ok":true,"n":7}'):
        assert ours.matches(word) == theirs.matches(word), word


@pytest.mark.parametrize("text,valid", [
    ('{"ok":true,"n":7}', True), ('{"ok":false,"n":-12}', True), ('{"ok":1}', False),
    ("not json", False), ('{"ok":true}', False), ('{"ok":true,"n":7,"z":1}', False),
    ("[]", False),
])
def test_validate_json_equals_jaxs(text, valid):
    got = con.validate_json(text, SCHEMA)
    assert got == jcon.validate_json(text, SCHEMA)
    assert (got == []) == valid


@pytest.mark.parametrize("bad", BAD_SPECS, ids=[f"bad{i}" for i in range(len(BAD_SPECS))])
def test_malformed_response_format_is_typed_in_both(bad):
    with pytest.raises(con.GrammarError) as ours:
        con.compile_response_format(bad, VOCAB)
    with pytest.raises(jcon.GrammarError) as theirs:
        jcon.compile_response_format(bad, VOCAB)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("spec", SPECS, ids=SPEC_IDS)
def test_mask_rows_equal_jaxs_bit_for_bit(spec):
    """Every state's row, with and without an EOS, equals JAX's bit for
    bit, and so do the pruned transitions; rows are cached read-only."""
    ours, theirs = _compile(spec)
    assert ours.vocab_size == theirs.vocab_size == V
    assert ours.start == theirs.start
    for st in range(ours.char_dfa.n_states):
        assert ours.allowed(st) == theirs.allowed(st)
        assert (ours.accepting(st), ours.exhausted(st), ours.dead(st)) == (
            theirs.accepting(st), theirs.exhausted(st), theirs.dead(st))
        for eos in (None, EOS):
            row = ours.mask_row(st, eos)
            assert row.dtype == np.float32 and row.shape == (V,)
            assert row.tobytes() == theirs.mask_row(st, eos).tobytes()
            assert ours.mask_row(st, eos) is row and not row.flags.writeable
        for tok in range(V):
            assert ours.step(st, tok) == theirs.step(st, tok)


def test_liveness_pruning_bans_a_trap_branch():
    """'Z' is in no token, so '(aZ)?b' must ban 'a' at the start although
    the character automaton steps on it; a grammar nothing can spell fails
    to compile."""
    ours, _ = _compile({"type": "regex", "pattern": "(aZ)?b"})
    a, b = VOCAB.index("a"), VOCAB.index("b")
    assert ours.char_dfa.step(ours.char_dfa.start, "a") is not None
    row = ours.mask_row(ours.start, None)
    assert row[b] == 0.0 and row[a] == con.NEG


def test_mask_state_walk_equals_jaxs():
    """The same walks give the same states, the same completion and the
    same typed refusals in both packages."""
    ours, theirs = _compile(SPEC)
    text = '{"ok":true,"n":3}'
    a, b = con.MaskState(ours), jcon.MaskState(theirs)
    for tok in _walk(text):
        a.advance(tok, EOS)
        b.advance(tok, EOS)
        assert (a.state, a.done, a.n_advanced, a.exhausted(), a.dead_end()) == (
            b.state, b.done, b.n_advanced, b.exhausted(), b.dead_end())
        assert a.mask_row(EOS).tobytes() == b.mask_row(EOS).tobytes()
    assert a.mask_row(EOS)[EOS] == 0.0
    a.advance(EOS, EOS)
    assert a.done and a.exhausted()
    for ms, err in ((a, con.MaskAdvanceError), (con.MaskState(ours), con.MaskAdvanceError)):
        with pytest.raises(err):
            ms.advance(VOCAB.index("9"), EOS)
    ms3 = con.MaskState(ours)
    ms3.advance(VOCAB.index("{"), EOS)
    with pytest.raises(con.MaskAdvanceError, match="non-accepting"):
        ms3.advance(EOS, EOS)


@pytest.mark.parametrize("draft", ['{"ok":z', '{"ok":tr', '{"ok":true,"n":12}_x', "x"])
def test_filter_draft_and_states_along_equal_jaxs(draft):
    ours, theirs = _compile(SPEC)
    ids = [EOS if c == "_" else VOCAB.index(c) for c in draft]
    a, b = con.MaskState(ours), jcon.MaskState(theirs)
    kept = a.filter_draft(ids, EOS)
    assert kept == b.filter_draft(ids, EOS)
    states = a.states_along(kept, EOS)
    assert states == b.states_along(kept, EOS)
    assert a.state == ours.start and a.n_advanced == 0  # neither walk advances
    for tok, want in zip(kept, states):  # states_along agrees with advancing
        a.advance(tok, EOS)
        assert a.state == want


def test_state_after_replays_and_fires_the_advance_site():
    """Replay re-advances through the ``generation.mask_advance`` site,
    whose calls and fires match JAX's under the same plan."""
    ours, theirs = _compile(SPEC)
    toks = _walk('{"ok":true')
    assert ours.state_after(toks, EOS).state == theirs.state_after(toks, EOS).state
    counters = []
    for mod, dfa in ((faults, ours), (chaos.jfaults, theirs)):
        plan = mod.FaultPlan(seed=0).on(mod.GENERATION_MASK_ADVANCE, mode="error",
                                        error=RuntimeError("injected"), nth=(4,))
        with plan.active():
            with pytest.raises(RuntimeError, match="injected"):
                dfa.state_after(toks, EOS)
        counters.append(plan.site_counters())
    assert counters[0] == counters[1] == {
        "generation.mask_advance": {"calls": 5, "fires": 1}}


def test_grammar_cache_counters_equal_jaxs():
    """Compile once per spec; hits, misses and the mask_build site's calls
    and fires equal JAX's, and a failed compile leaves nothing cached."""
    got = []
    for mod, cmod, stats_cls in ((faults, con, ConstrainedStats),
                                 (chaos.jfaults, jcon, JConstrainedStats)):
        stats = stats_cls()
        cache = cmod.GrammarCache(VOCAB, stats=stats)
        plan = mod.FaultPlan(seed=0).on(mod.GENERATION_MASK_BUILD, mode="error",
                                        error=RuntimeError("injected compile failure"),
                                        nth=(0,))
        with plan.active():
            with pytest.raises(RuntimeError):
                cache.get(SPEC)
            assert len(cache) == 0
            g1 = cache.get(SPEC)
            assert cache.get(dict(reversed(list(SPEC.items())))) is g1  # canonical key
            cache.get(REGEX)
        assert isinstance(g1, cmod.TokenDFA) and len(cache) == 2
        assert stats.grammar_compile_seconds > 0.0
        with pytest.raises(cmod.GrammarError):
            cache.get({"type": "regex", "pattern": object()})
        got.append(({f: getattr(stats, f) for f in stats.FIELDS
                     if f != "grammar_compile_seconds"}, plan.site_counters()))
    assert got[0] == got[1]
    assert got[0][0]["grammar_cache_misses"] == 2 and got[0][0]["grammar_cache_hits"] == 1
    with pytest.raises(ValueError, match="unknown"):
        ConstrainedStats().incr("nope")


# ---------------------------------------------------------------------------
# the four step bodies with a non-zero mask
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def both_params():
    jparams = chaos.jparams(cfg=CFG_KW)
    return jparams, decoder_params_from_numpy(jax.tree.map(np.asarray, jparams))


def _engines(both_params, slots=3):
    jparams, params = both_params
    jeng = JGenerationEngine(jparams, JTransformerConfig(**CFG_KW), max_batch_slots=slots,
                             block_size=BLOCK, prompt_buckets=BUCKETS, prefix_cache=False)
    eng = GenerationEngine(params, TransformerConfig(**CFG_KW), max_batch_slots=slots,
                           block_size=BLOCK, prompt_buckets=BUCKETS, device="cpu",
                           prefix_cache=False)
    return jeng, eng


def _rows(rs, n, allowed=5):
    """``n`` grammar rows of 0 / NEG, each allowing ``allowed`` random
    tokens: fewer than the top-k of the sampled rows."""
    rows = np.full((n, V), con.NEG, np.float32)
    for r in rows:
        r[rs.choice(V, allowed, replace=False)] = 0.0
    return rows


def _jsp(sp):
    return JSamplingParams(temperature=sp.temperature, top_k=sp.top_k, seed=sp.seed)


def _mask_is_zero(eng):
    return all(not m.any() for m in (eng._mask1, eng._mask_dec, eng._mask_ver)
               if m is not None)


@pytest.mark.parametrize("sp", [
    SamplingParams(),
    SamplingParams(temperature=0.8, top_k=20, seed=9),
], ids=["greedy", "seeded"])
def test_masked_prefill_and_suffix_prefill_match_jax(both_params, sp):
    """``_prefill_body`` and ``_prefix_prefill_body`` with a grammar row
    against ``_prefill_impl`` and ``_prefix_prefill_impl``: the token is
    JAX's and allowed by the row (top-k wider than the allowed set draws
    no banned token), the logits equal the JAX forward's plus the row
    within 1e-5, the flag sees the model's logits, and the mask is zero
    again after the step."""
    jparams, _ = both_params
    jeng, eng = _engines(both_params, slots=1)
    rs = np.random.RandomState(3)
    mb = eng.max_blocks_per_seq
    for n, prefix_len in ((5, 0), (13, 0), (13, 8), (30, 16)):
        prompt = rs.randint(0, V, n).tolist()
        row = _rows(rs, 1)[0]
        blocks = eng.allocator.allocate(eng.cache_config.blocks_for(n + 1))
        assert jeng.allocator.allocate(len(blocks)) == blocks
        key = jax.random.fold_in(jax.random.key(sp.seed), 2)
        if prefix_len:
            jeng.prefill_one(prompt[:prefix_len], blocks, _jsp(sp), key)
            eng.prefill_one(prompt[:prefix_len], blocks, sp, 2)
        snap = (jeng.cache.k, jeng.cache.v)
        token = eng.prefill_one(prompt, blocks, sp, sample_index=2, prefix_len=prefix_len,
                                mask=row)
        assert _mask_is_zero(eng)
        table = np.zeros((mb,), np.int32)
        table[: len(blocks)] = blocks
        suffix = prompt[prefix_len:]
        w = eng.bucket_for(len(suffix))
        tokens = np.zeros((1, w), np.int32)
        tokens[0, : len(suffix)] = suffix
        if prefix_len:
            jtoken, jok, jk, jv = jeng._prefix_prefill_impl(
                jparams, jnp.asarray(tokens), jnp.int32(prefix_len), jnp.int32(len(suffix)),
                snap[0], snap[1], jnp.asarray(table), jnp.float32(sp.temperature),
                jnp.int32(sp.top_k), key, jnp.asarray(row))
            offs = np.arange(w)
            pos = np.where(offs < len(suffix), prefix_len + offs, -1)[None].astype(np.int32)
            jl, _, _ = jdec.verify_step(jparams, jnp.asarray(tokens), jnp.asarray(pos),
                                        snap[0], snap[1], jnp.asarray(table)[None])
            want = np.asarray(jl)[0, len(suffix) - 1]
        else:
            jtoken, jok, jk, jv = jeng._prefill_impl(
                jparams, jnp.asarray(tokens), jnp.int32(n), snap[0], snap[1],
                jnp.asarray(table), jnp.float32(sp.temperature), jnp.int32(sp.top_k), key,
                jnp.asarray(row))
            want = np.asarray(jdec.forward_full(jparams, np.asarray([prompt], np.int32)))[0, -1]
        assert token == int(jtoken) and row[token] == 0.0
        assert eng.last_finite.tolist() == [bool(jok)] == [True]
        np.testing.assert_allclose(eng.last_logits.numpy(), want + row, atol=LOGITS_ATOL, rtol=0)
        jeng.cache.update(jk, jv)
        np.testing.assert_allclose(eng.cache.k.numpy(), np.asarray(jk), atol=LOGITS_ATOL)
        eng.allocator.free(blocks)
        jeng.allocator.free(blocks)
    assert eng.masked_step_count == 4
    assert eng.mask_bytes_staged == 4 * V * 4


def _prefill_both(jeng, eng, prompts, sps, extra):
    """Prefill ``prompts`` into both engines (blocks for ``extra`` more
    positions); returns (block lists, first tokens)."""
    blocks, first = [], []
    for p, sp in zip(prompts, sps):
        tb = eng.allocator.allocate(eng.cache_config.blocks_for(len(p) + extra))
        assert jeng.allocator.allocate(len(tb)) == tb
        jt = jeng.prefill_one(p, tb, _jsp(sp), jax.random.fold_in(jax.random.key(sp.seed), 0))
        assert eng.prefill_one(p, tb, sp, 0) == jt
        blocks.append(tb)
        first.append(jt)
    return blocks, first


def test_masked_decode_matches_jax_decode_impl(both_params):
    """``_decode_body`` with rows on two of three live slots (greedy and
    seeded, top-k wider than the allowed set) against ``_decode_impl``:
    tokens equal and allowed, logits within 1e-5 of the JAX decode
    forward's plus the mask; the mask is zero after every step, one
    signature serves masked and unmasked steps, and a row of the wrong
    width raises."""
    jparams, _ = both_params
    jeng, eng = _engines(both_params, slots=4)
    rs = np.random.RandomState(6)
    prompts = [[1, 2, 3, 4, 5], [9, 8, 7], list(range(10, 27))]
    sps = [SamplingParams(), SamplingParams(temperature=0.8, top_k=20, seed=42),
           SamplingParams(temperature=1.3, seed=7)]
    b, mb = 4, eng.max_blocks_per_seq
    blocks, first = _prefill_both(jeng, eng, prompts, sps, 4)
    tables = np.zeros((b, mb), np.int32)
    for i, bl in enumerate(blocks):
        tables[i, : len(bl)] = bl
    tokens = np.asarray(first + [0], np.int32)
    positions = np.asarray([len(p) for p in prompts] + [0], np.int32)
    active = np.asarray([True, True, True, False])
    temps = np.asarray([sp.temperature for sp in sps] + [0.0], np.float32)
    top_ks = np.asarray([sp.top_k for sp in sps] + [0], np.int32)
    seeds = np.asarray([sp.seed for sp in sps] + [0], np.uint32)
    bias = jnp.zeros((b,), jnp.float32)
    for step in range(3):
        counts = np.asarray([1 + step] * 3 + [0], np.int32)
        mask = np.zeros((b, V), np.float32)
        mask[[0, 1]] = _rows(rs, 2)
        x = eng.decode_arrays(tokens, positions, tables, active)
        snap = (jeng.cache.k, jeng.cache.v)
        out = eng.decode(tokens, positions, tables, active, temps, top_ks, seeds, counts,
                         mask={0: mask[0], 1: mask[1]})
        assert _mask_is_zero(eng)
        jout, jok, jk, jv = jeng._decode_impl(
            jparams, jnp.asarray(x["tokens"]), jnp.asarray(x["positions"]), snap[0], snap[1],
            jnp.asarray(x["tables"]), jnp.asarray(x["context_lens"]), jnp.asarray(temps),
            jnp.asarray(top_ks), bias, jnp.asarray(seeds), jnp.asarray(counts),
            jnp.asarray(mask))
        np.testing.assert_array_equal(out[active], np.asarray(jout)[active])
        assert all(mask[i, out[i]] == 0.0 for i in (0, 1))
        np.testing.assert_array_equal(eng.last_finite, np.asarray(jok))
        jl, _, _ = jdec.decode_step(jparams, jnp.asarray(x["tokens"]),
                                    jnp.asarray(x["positions"]), snap[0], snap[1],
                                    jnp.asarray(x["tables"]), jnp.asarray(x["context_lens"]))
        np.testing.assert_allclose(eng.last_logits.numpy()[active],
                                   (np.asarray(jl) + mask)[active], atol=LOGITS_ATOL, rtol=0)
        jeng.cache.update(jk, jv)
        tokens = np.where(active, out, 0).astype(np.int32)
        positions = positions + active
    assert eng.trace_counts["decode"] == 1 and eng.recompiles() == {}
    assert eng.mask_bytes_staged == 3 * 2 * V * 4
    with pytest.raises(ValueError, match="grammar mask"):
        eng.decode(tokens, positions, tables, active, temps, top_ks, seeds, counts,
                   mask={0: np.zeros((V + 1,), np.float32)})
    assert _mask_is_zero(eng)


def test_masked_verify_matches_jax_verify_impl(both_params):
    """``_verify_body`` with per-position rows on two slots (the scheduler
    builds them along each draft) against ``_verify_impl``: tokens and
    emitted counts equal, every emitted token allowed by its row, logits
    within 1e-5 at each real window position; mask zero afterwards."""
    jparams, _ = both_params
    jeng, eng = _engines(both_params, slots=3)
    rs = np.random.RandomState(8)
    prompts = [[1, 2, 3, 1, 2, 3, 1], [5, 9, 4, 4, 7, 1, 2, 3, 8, 11], [7, 7, 7]]
    sps = [SamplingParams(), SamplingParams(temperature=0.9, top_k=20, seed=21),
           SamplingParams(temperature=0.7, seed=5)]
    b, w, mb = 3, eng.spec_window, eng.max_blocks_per_seq
    blocks, first = _prefill_both(jeng, eng, prompts, sps, 12)
    tables = np.zeros((b, mb), np.int32)
    for i, bl in enumerate(blocks):
        tables[i, : len(bl)] = bl
    window = np.zeros((b, w), np.int32)
    window[:, 0] = first
    window[0, 1:3] = [2, 3]
    window[1, 1:5] = [9, 4, 4, 7]
    n_draft = np.asarray([2, 4, 0], np.int32)
    start = np.asarray([len(p) for p in prompts], np.int32)
    temps = np.asarray([sp.temperature for sp in sps], np.float32)
    top_ks = np.asarray([sp.top_k for sp in sps], np.int32)
    seeds = np.asarray([sp.seed for sp in sps], np.uint32)
    counts = np.ones((b,), np.int32)
    mask = np.zeros((b, w, V), np.float32)
    mask[0, :3] = _rows(rs, 3)
    mask[1, :5] = _rows(rs, 5, allowed=25)
    for i, j in ((0, 1), (0, 2), (1, 1), (1, 2)):
        mask[i, j, window[i, j]] = 0.0  # the grammar allows these drafts
    snap = (jeng.cache.k, jeng.cache.v)
    out, n = eng.verify(window, start, n_draft, tables, temps, top_ks, seeds, counts,
                        mask={(i, j): mask[i, j] for i in (0, 1) for j in range(w)
                              if mask[i, j].any()})
    assert _mask_is_zero(eng)
    jout, jn, jok, _, _ = jeng._verify_impl(
        jparams, jnp.asarray(window), jnp.asarray(start), jnp.asarray(n_draft), snap[0],
        snap[1], jnp.asarray(tables), jnp.asarray(temps), jnp.asarray(top_ks),
        jnp.zeros((b,), jnp.float32), jnp.asarray(seeds), jnp.asarray(counts),
        jnp.asarray(mask))
    np.testing.assert_array_equal(n, np.asarray(jn))
    for i in range(b):
        np.testing.assert_array_equal(out[i, : n[i]], np.asarray(jout)[i, : n[i]])
        for j in range(int(n[i])):
            assert mask[i, j, out[i, j]] == 0.0
    np.testing.assert_array_equal(eng.last_finite, np.asarray(jok))
    offs = np.arange(w)[None, :]
    pos = np.where(offs <= n_draft[:, None], start[:, None] + offs, -1)
    jl, _, _ = jdec.verify_step(jparams, jnp.asarray(window), jnp.asarray(pos), snap[0],
                                snap[1], jnp.asarray(tables))
    valid = pos >= 0
    np.testing.assert_allclose(eng.last_logits.numpy()[valid], (np.asarray(jl) + mask)[valid],
                               atol=LOGITS_ATOL, rtol=0)
    # one copy of the span (0, 0)..(1, w - 1): two slots' windows
    assert eng.trace_counts["verify"] == 1 and eng.mask_bytes_staged == 2 * w * V * 4


# ---------------------------------------------------------------------------
# the scheduler against JAX's (tests/test_constrained.py's cases)
# ---------------------------------------------------------------------------

_GRAMMARS = {}


def grammar(side, spec):
    """``spec`` compiled by ``side``'s package (once per side)."""
    key = (side.name, repr(spec))
    if key not in _GRAMMARS:
        mod = jcon if side is chaos.JAX else con
        _GRAMMARS[key] = mod.compile_response_format(spec, VOCAB)
    return _GRAMMARS[key]


# the constrained object request, an unconstrained companion, and a
# regex request sharing the first one's 11-token prompt (with the prefix
# cache on, its admission reuses the first block: a masked suffix prefill)
PROMPT = list(range(1, 12))
PROMPTS = [PROMPT, [4, 5], PROMPT + [3]]
FORMATS = [SPEC, None, REGEX]
ON_OFF = pytest.mark.parametrize("overlap", [True, False], ids=["on", "off"])


def _submit(formats):
    def submit(side, sched, i, prompt, sp):
        spec = formats[i]
        if spec is None:
            return sched.submit(prompt, sp)
        return sched.submit(prompt, sp, grammar=grammar(side, spec), response_format=spec)
    return submit


def _spec_default(k):
    """Scheduler kwargs making speculation at ``k`` every request's policy."""
    if not k:
        return None
    return lambda side, clock: {"speculation": side.SpeculationConfig(k=k)}


def run_case(sampling, *, overlap, spec_k=0, prefix_cache=False, prompts=PROMPTS,
             formats=FORMATS, **kw):
    """The case through both schedulers (streams and counters equal);
    returns (outcomes, counters, port engine, port scheduler)."""
    return chaos.both(prompts, sampling, overlap=overlap, submit=_submit(formats),
                      sched_kw=_spec_default(spec_k), prefix_cache=prefix_cache, cfg=CFG_KW,
                      **kw)


def _valid(outcomes, formats=FORMATS):
    for toks, spec in zip(outcomes, formats):
        if spec is None:
            continue
        text = con.decode_text(VOCAB, toks, None)
        if spec["type"] == "json_schema":
            assert con.validate_json(text, spec["json_schema"]) == [], text
        else:
            assert con.compile_regex(spec["pattern"], con.grammar_alphabet(VOCAB)).matches(
                text), text


_REF = {}


def _reference(name, sampling, spec_k=0):
    """The sequential run of ``sampling`` (named ``name``) with no prefix
    cache, speculating at ``spec_k``."""
    if (name, spec_k) not in _REF:
        _REF[(name, spec_k)] = run_case(sampling, overlap=False, spec_k=spec_k)[0]
    return _REF[(name, spec_k)]


@pytest.mark.parametrize("prefix_cache", [False, True], ids=["noprefix", "prefix"])
@pytest.mark.parametrize("spec_k", [0, 3], ids=["plain", "spec3"])
@ON_OFF
def test_greedy_streams_equal_jaxs_across_overlap_speculation_prefix(overlap, spec_k,
                                                                     prefix_cache):
    """Greedy constrained streams (and the companion) equal the JAX
    scheduler's in every configuration, equal each other across all of
    them, and parse as their grammar says; with the prefix cache on the
    regex request's admission is a masked suffix prefill."""
    sampling = dict(max_new_tokens=48)
    out, cnt, eng, sched = run_case(sampling, overlap=overlap, spec_k=spec_k,
                                    prefix_cache=prefix_cache)
    assert out == _reference("greedy", sampling)
    _valid(out)
    assert cnt["constrained"]["masked_steps"] > 0
    assert cnt["constrained"]["dead_end_failures"] == 0
    assert any(k.startswith("prefix_prefill") for k in eng.trace_counts) == prefix_cache
    assert (eng.trace_counts.get("verify", 0) == 1) == bool(spec_k)
    assert _mask_is_zero(eng)


@pytest.mark.parametrize("spec_k", [0, 3], ids=["plain", "spec3"])
@ON_OFF
def test_seeded_temperature_streams_equal_jaxs(overlap, spec_k):
    """Seeded temperature / top-k constrained streams equal the JAX
    scheduler's, and within one speculation setting are the same with the
    pipeline on and off."""
    sampling = [dict(max_new_tokens=40, temperature=0.9, top_k=20, seed=7),
                dict(max_new_tokens=40, temperature=0.9, seed=8),
                dict(max_new_tokens=40, temperature=0.8, top_k=50, seed=9)]
    out, _, _, _ = run_case(sampling, overlap=overlap, spec_k=spec_k)
    _valid(out)
    assert out == _reference("seeded", sampling, spec_k)


def test_constrained_traffic_adds_no_capture(both_params):
    """An engine warmed by unconstrained traffic on every step kind
    (prefill buckets, a suffix prefill, decode, verify) captures nothing
    new for constrained traffic, pipeline on and off, with speculation and
    without; its mask tensors stay where they were and end all zero."""
    _, params = both_params
    eng = GenerationEngine(params, TransformerConfig(**CFG_KW), max_batch_slots=3,
                           block_size=BLOCK, prompt_buckets=BUCKETS, device="cpu")
    ptrs = (eng._mask1.data_ptr(), eng._mask_dec.data_ptr())

    def serve(formats, overlap, k):
        sched = ContinuousBatchingScheduler(eng, overlap=overlap)
        speculation = SpeculationConfig(k=k) if k else None
        hs = [sched.submit(p, SamplingParams(max_new_tokens=24), speculation=speculation,
                           grammar=None if f is None else con.compile_response_format(
                               f, VOCAB)) for p, f in zip(PROMPTS, formats)]
        for _ in range(400):
            if all(h.done() for h in hs) or not sched.step():
                break
        return [h.result(timeout=0) for h in hs], sched

    for overlap, k in ((True, 0), (False, 3)):
        serve([None, None, None], overlap, k)
    before = dict(eng.trace_counts)
    assert {"decode", "verify"} <= set(before) and any(
        k.startswith("prefix_prefill") for k in before)
    for overlap, k in ((True, 0), (False, 3), (False, 0)):
        _, sched = serve(FORMATS, overlap, k)
        assert sched.constrained_stats.masked_steps > 0
    assert eng.trace_counts == before and eng.recompiles() == {}
    assert eng.masked_step_count > 0
    assert (eng._mask1.data_ptr(), eng._mask_dec.data_ptr()) == ptrs
    assert _mask_is_zero(eng)
    eng.reset()
    assert (eng._mask1.data_ptr(), eng._mask_dec.data_ptr()) == ptrs


@ON_OFF
def test_crash_replay_is_byte_exact_and_equals_jaxs(overlap):
    """A double decode-step fault mid-stream (retry, then reset + journal
    replay): the automata are rebuilt by re-advancing over the journaled
    tokens through the mask_advance site, and every stream equals the
    fault-free one and JAX's, with the same recovery counters."""
    sampling = dict(max_new_tokens=40)
    ref = _reference("greedy40", sampling)

    def plan(side):
        return side.faults.FaultPlan(seed=0).on(
            "generation.decode_step", mode="error",
            error=RuntimeError("injected device crash"), nth=(2, 3))

    out, cnt, eng, _ = run_case(sampling, overlap=overlap, plan=plan)
    assert out == ref
    _valid(out)
    assert cnt["recovery"]["recoveries"] == 1 and cnt["recovery"]["replayed_tokens"] > 0
    assert cnt["sites"]["generation.decode_step"]["fires"] == 2
    # the replay re-advanced the automata: more advances than tokens
    n_constrained = sum(len(o) for o, f in zip(out, FORMATS) if f is not None)
    assert cnt["sites"]["generation.mask_advance"]["calls"] > n_constrained
    assert _mask_is_zero(eng)


@ON_OFF
def test_unconstrained_companion_is_unaffected(overlap):
    """The companion's stream is the same alone and beside constrained
    requests, in both packages."""
    sampling = dict(max_new_tokens=24)
    solo, _, _, _ = run_case(sampling, overlap=overlap, prompts=[[4, 5]], formats=[None])
    mixed, _, _, _ = run_case(sampling, overlap=overlap)
    assert mixed[1] == solo[0]


@ON_OFF
def test_mask_advance_fault_quarantines_one_slot(overlap):
    """A mask_advance error fails only the constrained request it hits,
    typed step='mask'; the others stream as without the plan; counters
    (dead ends, quarantines, site calls and fires) equal JAX's."""
    sampling = dict(max_new_tokens=24)
    ref, _, _, _ = run_case(sampling, overlap=overlap)

    def plan(side):
        return side.faults.FaultPlan(seed=0).on(
            "generation.mask_advance", mode="error",
            error=RuntimeError("injected advance fault"), nth=(5,))

    out, cnt, eng, _ = run_case(sampling, overlap=overlap, plan=plan)
    failed = [i for i, o in enumerate(out) if isinstance(o, tuple)]
    assert len(failed) == 1 and FORMATS[failed[0]] is not None
    assert out[failed[0]] == ("PoisonedRequestError", "mask", "mask_advance")
    assert [o for i, o in enumerate(out) if i not in failed] == [
        r for i, r in enumerate(ref) if i not in failed]
    assert cnt["constrained"]["dead_end_failures"] == 1
    assert cnt["recovery"]["quarantined"] == 1
    assert cnt["sites"]["generation.mask_advance"]["fires"] == 1
    assert eng.allocator.num_free == eng.allocator.num_total
    assert _mask_is_zero(eng)


def test_mask_advance_fault_at_readmission_fails_one_request():
    """A preempted constrained stream rebuilds its automaton at
    re-admission; an advance fault there fails that request alone, before
    any prefill, as in JAX."""
    sampling = dict(max_new_tokens=20)

    def steer(side, sched, handles):
        for _ in range(4):
            sched.step()
        sched._drain_frontier("test")
        victim = next(s for s in sched._running.values() if s.req.grammar is not None)
        sched._preempt_self(victim)
        plan = side.faults.FaultPlan(seed=0).on(
            "generation.mask_advance", mode="error", error=RuntimeError("replay"), nth=(0,))
        with plan.active():
            sched.step()
        chaos.drive(sched, handles)

    out, cnt, _, _ = run_case(sampling, overlap=False, steer=steer,
                              prompts=PROMPTS[:2], formats=FORMATS[:2])
    assert out[0] == ("PoisonedRequestError", "mask", "mask_advance")
    assert isinstance(out[1], list) and len(out[1]) == 20
    assert cnt["constrained"]["dead_end_failures"] == 1 and cnt["preemptions"] == 1


def test_grammar_vocabulary_mismatch_is_refused_at_submit():
    """A grammar compiled on another vocabulary never reaches the queue,
    in either package."""
    for side in (chaos.JAX, chaos.PORT):
        eng, _ = chaos.engine(side, cfg=CFG_KW)
        sched = side.Scheduler(eng)
        mod = jcon if side is chaos.JAX else con
        wrong = mod.compile_response_format(SPEC, mod.default_vocabulary(49))
        with pytest.raises(ValueError, match="vocab"):
            sched.submit([1, 2], side.SamplingParams(max_new_tokens=4), grammar=wrong)
        assert not sched.has_work()


def test_exhausted_grammar_ends_the_stream_without_eos():
    """A grammar with one word ends its stream when the word is complete
    (the budget is clamped), and a grammar allowing EOS at its end may
    finish on EOS; both as in JAX."""
    formats = [{"type": "regex", "pattern": "(yes|no)"}, None]
    out, cnt, _, _ = run_case(dict(max_new_tokens=12), overlap=True, prompts=[[1, 2, 3], [4]],
                              formats=formats)
    assert con.decode_text(VOCAB, out[0], None) in ("yes", "no")
    out_eos, _, _, _ = run_case(dict(max_new_tokens=48, eos_id=EOS), overlap=False,
                                prompts=[[1, 2, 3], [4]], formats=[SPEC, None])
    text = con.decode_text(VOCAB, out_eos[0], EOS)
    assert con.validate_json(text, SCHEMA) == [], text
