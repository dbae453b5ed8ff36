#!/usr/bin/env python
"""Victim half of chaoscheck's durable SIGKILL scenario (port of the JAX
package's ``tools/_durable_child.py``).

Run as ``python -m flexflow_tpu_torch.tools._durable_child WAL_DIR
[--device cpu]``. Builds the same deterministic tiny engine the parent
sweep uses (same seeded weights, same config — so the parent's warm
restart passes the fingerprint gate and the recompute is byte-exact),
attaches a fsync'ing Durability, submits the four-way request mix
(greedy, seeded-temperature, speculative, constrained), and decodes
SLOWLY — one scheduler step per ~50 ms, with a ``TOK <n>`` progress line
after each group commit — until the parent SIGKILLs it mid-decode.
Process death IS the test: nothing here traps signals or flushes on
exit; whatever survived is whatever the WAL's per-step group commit made
durable.

The module doubles as the mix's single source of truth: the parent sweep
imports ``build_cfg`` / ``build_engine`` / ``submit_mix`` / ``SCHEMA`` so
the uninterrupted reference run and the post-kill replay are the same
requests, not a parallel copy that could drift.
"""
import argparse
import sys
import time

SCHEMA = {
    "type": "object",
    "properties": {"ok": {"type": "boolean"}, "n": {"type": "integer"}},
}
SPEC = {"type": "json_schema", "json_schema": SCHEMA}

# prompts keyed by stream kind; distinct so the parent can match the
# replayed streams back to the reference by prompt alone
PROMPTS = {
    "greedy": [1, 2, 3],
    "seeded": [4, 5, 6, 7],
    "speculative": [9, 8, 7, 6, 5],
    "constrained": [2, 4, 6],
}


def build_cfg():
    from flexflow_tpu_torch.models.transformer import TransformerConfig

    return TransformerConfig(
        num_layers=2, hidden_size=32, num_heads=4, ff_size=64,
        seq_length=64, vocab_size=50, causal=True,
    )


def build_engine(cfg, device=None):
    from flexflow_tpu_torch.generation import GenerationEngine
    from flexflow_tpu_torch.tools._common import seeded_params

    return GenerationEngine(seeded_params(cfg), cfg, max_batch_slots=4, block_size=8,
                            device=device)


def submit_mix(sched, grammar_cache):
    """The four-way durability mix: every stream kind whose replay has
    its own byte-exactness hazard (argmax ties, seeded key fold-in,
    draft-window acceptance, automaton re-advance)."""
    from flexflow_tpu_torch.generation import SamplingParams, SpeculationConfig

    return [
        sched.submit(PROMPTS["greedy"], SamplingParams(max_new_tokens=12)),
        sched.submit(
            PROMPTS["seeded"],
            SamplingParams(max_new_tokens=12, temperature=0.8, top_k=10, seed=7),
        ),
        sched.submit(
            PROMPTS["speculative"], SamplingParams(max_new_tokens=12),
            speculation=SpeculationConfig(k=2),
        ),
        sched.submit(
            PROMPTS["constrained"], SamplingParams(max_new_tokens=40),
            grammar=grammar_cache.get(SPEC), response_format=SPEC,
        ),
    ]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="chaoscheck's durable SIGKILL victim")
    ap.add_argument("wal_dir")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)

    from flexflow_tpu_torch.generation import ContinuousBatchingScheduler
    from flexflow_tpu_torch.generation.constrained import GrammarCache, default_vocabulary
    from flexflow_tpu_torch.serving.durable import Durability, DurabilityConfig

    cfg = build_cfg()
    eng = build_engine(cfg, args.device)
    sched = ContinuousBatchingScheduler(eng)
    cache = GrammarCache(default_vocabulary(cfg.vocab_size))
    Durability(sched, DurabilityConfig(wal_dir=args.wal_dir), grammar_cache=cache)
    handles = submit_mix(sched, cache)
    print("READY", flush=True)
    while not all(h.done() for h in handles):
        sched.step()
        total = sum(len(h._request.generated) for h in handles)
        print(f"TOK {total}", flush=True)
        time.sleep(0.05)
    # only reached if the parent never kills us — it treats this as a
    # scenario failure (the kill was supposed to land mid-decode)
    print("DONE", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
