"""The port's overlapped decode pipeline against the JAX scheduler's
(the mirror of ``tests/test_overlap.py``).

Every case runs through the JAX package's scheduler and the port's with
the pipeline on and off, and the port's streams AND counters (engine
resets, recovery stats, pipeline dispatches, drains by reason, discards,
the fault plan's calls and fires per site) must equal JAX's under the
same plan (``torch_port_chaos.both``). On the CPU a pipelined dispatch
runs its step at once and its consume returns the result, so these
cases exercise the pipeline's semantics; the card-only cases (two steps
in flight, buffers not clobbered, token carry) are in
``test_torch_port_cuda.py``.
"""
import numpy as np
import pytest
import torch

from torch_port_chaos import BLOCK, JAX, PORT, both, drive, run

pytestmark = pytest.mark.torch_port

# prompts straddle bucket boundaries (7/8, 15/16/17) and max_new crosses
# block boundaries (cached_len passes multiples of BLOCK mid-stream)
MATRIX_PROMPTS = [
    [1, 2, 3, 4, 5, 6, 7],
    [9, 8, 7, 6, 5, 4, 3, 2],
    list(range(11, 26)),
    list(range(30, 47)),
]
ON_OFF = pytest.mark.parametrize("overlap", [True, False], ids=["on", "off"])


@ON_OFF
@pytest.mark.parametrize("sampling", [
    dict(max_new_tokens=14),
    dict(max_new_tokens=14, temperature=0.8, top_k=8, seed=7),
    dict(max_new_tokens=11, temperature=0.5, seed=123),
], ids=["greedy", "temp_topk", "temp"])
def test_exactness_matrix_matches_jax(overlap, sampling):
    out, cnt, eng, _ = both(MATRIX_PROMPTS, sampling, overlap=overlap)
    assert all(isinstance(o, list) and len(o) == sampling["max_new_tokens"] for o in out)
    if overlap:
        assert cnt["pipe_dispatches"] > 0, "pipeline never engaged"
    # the token carry and the double buffers add no capture
    assert eng.trace_counts["decode"] == 1 and eng.recompiles() == {}


def test_streams_equal_with_overlap_on_and_off():
    on, _, _, _ = run(PORT, MATRIX_PROMPTS, dict(max_new_tokens=14, temperature=0.8, top_k=8,
                                                 seed=7), overlap=True)
    off, _, _, _ = run(PORT, MATRIX_PROMPTS, dict(max_new_tokens=14, temperature=0.8, top_k=8,
                                                  seed=7), overlap=False)
    assert on == off


@ON_OFF
def test_mixed_plain_and_speculative_batch(overlap):
    """A speculating request forces the sequential verify path for the
    whole batch (a non-steady drain); after it finishes the plain one
    pipelines again."""

    def submit(side, sched, i, prompt, sp):
        spec = side.SpeculationConfig(k=3, method="ngram") if i == 0 else None
        return sched.submit(prompt, sp, speculation=spec)

    out, cnt, eng, _ = both([[1, 2, 3] * 5, [11, 12, 13, 14]],
                            [dict(max_new_tokens=6), dict(max_new_tokens=16)],
                            overlap=overlap, submit=submit)
    assert eng.step_counts["verify"] > 0
    if overlap:
        assert cnt["pipe_dispatches"] > 0


@ON_OFF
def test_speculative_streams(overlap):
    both([[1, 2, 3] * 6, [4, 5] * 8, [7, 8, 9, 7, 8, 9, 7, 8, 9]], dict(max_new_tokens=18),
         overlap=overlap, spec=dict(k=3, method="ngram"))


# ---------------------------------------------------------------- drains
@ON_OFF
def test_drains_on_eos(overlap):
    base, _, _, _ = run(JAX, MATRIX_PROMPTS, dict(max_new_tokens=24), overlap=False)
    # an EOS token that occurs mid-stream but never in a stream's first
    # tokens: it fires while the pipeline is live
    early = {t for o in base for t in o[:3]}
    eos = int([t for o in base for t in o[3:] if t not in early][0])
    out, cnt, _, _ = both(MATRIX_PROMPTS, dict(max_new_tokens=24, eos_id=eos), overlap=overlap)
    assert any(len(o) < 24 for o in out), "EOS never fired"
    if overlap:
        assert cnt["pipe_drains"].get("finish", 0) + cnt["pipe_drains"].get("nonsteady", 0) >= 1


@ON_OFF
def test_drains_on_preemption(overlap):
    """A tight cache: growth fails mid-stream, the frontier drains on
    pressure, and preempt-by-recompute resumes the streams exactly."""
    out, cnt, _, _ = both([[1, 2, 3, 4, 5, 6, 7, 8], [9, 10, 11, 12, 13, 14], [20, 21, 22, 23]],
                          dict(max_new_tokens=30), overlap=overlap, num_blocks=14)
    assert cnt["preemptions"] >= 1
    if overlap:
        assert cnt["pipe_drains"].get("pressure", 0) >= 1


@ON_OFF
def test_drains_on_quarantine(overlap):
    """Per-slot NaN poison with the pipeline live: the blamed request is
    quarantined alone and the tainted frontier is discarded."""

    def plan(side):
        return side.faults.FaultPlan(seed=0).on(
            "generation.decode_step", mode="nan", nth=(3,),
            select=lambda v: np.asarray([True, False, False]))

    out, cnt, eng, _ = both([[1, 2, 3, 4], [7, 8, 9], [11, 12, 13, 14, 15]],
                            dict(max_new_tokens=10), overlap=overlap, plan=plan)
    assert ("PoisonedRequestError", "decode", "nan_logits") in out
    assert cnt["recovery"]["quarantined"] == 1 and cnt["resets"] == 0
    assert eng.allocator.num_free == eng.allocator.num_total


@ON_OFF
def test_drains_on_cancel(overlap):
    def steer(side, sched, handles):
        for _ in range(6):
            sched.step()
        handles[0].cancel()
        drive(sched, handles)

    out, cnt, eng, sched = both([[1, 2, 3, 4, 5], [9, 8, 7]], dict(max_new_tokens=20),
                                overlap=overlap, steer=steer)
    assert out[0][0] == "ShuttingDownError" and len(out[1]) == 20
    assert sched.stats.get("cancelled") == 1
    assert eng.allocator.num_free == eng.allocator.num_total


@ON_OFF
def test_drains_on_deadline(overlap):
    """A deadline that expires mid-generation on the virtual clock."""

    def submit(side, sched, i, prompt, sp):
        return sched.submit(prompt, sp, deadline_s=5.5 if i == 0 else None)

    def steer(side, sched, handles):
        for _ in range(2000):
            if all(h.done() for h in handles):
                return
            sched.step()
            sched.clock.advance(1.0)

    out, _, eng, _ = both([[1, 2, 3, 4, 5], [9, 8, 7], [4, 4, 4, 4]], dict(max_new_tokens=16),
                          overlap=overlap, submit=submit, steer=steer)
    assert out[0][0] == "DeadlineExceededError" and len(out[1]) == 16
    assert eng.allocator.num_free == eng.allocator.num_total


# ----------------------------------------------------- faults mid-flight
@ON_OFF
def test_transient_fault_is_absorbed_by_retry(overlap):
    def plan(side):
        return side.faults.FaultPlan(seed=0).on(
            "generation.decode_step", mode="error",
            error=side.faults.TransientDeviceError, nth=(5,))

    def sched_kw(side, clock):
        return {"retry": side.resilience.RetryPolicy(max_attempts=3, sleep=lambda _s: None)}

    out, cnt, _, _ = both(MATRIX_PROMPTS, dict(max_new_tokens=12), overlap=overlap, plan=plan,
                          sched_kw=sched_kw)
    assert cnt["sites"]["generation.decode_step"]["fires"] == 1
    assert cnt["resets"] == 0
    assert out == run(PORT, MATRIX_PROMPTS, dict(max_new_tokens=12), overlap=False)[0]


@ON_OFF
def test_hard_crash_replays_from_the_journal(overlap):
    def plan(side):
        return side.faults.FaultPlan(seed=0).on(
            "generation.decode_step", mode="error", error=RuntimeError("device crash"),
            nth=(4, 5))

    out, cnt, _, _ = both(MATRIX_PROMPTS, dict(max_new_tokens=12), overlap=overlap, plan=plan)
    assert cnt["resets"] >= 1 and cnt["recovery"]["recoveries"] >= 1
    assert out == run(PORT, MATRIX_PROMPTS, dict(max_new_tokens=12), overlap=False)[0]


@ON_OFF
def test_donating_engine_resets_and_replays_a_crash(overlap):
    """``donate`` (the card's default) skips retry and bisection: a
    crashed step resets the engine and replays the journal, as the JAX
    engine does with ``donate_cache=True``."""

    def plan(side):
        return side.faults.FaultPlan(seed=0).on(
            "generation.decode_step", mode="error", error=RuntimeError("device crash"),
            nth=(4,))

    out, cnt, eng, _ = both(MATRIX_PROMPTS, dict(max_new_tokens=12), overlap=overlap,
                            plan=plan, donate=True)
    assert eng.donate and cnt["resets"] == 1 and cnt["recovery"]["step_retries"] == 0
    assert out == run(PORT, MATRIX_PROMPTS, dict(max_new_tokens=12), overlap=False)[0]


@ON_OFF
def test_async_readback_fault_recovers_exactly(overlap):
    def plan(side):
        return side.faults.FaultPlan(seed=0).on(
            "generation.async_readback", mode="error",
            error=side.faults.FaultInjected("readback lost"), nth=(2,))

    out, cnt, _, _ = both(MATRIX_PROMPTS, dict(max_new_tokens=12), overlap=overlap, plan=plan)
    assert cnt["sites"]["generation.async_readback"]["fires"] == (1 if overlap else 0)
    assert cnt["recovery"]["quarantined"] == 0
    assert out == run(PORT, MATRIX_PROMPTS, dict(max_new_tokens=12), overlap=False)[0]


def _live_kv(eng, sched):
    """Each running stream's K and V over its live positions, gathered
    through its block table, keyed by its prompt."""
    out = {}
    for s in sched._running.values():
        pos = torch.arange(s.cached_len)
        blocks = torch.tensor(s.blocks)[pos // BLOCK]
        out[tuple(s.req.original_prompt)] = (
            list(s.req.generated),
            eng.cache.k[:, blocks, pos % BLOCK].clone(),
            eng.cache.v[:, blocks, pos % BLOCK].clone(),
        )
    return out


def test_fault_at_consume_needs_no_rollback():
    """The cache is written in place, so a discarded in-flight step is
    not rolled back: a fault at the pipeline's consume must leave the
    same streams AND the same K/V over every live position as the
    sequential run at the same point."""
    prompts = MATRIX_PROMPTS[:3]
    sp = dict(max_new_tokens=24, temperature=0.8, top_k=8, seed=3)
    kv = {}

    def least(sched):
        return min((s.req.n_generated for s in sched._running.values()), default=0)

    def steer(side, sched, handles):
        if sched.overlap:
            for _ in range(200):
                if least(sched) >= 12:
                    break
                sched.step()
            sched._drain_frontier("checkpoint")
            kv["at"] = {s.req.n_generated for s in sched._running.values()}
            kv["on"] = _live_kv(sched.engine, sched)
        else:
            (g,) = kv["at"]
            for _ in range(200):
                if least(sched) >= g:
                    break
                sched.step()
            kv["off"] = _live_kv(sched.engine, sched)

    def plan(side):
        return side.faults.FaultPlan(seed=0).on(
            "generation.async_readback", mode="error",
            error=side.faults.FaultInjected("readback lost"), nth=(3,))

    _, cnt, _, _ = run(PORT, prompts, sp, overlap=True, plan=plan, steer=steer)
    assert cnt["sites"]["generation.async_readback"]["fires"] == 1
    assert cnt["pipe_discards"] >= 1
    run(PORT, prompts, sp, overlap=False, steer=steer)
    assert kv["on"].keys() == kv["off"].keys() and len(kv["on"]) == 3
    for key, (gen, k, v) in kv["on"].items():
        gen_off, k_off, v_off = kv["off"][key]
        assert gen == gen_off
        assert torch.equal(k, k_off) and torch.equal(v, v_off)


@ON_OFF
def test_whole_batch_nan_restarts_and_replays(overlap):
    def plan(side):
        return side.faults.FaultPlan(seed=0).on("generation.decode_step", mode="nan", nth=(3,))

    out, cnt, _, _ = both(MATRIX_PROMPTS, dict(max_new_tokens=10), overlap=overlap, plan=plan)
    assert cnt["resets"] >= 1 and cnt["recovery"]["quarantined"] == 0
    assert out == run(PORT, MATRIX_PROMPTS, dict(max_new_tokens=10), overlap=False)[0]


# ------------------------------------------------ watchdog heartbeats
@ON_OFF
def test_watchdog_not_tripped_by_long_pipelined_steps(overlap):
    """The heartbeat is stamped at dispatch AND at the predecessor's
    completion, so an in-flight step's age is its own device time: many
    steps each under the timeout never trip, though their sum is far
    over it."""

    def sched_kw(side, clock):
        return {"watchdog": side.recovery.WatchdogPolicy(enabled=True, stall_timeout_s=10.0)}

    def steer(side, sched, handles):
        for _ in range(2000):
            if all(h.done() for h in handles):
                return
            sched.step()
            sched.clock.advance(6.0)
            sched.watchdog.check()

    out, cnt, _, _ = both([[1, 2, 3, 4, 5]], dict(max_new_tokens=16), overlap=overlap,
                          sched_kw=sched_kw, steer=steer)
    assert cnt["recovery"]["watchdog_trips"] == 0 and len(out[0]) == 16


def test_watchdog_trips_on_a_wedged_inflight_step():
    """An in-flight step older than the stall timeout trips the
    watchdog; its consume discards the late result and the stream
    journal-replays exactly."""

    def sched_kw(side, clock):
        return {"watchdog": side.recovery.WatchdogPolicy(enabled=True, stall_timeout_s=10.0)}

    def steer(side, sched, handles):
        for _ in range(3):
            sched.step()
        assert sched._pipe is not None, "pipeline did not engage"
        sched.clock.advance(11.0)
        assert sched.watchdog.check() is True
        drive(sched, handles)

    out, cnt, _, _ = both([[1, 2, 3, 4, 5]], dict(max_new_tokens=12), overlap=True,
                          sched_kw=sched_kw, steer=steer)
    assert cnt["recovery"]["watchdog_trips"] == 1 and cnt["resets"] >= 1
    assert out == run(PORT, [[1, 2, 3, 4, 5]], dict(max_new_tokens=12), overlap=False)[0]
