"""The port's self-healing layer against the JAX scheduler's (the mirror
of ``tests/test_recovery.py``): journal-replay recovery, quarantine, the
step watchdog, the restart budget, shutdown and admission-time NaN.

Every case runs through the JAX package's scheduler and the port's with
the overlap pipeline on and off, and the port's streams AND counters
(engine resets, recovery stats, pipeline dispatches/drains/discards,
the plan's calls and fires per site) must equal JAX's under the same
plan (``torch_port_chaos.both``). The engines keep the prefix cache on,
as ``test_recovery.py``'s do.
"""
import threading
import time

import numpy as np
import pytest

from torch_port_chaos import JAX, PORT, both, drive, run

pytestmark = pytest.mark.torch_port

PROMPTS = [[1, 2, 3], [4, 5, 6, 7], [9, 8, 7, 6, 5]]
ON_OFF = pytest.mark.parametrize("overlap", [True, False], ids=["on", "off"])
CACHE = dict(prefix_cache=True)


def crash(nth, site="generation.decode_step"):
    def plan(side):
        return side.faults.FaultPlan(seed=0).on(
            site, mode="error", error=RuntimeError("device crash"), nth=nth)
    return plan


def unique_token(streams, idx):
    """A token of streams[idx][:-1] that no other stream holds: it feeds a
    later step of exactly that request."""
    others = {t for j, s in enumerate(streams) if j != idx for t in s[:-1]}
    return [t for t in streams[idx][:-1] if t not in others][0]


# ----------------------------------------------- journal-replay recovery
@ON_OFF
@pytest.mark.parametrize("sampling", [
    dict(max_new_tokens=12),
    dict(max_new_tokens=10, temperature=0.8, top_k=10, seed=42),
], ids=["greedy", "seeded"])
def test_crash_replays_exactly(overlap, sampling):
    """A mid-stream crash that survives the step retry resets the engine
    and replays every stream token for token, across a block boundary."""
    ref = run(PORT, PROMPTS, sampling, overlap=False, **CACHE)[0]
    out, cnt, eng, sched = both(PROMPTS, sampling, overlap=overlap, plan=crash((3, 4)),
                                **CACHE)
    assert out == ref
    assert cnt["recovery"]["recoveries"] == 1 and cnt["resets"] == 1
    assert cnt["recovery"]["replayed_tokens"] > 0
    used = eng.allocator.num_total - eng.allocator.num_free
    assert used == eng.prefix_cache.resident_blocks and len(sched.journal) == 0


@ON_OFF
def test_crash_on_verify_replays_speculative_streams(overlap):
    prompts = [[1, 2, 3, 1, 2, 3], [5, 6, 5, 6, 5, 6, 5]]
    spec = dict(k=3, method="ngram")
    ref = run(PORT, prompts, dict(max_new_tokens=12), overlap=False, spec=spec, **CACHE)[0]
    out, cnt, _, _ = both(prompts, dict(max_new_tokens=12), overlap=overlap, spec=spec,
                          plan=crash((2, 3), "generation.verify"), **CACHE)
    assert out == ref and cnt["recovery"]["recoveries"] == 1


@ON_OFF
def test_supervisor_absorbs_a_single_crash(overlap):
    ref = run(PORT, PROMPTS, dict(max_new_tokens=8), overlap=False, **CACHE)[0]
    out, cnt, _, _ = both(PROMPTS, dict(max_new_tokens=8), overlap=overlap, plan=crash((2,)),
                          **CACHE)
    assert out == ref
    assert cnt["recovery"]["step_retries"] == 1 and cnt["resets"] == 0


@ON_OFF
def test_double_fault_during_replay_consumes_budget(overlap):
    def plan(side):
        return crash((3, 4))(side).on(
            "generation.journal_replay", mode="error",
            error=RuntimeError("crash during replay"), nth=(0,))

    ref = run(PORT, PROMPTS, dict(max_new_tokens=10), overlap=False, **CACHE)[0]
    out, cnt, _, sched = both(PROMPTS, dict(max_new_tokens=10), overlap=overlap, plan=plan,
                              **CACHE)
    assert out == ref
    assert cnt["sites"]["generation.journal_replay"]["fires"] == 1
    assert cnt["recovery"]["recoveries"] == 1
    assert len(sched.supervisor._restart_times) == 2  # two budget units


# ---------------------------------------------------------- quarantine
@ON_OFF
def test_nan_quarantine_blames_one_slot(overlap):
    ref = run(JAX, PROMPTS, dict(max_new_tokens=10), overlap=False, **CACHE)[0]
    tok = unique_token(ref, 1)

    def plan(side):
        return side.faults.FaultPlan(seed=0).on(
            "generation.decode_step", mode="nan",
            when=lambda v: bool((np.asarray(v[0]) == tok).any()),
            select=lambda v: np.asarray(v[0]) == tok)

    out, cnt, eng, _ = both(PROMPTS, dict(max_new_tokens=10), overlap=overlap, plan=plan,
                            **CACHE)
    assert out[1] == ("PoisonedRequestError", "decode", "nan_logits")
    assert out[0] == ref[0] and out[2] == ref[2]
    assert cnt["recovery"]["quarantined"] == 1 and cnt["resets"] == 0


@ON_OFF
def test_whole_batch_nan_restarts_instead_of_quarantine(overlap):
    def plan(side):
        return side.faults.FaultPlan(seed=0).on("generation.decode_step", mode="nan", nth=(2,))

    ref = run(PORT, PROMPTS, dict(max_new_tokens=10), overlap=False, **CACHE)[0]
    out, cnt, _, _ = both(PROMPTS, dict(max_new_tokens=10), overlap=overlap, plan=plan,
                          **CACHE)
    assert out == ref
    assert cnt["recovery"]["quarantined"] == 0 and cnt["resets"] == 1


@ON_OFF
def test_nan_quarantine_on_a_verify_window(overlap):
    prompts = [[1, 2, 3, 1, 2, 3], [5, 6, 5, 6, 5, 6, 5]]
    spec = dict(k=3, method="ngram")
    ref = run(JAX, prompts, dict(max_new_tokens=10), overlap=False, spec=spec, **CACHE)[0]
    excluded = set(ref[1]) | {t for p in prompts for t in p}
    tok = [t for t in ref[0][:-1] if t not in excluded][0]

    def plan(side):
        return side.faults.FaultPlan(seed=0).on(
            "generation.verify", mode="nan",
            when=lambda v: bool((np.asarray(v[0]) == tok).any()),
            select=lambda v: np.asarray(v[0]) == tok)  # [B, W]

    out, cnt, _, _ = both(prompts, dict(max_new_tokens=10), overlap=overlap, spec=spec,
                          plan=plan, **CACHE)
    assert out[0] == ("PoisonedRequestError", "verify", "nan_logits") and out[1] == ref[1]
    assert cnt["recovery"]["quarantined"] == 1


@ON_OFF
def test_crash_bisection_quarantines_the_poisoned_request(overlap):
    """A crash keyed on one request's data: bisection probes isolate it;
    it fails alone with the original error, the survivors (deactivated
    in some probe, so a probe writing into their blocks would show)
    finish exactly."""
    ref = run(JAX, PROMPTS, dict(max_new_tokens=10), overlap=False, **CACHE)[0]
    tok = unique_token(ref, 1)

    def plan(side):
        return side.faults.FaultPlan(seed=0).on(
            "generation.decode_step", mode="error", error=RuntimeError("poisoned-input crash"),
            when=lambda v: bool((np.asarray(v[0]) == tok).any()))

    out, cnt, eng, _ = both(PROMPTS, dict(max_new_tokens=10), overlap=overlap, plan=plan,
                            **CACHE)
    assert out[1] == ("RuntimeError", None, None)
    assert out[0] == ref[0] and out[2] == ref[2]
    assert cnt["recovery"]["quarantined"] == 1 and cnt["resets"] == 0


# ------------------------------------------------------------ watchdog
@ON_OFF
def test_watchdog_trips_reaps_deadlines_and_replays(overlap):
    """A decode step wedged on a gate: the watchdog trips the breaker,
    fails a deadline-expired queued request while the loop thread is
    stuck, and once the step returns its stale result is discarded for
    an exact journal replay."""
    gates = {}

    def plan(side):
        gates[side.name] = threading.Event()
        return side.faults.FaultPlan(seed=0).on(
            "generation.decode_step", mode="stall", gate=gates[side.name], nth=(2,))

    def sched_kw(side, clock):
        return {"watchdog": side.recovery.WatchdogPolicy(stall_timeout_s=5.0, poll_s=0.01)}

    def submit(side, sched, i, prompt, sp):
        return sched.submit(prompt, sp, deadline_s=3.0 if i == 2 else None)  # queued: 2 slots

    def steer(side, sched, handles):
        worker = threading.Thread(target=drive, args=(sched, handles, 200), daemon=True)
        worker.start()
        plan_ = side.faults.active_plan()
        t0 = time.monotonic()
        while plan_.calls("generation.decode_step") < 3 or sched._heartbeat is None:
            assert time.monotonic() - t0 < 30, "the worker never reached the stall"
            time.sleep(0.001)
        sched.clock.advance(6.0)  # past the deadline AND the stall timeout
        assert sched.watchdog.check() is True
        assert not sched.ready()  # breaker OPEN while the step hangs
        assert handles[2].done()  # reaped mid-stall
        assert sched.watchdog.check() is False  # one trip per step
        gates[side.name].set()
        worker.join(timeout=30)
        assert not worker.is_alive()
        assert sched.ready()  # the recovery closed the breaker

    ref = run(PORT, PROMPTS[:2], dict(max_new_tokens=10), overlap=False, slots=2, **CACHE)[0]
    out, cnt, eng, _ = both(PROMPTS, dict(max_new_tokens=10), overlap=overlap, plan=plan,
                            sched_kw=sched_kw, submit=submit, steer=steer, slots=2, **CACHE)
    assert out[:2] == ref and out[2][0] == "DeadlineExceededError"
    assert cnt["recovery"]["watchdog_trips"] == 1 and cnt["recovery"]["recoveries"] == 1


# ---------------------------------------------- restart budget, shutdown
@ON_OFF
def test_budget_exhaustion_fails_running_typed_and_holds_the_queue(overlap):
    """A persistently failing engine exhausts its restart budget: running
    streams fail with EngineFailedError, the breaker opens, and the
    queued request is HELD; once the fault clears and the recovery window
    passes, the half-open probe admits it and it completes."""

    def plan(side):
        return side.faults.FaultPlan(seed=0).on(
            "generation.decode_step", mode="error", error=RuntimeError("device is gone"),
            every=1)

    def sched_kw(side, clock):
        return {"breaker": side.resilience.CircuitBreaker(failure_threshold=5, recovery_s=30.0,
                                                          clock=clock),
                "recovery": side.no_sleep(max_restarts=2)}

    def steer(side, sched, handles):
        drive(sched, handles[:2])
        assert not sched.ready() and not handles[2].done()
        with side.faults.FaultPlan(seed=0).active():  # the fault cleared
            sched.clock.advance(31.0)
            drive(sched, handles[2:])
        assert sched.breaker.state == "closed"

    ref = run(PORT, [PROMPTS[2]], dict(max_new_tokens=6), overlap=False, slots=2, **CACHE)[0]
    out, cnt, _, _ = both(PROMPTS, dict(max_new_tokens=6), overlap=overlap, plan=plan,
                          sched_kw=sched_kw, steer=steer, slots=2, **CACHE)
    assert out[0][0] == out[1][0] == "EngineFailedError"
    assert out[2] == ref[0]
    assert cnt["recovery"]["engine_failures"] == 1 and cnt["recovery"]["recoveries"] == 2


@ON_OFF
def test_stop_fails_queued_requests_typed(overlap):
    def steer(side, sched, handles):
        sched.stop(drain=False)

    out, _, _, _ = both([PROMPTS[0]], dict(max_new_tokens=4), overlap=overlap, steer=steer,
                        slots=1, **CACHE)
    assert out == [("ShuttingDownError", None, None)]


@ON_OFF
def test_start_and_draining_stop_run_the_loop_thread(overlap):
    """``start()`` serves from a background thread (with the watchdog);
    ``stop(drain=True)`` finishes the outstanding work, and a stopped
    scheduler rejects new submits."""

    def steer(side, sched, handles):
        sched.start()
        handles[0].result(timeout=60)
        sched.stop(drain=True)
        assert all(h.done() for h in handles)
        with pytest.raises(side.resilience.ShuttingDownError):
            sched.submit([1, 2], side.SamplingParams())

    ref = run(PORT, PROMPTS, dict(max_new_tokens=9), overlap=False, **CACHE)[0]
    out, _, _, _ = both(PROMPTS, dict(max_new_tokens=9), overlap=overlap, steer=steer,
                        **CACHE)
    assert out == ref


# ---------------------------------------------------- admission-time NaN
@ON_OFF
def test_prefill_nan_is_quarantined_at_admission(overlap):
    """Non-finite prefill logits (NaN weights) quarantine the request
    before it ever holds a slot."""
    out, cnt, eng, _ = both([PROMPTS[0]], dict(max_new_tokens=4), overlap=overlap, nan=True,
                            slots=2, **CACHE)
    assert out == [("PoisonedRequestError", "prefill", "nan_logits")]
    assert cnt["recovery"]["quarantined"] == 1 and cnt["resets"] == 0
    assert eng.allocator.num_free == eng.allocator.num_total


@ON_OFF
def test_nan_rule_on_the_prefill_site_changes_no_stream(overlap):
    """The prefill site carries the prompt alone in both packages, so a
    `nan` rule there poisons nothing: both give the fault-free streams and
    quarantine nothing, and the site counts the same calls and fires."""

    def plan(side):
        return side.faults.FaultPlan(seed=0).on("generation.prefill", mode="nan", nth=(1,))

    ref = run(PORT, PROMPTS, dict(max_new_tokens=8), overlap=overlap, **CACHE)[0]
    out, cnt, _, _ = both(PROMPTS, dict(max_new_tokens=8), overlap=overlap, plan=plan,
                          **CACHE)
    assert out == ref
    assert cnt["recovery"]["quarantined"] == 0 and cnt["resets"] == 0
    assert cnt["sites"]["generation.prefill"]["fires"] == 1
