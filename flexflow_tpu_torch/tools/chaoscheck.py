#!/usr/bin/env python
"""chaoscheck: run the port's chaos (fault-injection) tests + the
generation-recovery scenario sweep over the port's engine (port of the
JAX package's ``tools/chaoscheck.py``). Its engines run on the GPU
unless ``--device cpu``.

Part 1 runs the port's own chaos and recovery tests
(``tests/test_torch_port_*.py``: recovery, overlap, fleet, disagg,
overload, host-tier faults; each holds the port against the JAX package
on the CPU, so it needs JAX and ``--device`` does not apply).

Part 2 is an in-process **generation-recovery sweep** against a live
engine: one fault-free reference stream, then the same request mix
re-run under each injected failure class —

  crash        a decode step that hard-fails twice (past the supervisor's
               single retry) -> engine restart + journal replay; every
               stream must come out byte-identical to the reference
  stall        a decode step that hangs on a gate -> the step watchdog
               trips the breaker (health goes not-ready), a deadlined
               request expires ON TIME while the device is wedged, and
               once the step unwedges the late result is discarded and
               the streams replay to byte-identical completion
  nan          one request's slot data-dependently produces NaN logits
               -> the in-step blame vector quarantines exactly that
               request (typed PoisonedRequestError); survivors match the
               reference byte-for-byte
  double fault a crash whose FIRST journal replay also crashes
               (generation.journal_replay site) -> a second budget unit
               + backoff, then exact recovery
  budget       every decode fails -> restarts exhaust the budget, the
               running streams fail with typed EngineFailedError, and
               the scheduler reports not-ready (breaker OPEN)
  combined     the acceptance gate: crash + stall + NaN-poisoned
               request in ONE batch of concurrent streams — the poisoned
               request alone fails, every other greedy stream is
               byte-identical to the fault-free run, no request hangs
               past its deadline, and the /v2/stats snapshot carries the
               recovery/quarantine counts

Part 3 (``--fleet``) is the **fleet sweep**: the same request
mix against a live 2-replica Fleet —

  replica crash  one replica's decode steps fail persistently
                 (replica_kill, scoped) -> its restart budget exhausts
                 and its RUNNING streams journal-replay onto the
                 survivor byte-identically; the dead replica is
                 replaced by a fresh warmed replica
  wedged replica a decode step on one replica hangs on a gate -> ITS
                 watchdog trips -> the fleet supervisor drains the
                 replica (no new placements) while fresh traffic flows
                 to the survivor; once unwedged the residents finish
                 exactly and the replica is retired + replaced
  brownout       one replica's breaker is OPEN -> the router places
                 everything on the survivor (the fleet stays ready);
                 nothing ever lands on the open replica

Part 5 (``--disagg``) is the **disaggregated-serving sweep**: the
same request mix against a live prefill-pool + decode-pool
fleet joined by the supervised KV-block handoff —

  baseline       every stream prefills on the prefill pool, hands its
                 KV off, and decodes on the decode pool byte-identically
                 to a unified run; zero replay fallbacks
  transfer error one per-block transfer fails (fleet.kv_handoff error)
                 -> bounded retry with backoff delivers on the second
                 attempt; byte-exact
  corrupt        a block is corrupted in flight (fleet.kv_handoff nan)
                 -> the CRC catches it on arrival -> decode-pool journal
                 replay; byte-exact
  prefill death  the prefill replica dies AFTER a stream's blocks
                 shipped -> the decode-resident stream is untouched and
                 the pool replaces the replica; a stream caught mid-
                 prefill replays onto the replacement and still hands
                 off; byte-exact
  stalled        a handoff wedges on a gate (fleet.kv_handoff stall) ->
                 the supervisor expires its deadline -> journal replay
                 on the decode pool; the late un-wedged delivery is
                 discarded (no double adoption); byte-exact
  tp mismatch    prefill pool tp=1, decode pool tp=2: needs the
                 tensor-parallel engine (ROADMAP.md queue 1, item 4);
                 reported as skipped

Part 4 (``--overload``) is the **overload storm**: a
loadgen-driven ~3x saturation burst (loadgen's Poisson schedule,
priority mix) against one scheduler on a virtual clock — best-effort
must absorb every rejection (zero interactive/standard sheds), the
adaptive limiter must engage, the degrade ladder must climb to >=
level 2 and walk back to 0 after the burst without flapping
(hysteresis), and every COMPLETED stream must be byte-identical to an
unloaded run of the same prompt.

Part 6 (``--constrained``) is the constrained-decoding sweep and part 7
(``--durable``) the durable-serving sweep (a SIGKILLed child process,
``python -m flexflow_tpu_torch.tools._durable_child``, warm-restarted).
``--mesh N`` (the tensor-parallel sweep) raises: the port has no
tensor-parallel engine yet (ROADMAP.md queue 1, item 4).

Usage: python -m flexflow_tpu_torch.tools.chaoscheck [--sweep-only | --no-sweep]
           [--fleet] [--overload] [--disagg] [--constrained] [--durable]
           [--device cpu] [extra pytest args]
"""
import argparse
import json
import os
import subprocess
import sys
import threading
import time

from flexflow_tpu_torch.tools._common import Clock, seeded_params

# the port's chaos and recovery tests (part 1)
CHAOS_TESTS = (
    "tests/test_torch_port_recovery.py",
    "tests/test_torch_port_overlap.py",
    "tests/test_torch_port_fleet.py",
    "tests/test_torch_port_disagg.py",
    "tests/test_torch_port_overload.py",
    "tests/test_torch_port_host_tier_faults.py",
)


def no_leaked_blocks(engine) -> bool:
    """Post-drain allocator invariant under prefix caching: blocks not
    on the free list are exactly the radix index's warm reusable KV."""
    used = engine.allocator.num_total - engine.allocator.num_free
    return used == engine.prefix_cache.resident_blocks


def run_recovery_sweep(device=None, params=None) -> dict:
    """The recovery sweep over a tiny engine on ``device`` (``params``:
    its weights, default seeded). Returns the report (``report["ok"]``)."""
    import numpy as np

    from flexflow_tpu_torch.generation import (
        ContinuousBatchingScheduler,
        EngineFailedError,
        GenerationEngine,
        PoisonedRequestError,
        RecoveryPolicy,
        SamplingParams,
        WatchdogPolicy,
    )
    from flexflow_tpu_torch.models.transformer import TransformerConfig
    from flexflow_tpu_torch.runtime.faults import FaultPlan
    from flexflow_tpu_torch.serving.resilience import DeadlineExceededError

    cfg = TransformerConfig(
        num_layers=2, hidden_size=32, num_heads=4, ff_size=64,
        seq_length=64, vocab_size=50, causal=True,
    )
    params = params if params is not None else seeded_params(cfg)
    prompts = [[1, 2, 3], [4, 5, 6, 7], [9, 8, 7, 6, 5]]
    sampling = SamplingParams(max_new_tokens=10)
    policy = RecoveryPolicy(sleep=lambda _s: None)  # virtual backoff

    # ONE shared engine, warmed before any fault runs: stall timeouts
    # are calibrated against warm steps — a first capture can take
    # whole seconds and must not read as a stalled device (the same
    # reason production stall timeouts must exceed worst-case capture).
    # donate=False on every device: the counters below are the retry ->
    # bisect -> restart ladder of a non-donating engine (the JAX tool's
    # CPU engine); a donating one (the CUDA default) resets and replays
    # at the first failed step, so it counts one recovery per failure
    eng = GenerationEngine(params, cfg, max_batch_slots=3, block_size=8, device=device,
                           donate=False)
    eng.generate([[1] * 12], SamplingParams(max_new_tokens=2))  # replay-length bucket

    def make(**kw):
        return eng, ContinuousBatchingScheduler(eng, recovery=policy, **kw)

    def drive(sched, handles, steps=500):
        for _ in range(steps):
            if all(h.done() for h in handles):
                return
            if not sched.step():
                return

    report, failures = {}, []

    def check(scenario, cond, msg):
        if not cond:
            failures.append(f"{scenario}: {msg}")

    # ----------------------------------------------------- reference run
    eng, sched = make()
    handles = [sched.submit(p, sampling) for p in prompts]
    drive(sched, handles)
    ref = [h.result(timeout=0) for h in handles]
    check("reference", eng.resets == 0, "fault-free run restarted the engine")
    report["reference"] = {"tokens": sum(len(r) for r in ref)}

    # ----------------------------------------------------------- crash
    eng, sched = make()
    plan = FaultPlan(seed=0)
    plan.on("generation.decode_step", mode="error",
            error=RuntimeError("injected device crash"), nth=(2, 3))
    with plan.active():
        handles = [sched.submit(p, sampling) for p in prompts]
        drive(sched, handles)
    got = [h.result(timeout=0) for h in handles]
    rs = sched.recovery_stats
    check("crash", got == ref, f"streams diverged after crash replay: {got} != {ref}")
    check("crash", rs.recoveries == 1, f"expected 1 recovery, got {rs.recoveries}")
    check("crash", no_leaked_blocks(eng), "leaked blocks")
    report["crash"] = {"recoveries": rs.recoveries,
                      "replayed_tokens": rs.replayed_tokens, "exact": got == ref}

    # ------------------------------------------------------------- stall
    # real clocks: the watchdog thread must trip while a decode hangs on
    # the injected gate, and a deadlined request must expire ON TIME
    _, sched = make(watchdog=WatchdogPolicy(stall_timeout_s=1.0, poll_s=0.05))
    gate = threading.Event()
    plan = FaultPlan(seed=0)
    plan.on("generation.decode_step", mode="stall", gate=gate, nth=(2,))
    with plan.active():
        sched.start()
        handles = [sched.submit(p, sampling) for p in prompts]
        # 4th request waits in the queue (3 slots) with a deadline that
        # expires mid-stall; the watchdog must reap it while the loop
        # thread is wedged inside the device call
        h_dead = sched.submit([2, 2, 2], sampling, deadline_s=0.5)
        t0 = time.monotonic()
        while sched.recovery_stats.watchdog_trips == 0 and time.monotonic() - t0 < 10:
            time.sleep(0.02)
        tripped_ready = sched.ready()
        gate.set()
        got = [h.result(timeout=30) for h in handles]
    rs = sched.recovery_stats
    try:
        h_dead.result(timeout=5)
        dead_ok = False
    except DeadlineExceededError:
        dead_ok = True
    except Exception:
        dead_ok = False
    sched.stop()
    check("stall", rs.watchdog_trips >= 1, "watchdog never tripped")
    check("stall", not tripped_ready, "health stayed ready during the stall")
    check("stall", got == ref, f"streams diverged after stall replay: {got} != {ref}")
    check("stall", rs.recoveries >= 1, "stalled step's late result was not replayed")
    check("stall", dead_ok, "deadlined request did not expire during the stall")
    report["stall"] = {"watchdog_trips": rs.watchdog_trips,
                      "recoveries": rs.recoveries, "exact": got == ref,
                      "deadline_enforced": dead_ok}

    # --------------------------------------------------------------- nan
    # pick a token unique to ONE reference stream: when it feeds the next
    # decode step, that slot's logits are poisoned — data-dependent, so
    # the blame vector must pin it whatever slot the scheduler chose
    poison_idx, poison_tok = None, None
    for i, stream in enumerate(ref):
        others = {t for j, s2 in enumerate(ref) if j != i for t in s2[:-1]}
        uniq = [t for t in stream[:-1] if t not in others]
        if uniq:
            poison_idx, poison_tok = i, uniq[0]
            break
    check("nan", poison_idx is not None, "no stream-unique token to poison")
    if poison_idx is not None:
        eng, sched = make()
        plan = FaultPlan(seed=0)
        plan.on("generation.decode_step", mode="nan",
                when=lambda v: bool((np.asarray(v[0]) == poison_tok).any()),
                select=lambda v: np.asarray(v[0]) == poison_tok)
        with plan.active():
            handles = [sched.submit(p, sampling) for p in prompts]
            drive(sched, handles)
        rs = sched.recovery_stats
        for i, h in enumerate(handles):
            if i == poison_idx:
                try:
                    h.result(timeout=0)
                    check("nan", False, "poisoned request did not fail")
                except PoisonedRequestError as e:
                    check("nan", e.reason == "nan_logits", f"wrong reason {e.reason}")
                except Exception as e:
                    check("nan", False, f"poisoned request failed untyped: {e!r}")
            else:
                check("nan", h.result(timeout=0) == ref[i],
                      f"survivor stream {i} diverged")
        check("nan", rs.quarantined == 1, f"expected 1 quarantine, got {rs.quarantined}")
        check("nan", rs.recoveries == 0, "partial NaN blame must not restart the engine")
        check("nan", no_leaked_blocks(eng), "leaked blocks")
        report["nan"] = {"quarantined": rs.quarantined, "poison_token": poison_tok}

    # ------------------------------------------------- double fault (replay)
    eng, sched = make()
    plan = FaultPlan(seed=0)
    plan.on("generation.decode_step", mode="error",
            error=RuntimeError("injected device crash"), nth=(2, 3))
    plan.on("generation.journal_replay", mode="error",
            error=RuntimeError("crash during replay"), nth=(0,))
    with plan.active():
        handles = [sched.submit(p, sampling) for p in prompts]
        drive(sched, handles)
    got = [h.result(timeout=0) for h in handles]
    rs = sched.recovery_stats
    check("double_fault", got == ref, "streams diverged after double-fault recovery")
    check("double_fault", plan.fired("generation.journal_replay") == 1,
          "replay fault never fired")
    check("double_fault", rs.recoveries == 1,
          f"expected 1 completed recovery, got {rs.recoveries}")
    report["double_fault"] = {"recoveries": rs.recoveries, "exact": got == ref}

    # ------------------------------------------------- budget exhaustion
    eng, sched = make()
    plan = FaultPlan(seed=0)
    plan.on("generation.decode_step", mode="error",
            error=RuntimeError("device is gone"), every=1)
    with plan.active():
        handles = [sched.submit(p, sampling) for p in prompts]
        drive(sched, handles)
    rs = sched.recovery_stats
    typed = 0
    for h in handles:
        try:
            h.result(timeout=0)
        except EngineFailedError:
            typed += 1
        except Exception:
            pass
    check("budget", typed == len(handles),
          f"{typed}/{len(handles)} running requests got the typed EngineFailedError")
    check("budget", rs.engine_failures == 1, "budget exhaustion not recorded")
    check("budget", not sched.ready(), "dead engine still reports ready")
    report["budget"] = {"recoveries": rs.recoveries,
                       "engine_failures": rs.engine_failures,
                       "typed_failures": typed}

    # ------------------------------------------- combined (the acceptance gate)
    # one seeded run, one batch of concurrent streams, ALL THREE faults:
    # an engine crash, a stalled step, and a NaN-poisoned request — the
    # poisoned request alone fails (structured), every other greedy
    # stream is byte-identical to the fault-free run, no request hangs
    # past its deadline, and the /v2/stats snapshot shows the counts
    if poison_idx is not None:
        _, sched = make(watchdog=WatchdogPolicy(stall_timeout_s=1.0, poll_s=0.05))
        gate = threading.Event()
        plan = FaultPlan(seed=0)
        plan.on("generation.decode_step", mode="error",
                error=RuntimeError("injected device crash"), nth=(4, 5))
        plan.on("generation.decode_step", mode="stall", gate=gate, nth=(9,))
        plan.on("generation.decode_step", mode="nan",
                when=lambda v: bool((np.asarray(v[0]) == poison_tok).any()),
                select=lambda v: np.asarray(v[0]) == poison_tok)
        with plan.active():
            sched.start()
            handles = [sched.submit(p, sampling) for p in prompts]
            h_dead = sched.submit([2, 2, 2], sampling, deadline_s=0.5)
            t0 = time.monotonic()
            while sched.recovery_stats.watchdog_trips == 0 and time.monotonic() - t0 < 10:
                time.sleep(0.02)
            gate.set()
            t0 = time.monotonic()
            while not all(h.done() for h in handles + [h_dead]):
                if time.monotonic() - t0 > 30:
                    break
                time.sleep(0.02)
        rs = sched.recovery_stats
        check("combined", all(h.done() for h in handles + [h_dead]),
              "a request hung (past any deadline it had)")
        for i, h in enumerate(handles):
            if i == poison_idx:
                try:
                    h.result(timeout=0)
                    check("combined", False, "poisoned request did not fail")
                except PoisonedRequestError:
                    pass
                except Exception as e:
                    check("combined", False, f"poisoned request failed untyped: {e!r}")
            else:
                check("combined", h.done() and h.result(timeout=0) == ref[i],
                      f"survivor stream {i} not byte-identical")
        if h_dead.done():
            try:
                h_dead.result(timeout=0)  # finished in time: fine
            except DeadlineExceededError:
                pass  # expired ON time: fine
            except Exception as e:
                check("combined", False, f"deadlined request failed untyped: {e!r}")
        snap = sched.stats.snapshot()  # the exact /v2/stats payload path
        check("combined", snap.get("quarantined") == 1,
              f"/v2/stats quarantined = {snap.get('quarantined')}, want 1")
        check("combined", (snap.get("recoveries") or 0) >= 2,
              f"/v2/stats recoveries = {snap.get('recoveries')}, want >= 2")
        check("combined", (snap.get("watchdog_trips") or 0) >= 1, "no watchdog trip")
        sched.stop()
        report["combined"] = {
            "recoveries": snap.get("recoveries"),
            "quarantined": snap.get("quarantined"),
            "watchdog_trips": snap.get("watchdog_trips"),
            "replayed_tokens": snap.get("replayed_tokens"),
        }

    report["ok"] = not failures
    print(json.dumps({"recovery_sweep": report}, indent=2))
    for f in failures:
        print(f"FAIL: {f}", file=sys.stderr)
    if not failures:
        print("OK: recovery sweep — crash/stall/nan/double-fault/budget/"
              "combined all behaved; surviving streams byte-identical")
    return report


def run_constrained_sweep(device=None) -> dict:
    """Constrained-decoding sweep: a mixed constrained +
    unconstrained batch against a live engine —

      build failure   generation.mask_build fails the grammar compile ->
                      the ONE submitting caller gets the injected error
                      at submit time (nothing joined the queue), the
                      retry compiles clean, and the re-run batch is
                      byte-identical to the fault-free reference
      advance failure generation.mask_advance refuses an emitted token
                      mid-stream -> exactly that request quarantines
                      with a typed PoisonedRequestError(step="mask");
                      the unconstrained survivors match the reference
                      byte-for-byte, zero engine restarts
      crash replay    a decode step hard-fails twice mid-constrained-
                      stream -> engine restart + journal replay
                      re-advances the automaton over every emitted
                      token; the constrained stream (and everyone else)
                      comes out byte-identical and schema-valid
    """

    from flexflow_tpu_torch.generation import (
        ContinuousBatchingScheduler,
        GenerationEngine,
        PoisonedRequestError,
        RecoveryPolicy,
        SamplingParams,
    )
    from flexflow_tpu_torch.generation.constrained import (
        GrammarCache,
        decode_text,
        default_vocabulary,
        validate_json,
    )
    from flexflow_tpu_torch.models.transformer import TransformerConfig
    from flexflow_tpu_torch.runtime.faults import FaultPlan

    cfg = TransformerConfig(
        num_layers=2, hidden_size=32, num_heads=4, ff_size=64,
        seq_length=64, vocab_size=50, causal=True,
    )
    params = seeded_params(cfg)
    vocab = default_vocabulary(cfg.vocab_size)
    schema = {"type": "object",
              "properties": {"ok": {"type": "boolean"},
                             "n": {"type": "integer"}}}
    spec = {"type": "json_schema", "json_schema": schema}
    prompts = [[1, 2, 3], [4, 5, 6, 7], [9, 8, 7, 6, 5]]  # [0] constrained
    # enough budget for the grammar to COMPLETE (worst-case integer is
    # 10 tokens): the exhaustion clamp ends the stream, not the budget
    sampling = SamplingParams(max_new_tokens=40)
    policy = RecoveryPolicy(sleep=lambda _s: None)

    # donate=False: the recovery counters are the non-donating ladder's
    # (see run_recovery_sweep)
    eng = GenerationEngine(params, cfg, max_batch_slots=3, block_size=8, device=device,
                           donate=False)
    eng.generate([[1] * 12], SamplingParams(max_new_tokens=2))  # warm

    def make():
        return (ContinuousBatchingScheduler(eng, recovery=policy),
                GrammarCache(vocab))

    def submit_mix(sched, grammar):
        return [sched.submit(prompts[0], sampling, grammar=grammar,
                             response_format=spec)] + [
            sched.submit(p, sampling) for p in prompts[1:]
        ]

    def drive(sched, handles, steps=800):
        for _ in range(steps):
            if all(h.done() for h in handles):
                return
            if not sched.step():
                return

    report, failures = {}, []

    def check(scenario, cond, msg):
        if not cond:
            failures.append(f"{scenario}: {msg}")

    # ----------------------------------------------------- reference run
    sched, cache = make()
    handles = submit_mix(sched, cache.get(spec))
    drive(sched, handles)
    ref = [h.result(timeout=0) for h in handles]
    text = decode_text(vocab, ref[0], sampling.eos_id)
    problems = validate_json(text, schema)
    check("reference", not problems,
          f"fault-free constrained stream not schema-valid: {text!r} {problems}")
    check("reference", eng.resets == 0, "fault-free run restarted the engine")
    report["reference"] = {"constrained_text": text,
                           "tokens": sum(len(r) for r in ref)}

    # ----------------------------------------------------- build failure
    sched, cache = make()
    plan = FaultPlan(seed=0)
    plan.on("generation.mask_build", mode="error",
            error=RuntimeError("injected grammar-compile failure"), nth=(0,))
    typed = False
    with plan.active():
        try:
            cache.get(spec)
        except RuntimeError:
            typed = True  # the submitting caller's error, pre-queue
        check("build", typed, "injected build failure did not surface")
        # the failure poisoned nothing: the retry compiles clean and the
        # full mix replays byte-identically
        handles = submit_mix(sched, cache.get(spec))
        drive(sched, handles)
    got = [h.result(timeout=0) for h in handles]
    check("build", got == ref, "streams diverged after a failed grammar build")
    check("build", plan.fired("generation.mask_build") == 1,
          "build fault never fired")
    check("build", eng.resets == 0, "a submit-time build failure restarted the engine")
    report["build"] = {"typed": typed, "exact": got == ref}

    # --------------------------------------------------- advance failure
    sched, cache = make()
    plan = FaultPlan(seed=0)
    plan.on("generation.mask_advance", mode="error",
            error=RuntimeError("injected advance failure"), nth=(5,))
    with plan.active():
        handles = submit_mix(sched, cache.get(spec))
        drive(sched, handles)
    rs = sched.recovery_stats
    try:
        handles[0].result(timeout=0)
        check("advance", False, "constrained stream did not fail")
    except PoisonedRequestError as e:
        check("advance", e.step == "mask", f"wrong step {e.step!r}")
    except Exception as e:
        check("advance", False, f"constrained stream failed untyped: {e!r}")
    for i in (1, 2):
        check("advance", handles[i].result(timeout=0) == ref[i],
              f"unconstrained survivor {i} diverged")
    check("advance", rs.quarantined == 1,
          f"expected 1 quarantine, got {rs.quarantined}")
    check("advance", eng.resets == 0,
          "a single refused advance restarted the engine")
    check("advance", sched.constrained_stats.dead_end_failures == 1,
          "dead_end_failures counter did not record the quarantine")
    report["advance"] = {"quarantined": rs.quarantined}

    # -------------------------------------- crash mid-constrained-stream
    sched, cache = make()
    plan = FaultPlan(seed=0)
    plan.on("generation.decode_step", mode="error",
            error=RuntimeError("injected device crash"), nth=(2, 3))
    with plan.active():
        handles = submit_mix(sched, cache.get(spec))
        drive(sched, handles)
    got = [h.result(timeout=0) for h in handles]
    rs = sched.recovery_stats
    text = decode_text(vocab, got[0], sampling.eos_id)
    check("crash", got == ref,
          f"streams diverged after crash replay: {got} != {ref}")
    check("crash", not validate_json(text, schema),
          f"replayed constrained stream not schema-valid: {text!r}")
    check("crash", rs.recoveries == 1, f"expected 1 recovery, got {rs.recoveries}")
    check("crash", no_leaked_blocks(eng), "leaked blocks")
    report["crash"] = {"recoveries": rs.recoveries,
                       "replayed_tokens": rs.replayed_tokens,
                       "exact": got == ref}

    report["ok"] = not failures
    print(json.dumps({"constrained_sweep": report}, indent=2))
    for f in failures:
        print(f"FAIL: {f}", file=sys.stderr)
    if not failures:
        print("OK: constrained sweep — build failure typed pre-queue, "
              "advance failure quarantined alone, crash replay "
              "byte-identical and schema-valid")
    return report


def run_fleet_sweep(device=None) -> dict:

    from flexflow_tpu_torch.generation import (
        GenerationEngine,
        RecoveryPolicy,
        SamplingParams,
        WatchdogPolicy,
    )
    from flexflow_tpu_torch.models.transformer import TransformerConfig
    from flexflow_tpu_torch.runtime.faults import FaultPlan, replica_kill
    from flexflow_tpu_torch.serving.fleet import Fleet, ReplicaState


    cfg = TransformerConfig(
        num_layers=1, hidden_size=32, num_heads=4, ff_size=64,
        seq_length=64, vocab_size=50, causal=True,
    )
    params = seeded_params(cfg, device=device)

    def factory():
        return GenerationEngine(
            params, cfg, max_batch_slots=3, block_size=8,
            prompt_buckets=(8, 32, 64), device=device,
        )

    prompts = [[1, 2, 3], [4, 5, 6, 7], [9, 8, 7, 6, 5], [1, 2, 3, 4, 4]]
    sampling = SamplingParams(max_new_tokens=10)
    tight = RecoveryPolicy(max_restarts=1, sleep=lambda _s: None)

    # fault-free per-request reference on one bare engine (batch
    # composition never changes a request's tokens)
    ref_eng = factory()
    ref = [ref_eng.generate([p], sampling)[0] for p in prompts]

    report, failures = {}, []

    def check(scenario, cond, msg):
        if not cond:
            failures.append(f"{scenario}: {msg}")

    def drive(fleet, handles, steps=500):
        for _ in range(steps):
            if all(h.done() for h in handles):
                return
            fleet.step()

    # -------------------------------------- replica crash -> failover
    fleet = Fleet(factory, 2, scheduler_kwargs=dict(recovery=tight))
    plan = FaultPlan(seed=0)
    replica_kill(plan, "r0", every=1)
    with plan.active():
        handles = [fleet.submit(p, sampling) for p in prompts]
        drive(fleet, handles)
    got = [h.result(timeout=0) for h in handles]
    fs = fleet.fleet_stats.snapshot()
    check("crash", got == ref,
          f"streams diverged across the failover: {got} != {ref}")
    check("crash", fs["failovers"] == 1, f"failovers = {fs['failovers']}, want 1")
    check("crash", fs["migrated_streams"] >= 1, "no stream migrated")
    check("crash", fs["replaced"] == 1, "dead replica never replaced")
    check("crash", "r0" not in [r.id for r in fleet.replicas],
          "murdered replica still in the fleet")
    check("crash", all(r.state == ReplicaState.ACTIVE for r in fleet.replicas),
          "fleet not whole after replacement")
    for r in fleet.replicas:
        check("crash", no_leaked_blocks(r.engine),
              f"leaked blocks on {r.id}")
    # journey completeness: every request must end with ONE
    # connected journey whose stitched span count equals the context's
    # attempted-hop count — a silently dropped span is a CI failure,
    # and the failover must appear as a hop crossing replica lanes
    from flexflow_tpu_torch.obs import JourneyIndex

    jidx = JourneyIndex()
    for rec in fleet.journey_recorders():
        jidx.add(rec)
    failover_hops = 0
    for h in handles:
        req = h._request
        jid = req.journey.journey_id
        check("crash", jid is not None, f"request {req.id} has no journey")
        jj = jidx.get(jid) if jid else None
        check("crash", jj is not None and jj["complete"]
              and jj["n_roots"] == 1,
              f"request {req.id} journey did not stitch into one "
              f"connected trace: {jj and (jj['n_roots'], jj['n_spans'])}")
        if jj is None:
            continue
        check("crash", jj["n_spans"] == req.journey.hops,
              f"request {req.id} journey dropped spans: {jj['n_spans']} "
              f"stitched vs {req.journey.hops} attempted hops")
        names = [s["name"] for s in jj["spans"]]
        if "failover" in names:
            failover_hops += 1
            check("crash", len(set(s["lane"] for s in jj["spans"])) >= 2,
                  f"failover journey never crossed lanes: {names}")
    check("crash", failover_hops >= 1,
          "the failover left no failover hop on any journey")
    report["crash"] = {"failovers": fs["failovers"],
                       "migrated_streams": fs["migrated_streams"],
                       "replaced": fs["replaced"], "exact": got == ref,
                       "journeys_complete": not any(
                           "journey" in f for f in failures),
                       "failover_hops": failover_hops}

    # ----------------------------- wedged replica -> watchdog drain -> replace
    # real clocks: replica loop threads + watchdog threads + the fleet
    # monitor must cooperate while one decode hangs on the gate
    fleet = Fleet(
        factory, 2, poll_s=0.05,
        scheduler_kwargs=dict(
            recovery=RecoveryPolicy(sleep=lambda _s: None),
            watchdog=WatchdogPolicy(stall_timeout_s=1.0, poll_s=0.05),
        ),
    )
    gate = threading.Event()
    plan = FaultPlan(seed=0)
    replica_kill(plan, "r0", mode="stall", gate=gate, nth=(2,))
    with plan.active():
        fleet.start()
        handles = [fleet.submit(p, sampling) for p in prompts]
        t0 = time.monotonic()
        while (fleet.fleet_stats.snapshot()["drains"] == 0
               and time.monotonic() - t0 < 15):
            time.sleep(0.02)
        fs_mid = fleet.fleet_stats.snapshot()
        still_ready = fleet.ready()
        # fresh traffic during the wedge must route around the drain
        h_during = fleet.submit([2, 4, 6], sampling)
        gate.set()
        got = [h.result(timeout=30) for h in handles]
        h_during.result(timeout=30)
        t0 = time.monotonic()
        while (fleet.fleet_stats.snapshot()["replaced"] == 0
               and time.monotonic() - t0 < 15):
            time.sleep(0.02)
    fs = fleet.fleet_stats.snapshot()
    fleet.stop()
    check("wedge", fs_mid["drains"] >= 1, "watchdog trip never drained the replica")
    check("wedge", still_ready, "one wedged replica took fleet readiness down")
    check("wedge", got == ref,
          f"streams diverged across the wedge: {got} != {ref}")
    check("wedge", fs["replaced"] >= 1, "drained replica never replaced")
    check("wedge", fs["failovers"] == 0,
          "a recoverable wedge must drain, not fail over")
    report["wedge"] = {"drains": fs["drains"], "replaced": fs["replaced"],
                       "exact": got == ref}

    # --------------------------------------------- brownout (breaker OPEN)
    fleet = Fleet(factory, 2, scheduler_kwargs=dict(recovery=tight))
    r0, r1 = fleet.replicas
    r0.model.breaker.trip()
    brown_ready = fleet.ready()
    handles = [fleet.submit(p, sampling) for p in prompts]
    placed_on_open = len(r0.scheduler._queue) + len(r0.scheduler._running)
    drive(fleet, handles)
    got = [h.result(timeout=0) for h in handles]
    fs = fleet.fleet_stats.snapshot()
    check("brownout", brown_ready, "fleet went not-ready with a healthy survivor")
    check("brownout", placed_on_open == 0,
          f"{placed_on_open} request(s) placed on the breaker-OPEN replica")
    check("brownout", got == ref, "streams diverged during the brownout")
    check("brownout", fs["router_decisions"].get("only_candidate", 0) >= len(prompts),
          f"router decisions missing only_candidate: {fs['router_decisions']}")
    report["brownout"] = {"router_decisions": fs["router_decisions"],
                          "exact": got == ref}

    report["ok"] = not failures
    print(json.dumps({"fleet_sweep": report}, indent=2))
    for f in failures:
        print(f"FAIL: {f}", file=sys.stderr)
    if not failures:
        print("OK: fleet sweep — replica crash failed over byte-exactly "
              "with every journey stitching into one connected trace "
              "(span count == attempted hops, failover hop crossing "
              "lanes), the wedged replica drained + got replaced, and "
              "the brownout routed around the open breaker")
    return report


def run_durable_sweep(device=None) -> dict:
    """Durable-serving sweep: process death is the fault —

      sigkill      a REAL child process (the _durable_child module) decodes
                   the four-way mix (greedy, seeded-temp, speculative,
                   constrained) with a fsync'ing WAL and is SIGKILLed
                   mid-decode -> a fresh in-process attach warm-restarts
                   the journal and every stream completes byte-identical
                   to an uninterrupted reference
      torn tail    the dead writer's active segment ends mid-record ->
                   the warm-restart scan truncates the tear (counted),
                   and the stream still replays byte-exactly from the
                   shorter journaled prefix
      fsync fault  serving.wal_fsync fails -> absorbed + counted; the
                   scheduler loop never sees it, streams byte-exact
      append fault serving.wal_append fails -> exactly ONE stream
                   degrades to non-durable (counted warning); decode
                   never blocks, every stream byte-exact
      fingerprint  a journal written under a DIFFERENT engine config ->
                   warm restart refuses with the typed
                   FingerprintMismatchError before adopting anything
      rolling      a 3-replica fleet under live traffic rolls one
                   replica at a time -> zero stream loss, every stream
                   byte-exact, 3 rotations recorded, fleet whole
    """
    import glob
    import shutil
    import tempfile

    from flexflow_tpu_torch.tools import _durable_child as mix

    from flexflow_tpu_torch.generation import (
        ContinuousBatchingScheduler,
        GenerationEngine,
        RecoveryPolicy,
        SamplingParams,
    )
    from flexflow_tpu_torch.generation.constrained import (
        GrammarCache,
        default_vocabulary,
    )
    from flexflow_tpu_torch.models.transformer import TransformerConfig
    from flexflow_tpu_torch.runtime.faults import FaultPlan
    from flexflow_tpu_torch.serving.durable import (
        Durability,
        DurabilityConfig,
        FingerprintMismatchError,
    )


    cfg = mix.build_cfg()
    eng = mix.build_engine(cfg, device)
    eng.generate([[1] * 12], SamplingParams(max_new_tokens=2))  # warm
    vocab = default_vocabulary(cfg.vocab_size)
    policy = RecoveryPolicy(sleep=lambda _s: None)
    tmp = tempfile.mkdtemp(prefix="chaoscheck-durable-")

    def drive(sched, done, steps=800):
        for _ in range(steps):
            if done():
                return
            if not sched.step():
                return

    report, failures = {}, []

    def check(scenario, cond, msg):
        if not cond:
            failures.append(f"{scenario}: {msg}")

    # --------------------------------------------------- reference run
    # the same four-way mix, uninterrupted, on a plain (non-durable)
    # scheduler: per-request tokens are batch-composition independent,
    # so this is THE byte-exactness target for every scenario below
    sched = ContinuousBatchingScheduler(eng, recovery=policy)
    handles = mix.submit_mix(sched, GrammarCache(vocab))
    drive(sched, lambda: all(h.done() for h in handles))
    ref = {
        tuple(mix.PROMPTS[kind]): handles[i].result(timeout=0)
        for i, kind in enumerate(("greedy", "seeded", "speculative", "constrained"))
    }
    report["reference"] = {"tokens": sum(len(r) for r in ref.values())}

    # --------------------------------------- SIGKILL -> warm restart
    # the victim is a REAL process: only what its group commits made
    # durable survives; the parent re-attaches over the orphaned WAL
    sigkill_dir = os.path.join(tmp, "sigkill")
    proc = subprocess.Popen(
        [sys.executable, "-m", "flexflow_tpu_torch.tools._durable_child", sigkill_dir]
        + ([] if device is None else ["--device", str(device)]),
        stdout=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=os.pathsep.join(
            p for p in (_package_root(), os.environ.get("PYTHONPATH")) if p)),
    )
    killed, child_done, deadline = False, False, time.monotonic() + 300
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if not line:
            break
        if line.startswith("DONE"):
            child_done = True
            break
        if line.startswith("TOK") and int(line.split()[1]) >= 6:
            proc.kill()  # SIGKILL: no atexit, no flush, no goodbye
            killed = True
            break
    proc.wait(timeout=60)
    proc.stdout.close()
    check("sigkill", killed and not child_done,
          "child finished (or died) before the kill landed mid-decode")
    check("sigkill", proc.returncode == -9,
          f"child exit {proc.returncode}, want -9 (SIGKILL)")

    sched = ContinuousBatchingScheduler(eng, recovery=policy)
    dur = Durability(
        sched, DurabilityConfig(wal_dir=sigkill_dir),
        grammar_cache=GrammarCache(vocab),
    )
    restart = dur.warm_restart()
    adopted = [e.req for e in sched.journal.entries()]
    drive(sched, lambda: all(r.handle.done() for r in adopted))
    check("sigkill", restart["replayed_streams"] == 4,
          f"replayed {restart['replayed_streams']} streams, want all 4")
    check("sigkill", restart["replayed_tokens"] >= 1,
          "no journaled progress survived the kill")
    for req in adopted:
        want = ref.get(tuple(req.original_prompt))
        check("sigkill", want is not None and list(req.generated) == want,
              f"stream {req.original_prompt} diverged after process death: "
              f"{list(req.generated)} != {want}")
    check("sigkill", no_leaked_blocks(eng), "leaked blocks")
    # journey completeness: the SIGKILLed child's pre-death
    # spans live ONLY in the on-disk spool it left behind — each
    # replayed stream must stitch into one connected journey joining
    # those spans to the post-restart chain through the warm_restart
    # hop, with no dangling parent links
    from flexflow_tpu_torch.obs import JourneyIndex

    jidx = JourneyIndex().add(sched.journeys)
    jidx.add_spool(dur.journey_spool)
    for req in adopted:
        jid = req.journey.journey_id
        check("sigkill", jid is not None,
              f"replayed stream {req.original_prompt} lost its journey "
              f"identity across process death")
        jj = jidx.get(jid) if jid else None
        check("sigkill", jj is not None and jj["complete"]
              and jj["n_roots"] == 1,
              f"stream {req.original_prompt} journey did not survive the "
              f"SIGKILL as one connected trace: "
              f"{jj and (jj['n_roots'], jj['n_spans'])}")
        if jj is None:
            continue
        names = [s["name"] for s in jj["spans"]]
        check("sigkill", "submit" in names and "warm_restart" in names,
              f"journey missing pre-death or bridge hops: {names}")
        ids = {s["span_id"] for s in jj["spans"]}
        check("sigkill", not [s for s in jj["spans"]
                              if s["parent_id"] and s["parent_id"] not in ids],
              f"journey has dangling parent links after the kill: {names}")
    report["sigkill"] = {
        "replayed_streams": restart["replayed_streams"],
        "replayed_tokens": restart["replayed_tokens"],
        "torn_records": restart["torn_records"],
        "exact": all(list(r.generated) == ref.get(tuple(r.original_prompt))
                     for r in adopted),
        "journeys_stitched": not any("journey" in f for f in failures),
    }
    dur.close()

    # ------------------------------------------------------- torn tail
    torn_dir = os.path.join(tmp, "torn")
    prompt = [3, 1, 4, 1, 5]
    # the scheduler that dies here runs sequentially: on this shared
    # engine a pipelined step it left in flight would stay its own (a
    # real process death takes its device state with it)
    sched = ContinuousBatchingScheduler(eng, recovery=policy, overlap=False)
    Durability(sched, DurabilityConfig(wal_dir=torn_dir))
    h = sched.submit(prompt, SamplingParams(max_new_tokens=10))
    for _ in range(4):
        sched.step()
    # abandon the scheduler (simulated death) and tear the tail: a
    # frame that claims 64 payload bytes but ends after 8 — exactly
    # what a kill mid-write leaves
    seg = sorted(glob.glob(os.path.join(torn_dir, "wal-*.seg")))[-1]
    with open(seg, "ab") as f:
        f.write(b"\x40\x00\x00\x00\x00\x00\x00\x00" + b'{"t":"to')
    sched = ContinuousBatchingScheduler(eng, recovery=policy)
    dur = Durability(sched, DurabilityConfig(wal_dir=torn_dir))
    restart = dur.warm_restart()
    adopted = [e.req for e in sched.journal.entries()]
    drive(sched, lambda: all(r.handle.done() for r in adopted))
    ref_torn = eng.generate([prompt], SamplingParams(max_new_tokens=10))[0]
    check("torn", restart["torn_records"] >= 1,
          f"torn tail not detected: {restart['torn_records']}")
    check("torn", len(adopted) == 1 and list(adopted[0].generated) == ref_torn,
          "stream did not replay byte-exactly past the torn tail")
    report["torn"] = {"torn_records": restart["torn_records"],
                      "exact": [list(r.generated) for r in adopted] == [ref_torn]}

    # ------------------------------------------------------ fsync fault
    # let prior scenarios' paced committers drain first: an abandoned
    # WAL's pending commit wakes up to one pacing interval later and
    # would consume the nth call slots of the plan below (an idle
    # committer never reaches the fsync site again)
    time.sleep(0.12)
    sched = ContinuousBatchingScheduler(eng, recovery=policy)
    # commit_interval_s=0: unpaced per-request commit cycles, so the
    # nth slots below land deterministically inside the short drive
    # (the scenario tests fault absorption, not fsync pacing)
    dur = Durability(
        sched, DurabilityConfig(wal_dir=os.path.join(tmp, "fsync"),
                                commit_interval_s=0.0),
        grammar_cache=GrammarCache(vocab),
    )
    plan = FaultPlan(seed=0)
    plan.on("serving.wal_fsync", mode="error",
            error=OSError("injected fsync failure"), nth=(1, 2))
    with plan.active():
        handles = mix.submit_mix(sched, GrammarCache(vocab))
        drive(sched, lambda: all(h.done() for h in handles))
    got = [h.result(timeout=0) for h in handles]
    counters = dur.wal.counters()
    check("fsync", plan.fired("serving.wal_fsync") >= 2, "fsync fault never fired")
    check("fsync", counters["fsync_failures"] >= 2,
          f"fsync failures not counted: {counters['fsync_failures']}")
    check("fsync", dur.journal.degraded_count() == 0,
          "an absorbed fsync failure degraded a stream")
    for i, kind in enumerate(("greedy", "seeded", "speculative", "constrained")):
        check("fsync", got[i] == ref[tuple(mix.PROMPTS[kind])],
              f"{kind} stream diverged under fsync faults")
    report["fsync"] = {"fsync_failures": counters["fsync_failures"],
                       "exact": all(
                           got[i] == ref[tuple(mix.PROMPTS[k])]
                           for i, k in enumerate(
                               ("greedy", "seeded", "speculative", "constrained")))}
    dur.close()

    # ----------------------------------------------------- append fault
    sched = ContinuousBatchingScheduler(eng, recovery=policy)
    dur = Durability(
        sched, DurabilityConfig(wal_dir=os.path.join(tmp, "append")),
        grammar_cache=GrammarCache(vocab),
    )
    plan = FaultPlan(seed=0)
    plan.on("serving.wal_append", mode="error",
            error=OSError("injected append failure"), nth=(1,))
    with plan.active():
        handles = mix.submit_mix(sched, GrammarCache(vocab))
        drive(sched, lambda: all(h.done() for h in handles))
    got = [h.result(timeout=0) for h in handles]
    check("append", dur.journal.degraded_count() == 1,
          f"degraded {dur.journal.degraded_count()} streams, want exactly 1")
    check("append", dur.stats.counts()["wal_append_failures"] == 1,
          "append failure not counted")
    for i, kind in enumerate(("greedy", "seeded", "speculative", "constrained")):
        check("append", got[i] == ref[tuple(mix.PROMPTS[kind])],
              f"{kind} stream diverged after the degraded append")
    report["append"] = {"degraded": dur.journal.degraded_count(),
                        "exact": all(
                            got[i] == ref[tuple(mix.PROMPTS[k])]
                            for i, k in enumerate(
                                ("greedy", "seeded", "speculative", "constrained")))}
    dur.close()

    # ---------------------------------------------- fingerprint refusal
    fp_dir = os.path.join(tmp, "fingerprint")
    sched = ContinuousBatchingScheduler(eng, recovery=policy, overlap=False)
    Durability(sched, DurabilityConfig(wal_dir=fp_dir))
    sched.submit([7, 7, 7], SamplingParams(max_new_tokens=10))
    for _ in range(3):
        sched.step()
    other_cfg = TransformerConfig(
        num_layers=1, hidden_size=32, num_heads=4, ff_size=64,
        seq_length=64, vocab_size=50, causal=True,
    )
    other = GenerationEngine(
        seeded_params(other_cfg), other_cfg,
        max_batch_slots=4, block_size=8, device=device,
    )
    sched_b = ContinuousBatchingScheduler(other, recovery=policy)
    dur_b = Durability(sched_b, DurabilityConfig(wal_dir=fp_dir))
    typed = False
    try:
        dur_b.warm_restart()
    except FingerprintMismatchError as e:
        typed = e.expected != e.found
    except Exception as e:
        check("fingerprint", False, f"untyped refusal: {e!r}")
    check("fingerprint", typed,
          "config drift did not raise the typed FingerprintMismatchError")
    check("fingerprint", not sched_b.journal.entries(),
          "a refused restart still adopted streams")
    report["fingerprint"] = {"typed": typed}

    # ------------------------------- rolling restart under live traffic
    def factory():
        return mix.build_engine(cfg, device)

    from flexflow_tpu_torch.serving.fleet import Fleet, ReplicaState

    roll_root = os.path.join(tmp, "rolling")
    fleet = Fleet(
        factory, 3, poll_s=0.05, durability_root=roll_root,
        scheduler_kwargs=dict(recovery=policy),
    )
    fleet.start()
    sampling = SamplingParams(max_new_tokens=10)
    prompts = [[1, 2, 3], [4, 5, 6, 7], [9, 8, 7, 6, 5],
               [2, 4, 6], [3, 1, 4, 1, 5], [8, 8, 8]]
    ref_eng = factory()
    roll_ref = {tuple(p): ref_eng.generate([p], sampling)[0] for p in prompts}
    live, live_lock = [], threading.Lock()
    stop_feed = threading.Event()

    def feeder():
        # live traffic THROUGH the rotation: keep submitting until the
        # restart completes — the router must always find a home
        i = 0
        while not stop_feed.is_set():
            h = fleet.submit(prompts[i % len(prompts)], sampling)
            with live_lock:
                live.append(h)
            i += 1
            time.sleep(0.05)

    handles = [fleet.submit(p, sampling) for p in prompts]
    feed = threading.Thread(target=feeder, daemon=True)
    feed.start()
    roll = fleet.rolling_restart(drain_wait_s=15)
    stop_feed.set()
    feed.join(timeout=10)
    with live_lock:
        everyone = handles + list(live)
    results, lost = [], 0
    for h in everyone:
        try:
            results.append((h, h.result(timeout=60)))
        except Exception:
            lost += 1
    dr = fleet.durable_report()
    rotations = sum(
        rep["counters"].get("rolling_restarts", 0)
        for rep in dr["replicas"].values()
    )
    states = fleet.states()
    fleet.stop()
    check("rolling", roll["ok"], f"rolling restart aborted: {roll}")
    check("rolling", len(roll["replicas"]) == 3,
          f"rotated {len(roll['replicas'])} replicas, want 3")
    check("rolling", lost == 0,
          f"{lost}/{len(everyone)} streams lost across the rotation")
    for h, got_toks in results:
        want = roll_ref[tuple(h._request.original_prompt)]
        check("rolling", got_toks == want,
              f"stream {h._request.original_prompt} diverged across the "
              f"rotation: {got_toks} != {want}")
    check("rolling", rotations == 3,
          f"rolling_restarts counters sum to {rotations}, want 3")
    check("rolling", states.get(ReplicaState.ACTIVE, 0) == 3,
          f"fleet not whole after the rotation: {states}")
    report["rolling"] = {"rotations": rotations, "streams": len(everyone),
                         "lost": lost, "ok": roll["ok"]}

    shutil.rmtree(tmp, ignore_errors=True)
    report["ok"] = not failures
    print(json.dumps({"durable_sweep": report}, indent=2))
    for f in failures:
        print(f"FAIL: {f}", file=sys.stderr)
    if not failures:
        print("OK: durable sweep — SIGKILL'd child warm-restarted "
              "byte-exactly (greedy/seeded/speculative/constrained) with "
              "every journey stitching pre-death spool spans to the "
              "post-restart chain, torn tail truncated, fsync + append "
              "faults degraded gracefully, fingerprint drift refused "
              "typed, and the 3-replica rolling restart lost zero streams")
    return report


def run_overload_sweep(device=None) -> dict:
    """Overload storm: a loadgen-driven ~3x saturation burst
    against one scheduler on a virtual clock. Certifies the overload
    machinery end to end:

      * zero interactive- or standard-priority sheds — best-effort
        absorbs every rejection (priority-ordered admission + shed);
      * the degrade ladder reaches >= level 2 during the burst and
        returns to level 0 after it, monotonically (hysteresis, no
        flapping);
      * every COMPLETED stream is byte-identical to an unloaded run of
        the same prompt (admission control never corrupts streams);
      * the limiter actually engaged (throttles > 0) — the storm is a
        real storm, not a pass-by-construction.
    """

    from flexflow_tpu_torch.generation import (
        ContinuousBatchingScheduler,
        GenerationEngine,
        SamplingParams,
    )
    from flexflow_tpu_torch.models.transformer import TransformerConfig
    from flexflow_tpu_torch.serving.overload import OverloadConfig, Priority
    from flexflow_tpu_torch.tools.loadgen import build_schedule, drive_virtual

    cfg = TransformerConfig(
        num_layers=1, hidden_size=32, num_heads=4, ff_size=64,
        seq_length=64, vocab_size=40, causal=True,
    )
    eng = GenerationEngine(
        seeded_params(cfg), cfg, max_batch_slots=3, block_size=8,
        prompt_buckets=(8, 32, 64), device=device,
    )
    eng.generate([[1, 2, 3]], SamplingParams(max_new_tokens=2))  # capture the steps

    report, failures = {}, []

    def check(cond, msg):
        if not cond:
            failures.append(f"overload: {msg}")

    # capacity arithmetic: 3 slots, ~7 virtual ticks (dt=0.02s) per
    # 6-token request => ~21 req/s service rate; the burst offers 60
    # req/s for 2s (~3x saturation), with interactive+standard held
    # inside capacity (30% of 60 = 18 req/s) so only best-effort is
    # the overflow the storm must shed
    dt = 0.02
    clock = Clock()
    sched = ContinuousBatchingScheduler(
        eng, clock=clock, max_queue=16,
        overload=OverloadConfig(
            limiter_interval_s=0.2,
            min_limit=14,           # slots + headroom for the full i+s backlog
            min_queue_frac=0.2,
            up_hold_s=0.1, down_hold_s=0.5,
        ),
    )
    schedule = build_schedule(
        60.0, 2.0, mix=(0.15, 0.15, 0.7), seed=7, vocab=40,
        deadlines_s=(None,), max_new=6,
    )
    # unloaded per-prompt references (batch composition never changes a
    # request's tokens — the batch-invariance guarantee)
    refs = {}
    for a in schedule:
        key = tuple(a.prompt)
        if key not in refs:
            refs[key] = eng.generate(
                [list(a.prompt)], SamplingParams(max_new_tokens=a.max_new)
            )[0]

    lg = drive_virtual(sched, schedule, clock, dt=dt,
                       sampling_cls=SamplingParams)
    # post-burst: keep ticking the idle scheduler so the ladder can
    # walk back down through its hysteresis holds
    for _ in range(500):
        if sched.overload.ladder.level == 0:
            break
        sched.step()
        clock.advance(dt)
    summary = lg.render(2.0)
    acts = sched.overload.activations()
    ladder = sched.overload.ladder.snapshot()
    per = summary["per_priority"]

    check(per["interactive"]["shed"] == 0,
          f"{per['interactive']['shed']} interactive shed(s)")
    check(per["standard"]["shed"] == 0,
          f"{per['standard']['shed']} standard shed(s)")
    check(per["best_effort"]["shed"] > 0,
          "the storm shed nothing — not a saturation burst")
    check(acts["throttled"] > 0, "the adaptive limiter never engaged")
    check(ladder["max_level_seen"] >= 2,
          f"ladder peaked at level {ladder['max_level_seen']}, want >= 2")
    check(sched.overload.ladder.level == 0,
          f"ladder stuck at level {sched.overload.ladder.level} after the burst")
    # hysteresis: the level walk is up-then-down, never oscillating
    levels = [h["to"] for h in ladder["history"]]
    direction_changes = sum(
        1 for i in range(1, len(levels) - 1)
        if (levels[i] - levels[i - 1]) * (levels[i + 1] - levels[i]) < 0
    )
    check(direction_changes <= 1,
          f"ladder flapped: {levels}")
    for p in Priority.ORDER:
        d = per[p]
        check(d["failed"] == 0, f"{d['failed']} {p} request(s) failed untyped")
    # byte-exactness: every stream the storm COMPLETED must match the
    # unloaded run of the same prompt — admission control (displacement,
    # limiter, ladder levels, preemption under pressure) never touches
    # stream content
    streams = lg.streams()
    mismatches = sum(
        1 for prompt, tokens in streams if tokens != refs[tuple(prompt)]
    )
    check(streams, "the storm completed no streams at all")
    check(mismatches == 0,
          f"{mismatches}/{len(streams)} completed stream(s) diverged "
          "from the unloaded run")
    sched.stop()

    report["storm"] = {
        "summary": summary,
        "activations": acts,
        "ladder": {k: ladder[k] for k in
                   ("max_level_seen", "transitions_total", "level")},
    }
    report["ok"] = not failures
    print(json.dumps({"overload_sweep": report}, indent=2))
    for f in failures:
        print(f"FAIL: {f}", file=sys.stderr)
    if not failures:
        print("OK: overload storm — best-effort absorbed every shed (zero "
              "interactive/standard), the ladder climbed to level "
              f"{ladder['max_level_seen']} and recovered to 0 without "
              "flapping, and streams stayed byte-identical")
    return report


def run_disagg_sweep(device=None) -> dict:
    """Disaggregated prefill/decode serving chaos: every
    failure class of the KV-block handoff must terminate in a byte-
    exact stream — delivered, retried, or journal-replayed on the
    decode pool — never a corrupted or lost one."""

    from flexflow_tpu_torch.generation import (
        GenerationEngine,
        RecoveryPolicy,
        SamplingParams,
    )
    from flexflow_tpu_torch.models.transformer import TransformerConfig
    from flexflow_tpu_torch.runtime import faults
    from flexflow_tpu_torch.runtime.faults import FaultPlan, replica_kill
    from flexflow_tpu_torch.serving.fleet import DisaggregatedFleet

    cfg = TransformerConfig(
        num_layers=1, hidden_size=32, num_heads=4, ff_size=64,
        seq_length=64, vocab_size=50, causal=True,
    )
    params = seeded_params(cfg, device=device)

    def factory():
        def make():
            return GenerationEngine(
                params, cfg, max_batch_slots=3, block_size=8,
                prompt_buckets=(8, 32, 64), device=device,
            )
        return make

    prompts = [[1, 2, 3], [4, 5, 6, 7], [9, 8, 7, 6, 5], [1, 2, 3, 4, 4]]
    sampling = SamplingParams(max_new_tokens=10)
    tight = RecoveryPolicy(max_restarts=1, sleep=lambda _s: None)

    # fault-free per-request unified reference (batch composition never
    # changes a request's tokens — the batch-invariance guarantee)
    ref_eng = factory()()
    ref = [ref_eng.generate([p], sampling)[0] for p in prompts]

    report, failures = {}, []

    def check(scenario, cond, msg):
        if not cond:
            failures.append(f"{scenario}: {msg}")

    def make_disagg(**kw):
        kw.setdefault("scheduler_kwargs", dict(recovery=tight))
        return DisaggregatedFleet(factory(), n_prefill=1, n_decode=1, **kw)

    def drive(dfleet, handles, steps=800):
        for _ in range(steps):
            if all(h.done() for h in handles):
                return
            dfleet.step()

    # ------------------------------------------------ baseline handoff
    dfleet = make_disagg()
    warm_ok = dfleet.handoff.transfers["ok"]  # warm_handoff's transfer
    handles = [dfleet.submit(p, sampling) for p in prompts]
    drive(dfleet, handles)
    got = [h.result(timeout=0) for h in handles]
    ho = dfleet.handoff.report()
    kv_imports = sum(
        r.scheduler.recovery_stats.kv_imports
        for r in dfleet.decode._replicas_snapshot()
    )
    check("baseline", got == ref,
          f"disaggregated streams diverged from unified: {got} != {ref}")
    check("baseline", ho["transfers"]["ok"] - warm_ok == len(prompts),
          f"expected {len(prompts)} delivered handoffs, got {ho['transfers']}")
    check("baseline", ho["replay_fallbacks_total"] == 0,
          "fault-free run fell back to replay")
    check("baseline", kv_imports >= len(prompts),
          f"decode pool imported {kv_imports} payloads, want {len(prompts)}")
    check("baseline", ho["bytes_total"] > 0, "no bytes accounted on the wire")
    for pool in (dfleet.prefill, dfleet.decode):
        for r in pool._replicas_snapshot():
            check("baseline", no_leaked_blocks(r.engine),
                  f"leaked blocks on {r.id}")
    # journey completeness: every handed-off request must
    # stitch into ONE connected journey (span count == attempted hops —
    # a dropped span fails CI) that crosses from the prefill lane into
    # the decode lane via the kv_handoff hop
    from flexflow_tpu_torch.obs import JourneyIndex

    jidx = JourneyIndex()
    for rec in dfleet.journey_recorders():
        jidx.add(rec)
    for h in handles:
        req = h._request
        jid = req.journey.journey_id
        check("baseline", jid is not None, f"request {req.id} has no journey")
        jj = jidx.get(jid) if jid else None
        check("baseline", jj is not None and jj["complete"]
              and jj["n_roots"] == 1,
              f"request {req.id} journey did not stitch into one "
              f"connected trace: {jj and (jj['n_roots'], jj['n_spans'])}")
        if jj is None:
            continue
        check("baseline", jj["n_spans"] == req.journey.hops,
              f"request {req.id} journey dropped spans: {jj['n_spans']} "
              f"stitched vs {req.journey.hops} attempted hops")
        names = [s["name"] for s in jj["spans"]]
        check("baseline", "kv_handoff" in names,
              f"handed-off journey missing the kv_handoff hop: {names}")
        lanes = set(s["lane"] for s in jj["spans"])
        check("baseline", any(l.startswith("p") for l in lanes)
              and any(l.startswith("d") for l in lanes),
              f"journey never crossed prefill->decode lanes: {lanes}")
    report["baseline"] = {"transfers": ho["transfers"],
                          "bytes_total": ho["bytes_total"],
                          "kv_imports": kv_imports, "exact": got == ref,
                          "journeys_complete": not any(
                              "journey" in f for f in failures)}

    # ----------------------------------- transfer error -> bounded retry
    dfleet = make_disagg()
    base = dict(dfleet.handoff.transfers)
    plan = FaultPlan(seed=0)
    plan.on(faults.FLEET_KV_HANDOFF, mode="error",
            error=RuntimeError("injected transfer failure"), nth=(0,))
    with plan.active():
        handles = [dfleet.submit(p, sampling) for p in prompts]
        drive(dfleet, handles)
    got = [h.result(timeout=0) for h in handles]
    ho = dfleet.handoff.report()
    check("retry", got == ref, f"streams diverged after retry: {got} != {ref}")
    check("retry", ho["retries_total"] == 1,
          f"retries_total = {ho['retries_total']}, want 1")
    check("retry", ho["transfers"]["ok"] - base["ok"] == len(prompts),
          "retried handoff was not delivered")
    check("retry", ho["replay_fallbacks_total"] == 0,
          "a single transfer error must retry, not replay")
    report["retry"] = {"retries": ho["retries_total"], "exact": got == ref}

    # ------------------------------- corrupt in flight -> CRC -> replay
    dfleet = make_disagg()
    base = dict(dfleet.handoff.transfers)
    plan = FaultPlan(seed=0)
    plan.on(faults.FLEET_KV_HANDOFF, mode="nan", nth=(0,))
    with plan.active():
        handles = [dfleet.submit(p, sampling) for p in prompts]
        drive(dfleet, handles)
    got = [h.result(timeout=0) for h in handles]
    ho = dfleet.handoff.report()
    check("corrupt", got == ref,
          f"streams diverged after corrupt-block replay: {got} != {ref}")
    check("corrupt", ho["transfers"]["corrupt"] - base["corrupt"] == 1,
          f"CRC did not catch the corruption: {ho['transfers']}")
    check("corrupt", ho["replay_fallbacks_total"] == 1,
          f"replay_fallbacks = {ho['replay_fallbacks_total']}, want 1")
    check("corrupt", ho["transfers"]["ok"] - base["ok"] == len(prompts) - 1,
          "clean handoffs were disturbed by the corrupted one")
    # the replayed stream's journey must stay connected and record the
    # fallback as a kv_handoff_replay hop
    jidx = JourneyIndex()
    for rec in dfleet.journey_recorders():
        jidx.add(rec)
    replay_hops = 0
    for h in handles:
        req = h._request
        jj = jidx.get(req.journey.journey_id)
        check("corrupt", jj is not None and jj["complete"],
              f"request {req.id} journey broke across the corrupt handoff")
        if jj is None:
            continue
        check("corrupt", jj["n_spans"] == req.journey.hops,
              f"request {req.id} journey dropped spans: {jj['n_spans']} "
              f"vs {req.journey.hops}")
        if any(s["name"] == "kv_handoff_replay" for s in jj["spans"]):
            replay_hops += 1
    check("corrupt", replay_hops == 1,
          f"{replay_hops} journeys carry the kv_handoff_replay hop, want 1")
    report["corrupt"] = {"transfers": ho["transfers"],
                         "replay_fallbacks": ho["replay_fallbacks_total"],
                         "exact": got == ref,
                         "replay_hops": replay_hops}

    # --------------------- prefill replica death AFTER blocks shipped
    # stream A hands off, then its origin replica starts dying on every
    # prefill while A is still decoding: A must be untouched (the wire
    # format is host-resident). A fresh request's prefill failure is
    # attributed to the REQUEST (fail fast — blame semantics), so
    # the replica-death signal is the breaker: five consecutive prefill
    # failures hold it OPEN, the pool supervisor drains the replica and
    # replaces it, and a follow-up stream lands on the replacement and
    # still hands off byte-exactly
    dfleet = make_disagg()
    base_ok = dfleet.handoff.transfers["ok"]
    h_a = dfleet.submit(prompts[0], sampling)
    for _ in range(200):
        if dfleet.handoff.transfers["ok"] > base_ok:
            break
        dfleet.step()
    check("prefill_death", dfleet.handoff.transfers["ok"] == base_ok + 1,
          "stream A's blocks never shipped")
    check("prefill_death", not h_a.done(), "stream A finished too early "
          "(nothing left decoding through the murder)")
    p0 = dfleet.prefill._replicas_snapshot()[0]
    plan = FaultPlan(seed=0)
    # prefill-pool replicas never run decode steps in steady state —
    # the kill must hit the prefill program itself
    replica_kill(plan, p0.id, site=faults.GENERATION_PREFILL, every=1)
    with plan.active():
        victims = [dfleet.submit(prompts[1], sampling) for _ in range(5)]
        # Fleet.step() runs the supervisor check inline, so the breaker-
        # open -> drain -> replace ladder completes during this drive
        drive(dfleet, victims + [h_a])
    got_a = h_a.result(timeout=0)
    check("prefill_death", got_a == ref[0],
          "decode-resident stream A diverged when its prefill replica died")
    for h in victims:
        try:
            h.result(timeout=0)
            check("prefill_death", False,
                  "a request admitted on the dying replica did not fail")
        except Exception:
            pass
    check("prefill_death", p0.model.breaker.state == "open",
          f"breaker did not open on the failure storm: {p0.model.breaker.state}")
    pfs = dfleet.prefill.fleet_stats.snapshot()
    dfs = dfleet.decode.fleet_stats.snapshot()
    check("prefill_death", pfs["drains"] == 1 and pfs["replaced"] == 1,
          f"prefill pool lifecycle wrong: {pfs}")
    check("prefill_death", dfs["drains"] == 0 and dfs["failovers"] == 0,
          "the murder leaked into the decode pool")
    check("prefill_death", p0.id not in
          [r.id for r in dfleet.prefill._replicas_snapshot()],
          "murdered prefill replica still in the pool")
    # the replacement replica must have the handoff sink installed
    h_c = dfleet.submit(prompts[2], sampling)
    drive(dfleet, [h_c])
    got_c = h_c.result(timeout=0)
    check("prefill_death", got_c == ref[2],
          "follow-up stream on the replacement replica diverged")
    check("prefill_death", dfleet.handoff.transfers["ok"] == base_ok + 2,
          "follow-up stream did not hand off from the replacement")
    report["prefill_death"] = {
        "prefill": {k: pfs[k] for k in ("drains", "replaced")},
        "exact": got_a == ref[0] and got_c == ref[2],
    }

    # -------------------- stalled handoff -> deadline expiry -> replay
    # live mode: the transfer wedges on the gate inside the dedicated
    # handoff worker thread (started by dfleet.start()); the disagg
    # monitor's supervisor sweep must expire the deadline and
    # journal-replay on the decode pool while the transfer is still
    # wedged, and the late un-wedged delivery must be discarded
    dfleet = make_disagg(handoff_timeout_s=1.0, poll_s=0.05)
    base = dict(dfleet.handoff.transfers)
    gate = threading.Event()
    plan = FaultPlan(seed=0)
    plan.on(faults.FLEET_KV_HANDOFF, mode="stall", gate=gate, nth=(0,))
    with plan.active():
        dfleet.start()
        h_s = dfleet.submit(prompts[2], sampling)
        got_s = h_s.result(timeout=30)
        stalled_when_done = dict(dfleet.handoff.transfers)
        gate.set()
        # let the wedged transfer un-block and (correctly) do nothing
        t0 = time.monotonic()
        while dfleet.handoff.in_flight and time.monotonic() - t0 < 10:
            time.sleep(0.02)
        dfleet.stop()
    ho = dfleet.handoff.report()
    check("stalled", got_s == ref[2],
          f"stream diverged after stall replay: {got_s} != {ref[2]}")
    check("stalled", stalled_when_done["stalled"] - base["stalled"] == 1,
          f"deadline expiry not recorded: {stalled_when_done}")
    check("stalled", ho["transfers"]["ok"] == base["ok"],
          "the late un-wedged delivery was adopted after the replay "
          "(two schedulers owned one stream)")
    check("stalled", ho["replay_fallbacks_total"] == 1,
          f"replay_fallbacks = {ho['replay_fallbacks_total']}, want 1")
    check("stalled", ho["in_flight"] == [], "handoff leaked in flight")
    report["stalled"] = {"transfers": ho["transfers"],
                         "replay_fallbacks": ho["replay_fallbacks_total"],
                         "exact": got_s == ref[2]}

    # ------------------- TP mismatch: tp=1 prefill -> tp=2 decode pool
    # needs the tensor-parallel engine, which the port does not have yet
    report["tp_mismatch"] = {
        "skipped": "no tensor-parallel engine in the port (ROADMAP.md queue 1, item 4)"}

    report["ok"] = not failures
    print(json.dumps({"disagg_sweep": report}, indent=2))
    for f in failures:
        print(f"FAIL: {f}", file=sys.stderr)
    if not failures:
        print("OK: disagg sweep — handoffs delivered byte-exactly with "
              "every journey stitching prefill->decode lanes as one "
              "connected trace (span count == attempted hops); transfer "
              "error retried, corruption CRC-caught (replay recorded as a "
              "kv_handoff_replay hop), prefill death isolated, and a "
              "stalled handoff expired into decode-pool journal replay, "
              "all byte-identical to the unified run")
    return report


def run_mesh_sweep(n: int) -> dict:
    """Sharded-generation chaos: needs the tensor-parallel engine
    (``generation/sharding.py``), which the port does not have yet."""
    raise NotImplementedError(
        "chaoscheck --mesh needs the tensor-parallel engine (generation/sharding.py), "
        "which is not ported yet (ROADMAP.md queue 1, item 4)")


def _package_root() -> str:
    """The directory holding the ``flexflow_tpu_torch`` package."""
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sweep-only", action="store_true",
                    help="skip pytest; run only the in-process sweeps")
    ap.add_argument("--no-sweep", action="store_true",
                    help="run only the port's chaos/recovery tests")
    ap.add_argument("--fleet", action="store_true",
                    help="also run the live fleet sweep (crash-failover, "
                         "watchdog drain/replace, router brownout)")
    ap.add_argument("--overload", action="store_true",
                    help="also run the overload storm (priority-ordered "
                         "shed, degrade-ladder hysteresis, byte-exact "
                         "survivors)")
    ap.add_argument("--disagg", action="store_true",
                    help="also run the disaggregated-serving sweep (KV "
                         "handoff retry/corrupt/stall/prefill-death, all "
                         "byte-exact)")
    ap.add_argument("--constrained", action="store_true",
                    help="also run the constrained-decoding sweep "
                         "(grammar build failure typed pre-queue, "
                         "mid-stream advance failure quarantined alone, "
                         "crash replay byte-exact + schema-valid)")
    ap.add_argument("--durable", action="store_true",
                    help="also run the durable-serving sweep (SIGKILL'd "
                         "child warm-restarts byte-exactly, torn-tail "
                         "truncation, fsync/append fault degradation, "
                         "fingerprint-drift refusal, 3-replica rolling "
                         "restart with zero stream loss)")
    ap.add_argument("--mesh", type=int, default=0, metavar="N",
                    help="the sharded-generation sweep (needs the "
                         "tensor-parallel engine: not ported yet, raises)")
    ap.add_argument("--device", default=None,
                    help="the sweeps' engine device (default: the GPU; "
                         "'cpu' for the CPU)")
    args, pytest_args = ap.parse_known_args(argv)

    if args.mesh:
        run_mesh_sweep(args.mesh)

    rc = 0
    if not args.sweep_only:
        cmd = [
            sys.executable, "-m", "pytest", *CHAOS_TESTS, "-q",
            "-p", "no:cacheprovider", *pytest_args,
        ]
        rc = subprocess.call(cmd, cwd=_package_root(),
                             env=dict(os.environ, JAX_PLATFORMS="cpu"))
    sweeps = (
        (not args.no_sweep, run_recovery_sweep),
        (args.fleet, run_fleet_sweep),
        (args.overload, run_overload_sweep),
        (args.disagg, run_disagg_sweep),
        (args.constrained, run_constrained_sweep),
        (args.durable, run_durable_sweep),
    )
    for wanted, sweep in sweeps:
        if wanted and rc == 0 and not sweep(device=args.device)["ok"]:
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
