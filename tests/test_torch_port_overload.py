"""Overload control and scheduler observability through both schedulers:
the scenarios of ``tests/test_overload.py`` (priority-ordered admission,
queue-full shedding, the preemption victim, the spec cap mid-stream,
the max_new clamp, level-4 shedding, the infeasible fast-fail, the
``serving.admission`` site, inertness) and ``tests/test_observability.py``
(the trace latency decomposition, observability off, quarantine and
restart postmortems) run on the JAX package's scheduler and on the
port's over the same weights, on virtual clocks. Streams, admission
order, rejection types and their reason / priority / retry_after_s, and
the trace decompositions must be equal."""
import pytest

from conftest import FakeClock
from torch_port_chaos import JAX, PORT, engine, outcome

pytestmark = pytest.mark.torch_port

SIDES = (JAX, PORT)


def make_sched(side, eng, **kw):
    """A scheduler on a virtual clock with instant recovery backoff, with
    request journeys off on both sides (their random ids would differ;
    test_torch_port_journey.py holds the journeys)."""
    clock = kw.pop("clock", None) or FakeClock()
    kw.setdefault("max_queue", 8)
    kw.setdefault("recovery", side.no_sleep())
    kw["journeys"] = False
    return side.Scheduler(eng, clock=clock, **kw), clock


def drain(sched, handles, steps=800):
    for _ in range(steps):
        if all(h.done() for h in handles):
            return
        sched.step()


def rejection(fn):
    """What a typed rejection says: its type, reason, class, backoff and
    predicted TTFT (None where it has none)."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the rejection IS the result
        return (type(e).__name__, getattr(e, "reason", None), getattr(e, "priority", None),
                getattr(e, "retry_after_s", None), getattr(e, "predicted_ttft_s", None))
    return None


def settled(handle):
    """A request's tokens, or its rejection as :func:`rejection` reads it."""
    return rejection(lambda: handle.result(timeout=0)) or handle.result(timeout=0)


def both(scenario):
    """``scenario(side)`` on both schedulers; the results must be equal."""
    j, p = scenario(JAX), scenario(PORT)
    assert p == j
    return p


def test_priority_ordered_admission():
    def run(side):
        sched, _ = make_sched(side, engine(side)[0])
        sp = side.SamplingParams(max_new_tokens=2)
        order = []

        def tag(h, name):
            h.future.add_done_callback(lambda f: order.append(name))
            return h

        fill = [tag(sched.submit([1, 2, 3], sp, priority="best_effort"), f"f{i}")
                for i in range(3)]
        b = tag(sched.submit([4, 5, 6], sp, priority="best_effort"), "b")
        s = tag(sched.submit([4, 5, 7], sp, priority="standard"), "s")
        i = tag(sched.submit([4, 5, 8], sp, priority="interactive"), "i")
        queued = [r.priority for r in sched._queue]
        drain(sched, fill + [b, s, i])
        return queued, order, [settled(h) for h in fill + [b, s, i]]

    queued, _, _ = both(run)
    assert queued == ["interactive", "standard"] + ["best_effort"] * 4


def test_queue_full_sheds_lowest_priority():
    def run(side):
        sched, _ = make_sched(side, engine(side)[0], max_queue=2)
        sp = side.SamplingParams(max_new_tokens=2)
        running = []
        for _ in range(3):
            running.append(sched.submit([1, 2, 3], sp))
            sched.step()
        q1 = sched.submit([4, 4, 4], sp, priority="best_effort")
        q2 = sched.submit([5, 5, 5], sp, priority="best_effort")
        bounced = rejection(lambda: sched.submit([6, 6, 6], sp, priority="best_effort"))
        hi = sched.submit([7, 7, 7], sp, priority="interactive")
        shed = settled(q2)
        counts = sched.stats.counters()
        drain(sched, running + [q1, hi])
        return (bounced, shed, counts, sched.overload.activations(),
                [settled(h) for h in running + [q1, hi]])

    bounced, shed, counts, acts, _ = both(run)
    assert bounced[:3] == ("OverloadedError", "queue_full", "best_effort")
    assert shed[:3] == ("OverloadedError", "queue_full", "best_effort")
    assert counts["rejected_queue_full"] == 2 and acts["sheds"] == 1


def test_preemption_victim_is_lowest_priority():
    def run(side):
        eng = engine(side, slots=2, num_blocks=6)[0]
        sched, _ = make_sched(side, eng)
        sp = side.SamplingParams(max_new_tokens=24)
        hb = sched.submit([1] * 6, sp, priority="best_effort")
        hi = sched.submit([2] * 6, sp, priority="interactive")
        drain(sched, [hb, hi])
        return ([settled(hb), settled(hi)], hb._request.preemptions,
                hi._request.preemptions, sched.preemptions, sched.capacity.preempt_reclaims)

    _, pb, pi, total, _ = both(run)
    assert pi == 0 and pb == total > 0


def test_spec_cap_mid_stream_is_byte_exact():
    def run(side):
        eng = engine(side)[0]
        sp = side.SamplingParams(max_new_tokens=16)
        prompt = [7, 8, 9, 7, 8, 9, 7, 8]
        ref, _ = make_sched(side, eng)
        href = ref.submit(list(prompt), sp)
        drain(ref, [href])
        sched, _ = make_sched(side, eng)
        spec = side.SpeculationConfig(enabled=True, k=3, adaptive=False)
        h = sched.submit(prompt, sp, speculation=spec)
        ladder = sched.overload.ladder
        steps = 0
        while not h.done() and steps < 500:
            if steps == 3:
                ladder._level = 1  # cap k
            elif steps == 6:
                ladder._level = 2  # disable drafting
            sched.step()
            steps += 1
        return settled(href), settled(h), sched.overload.spec_cap(), steps

    ref, got, cap, _ = both(run)
    assert got == ref and cap == 0


def test_max_new_clamp_applies_to_new_admissions_only():
    def run(side):
        cfg = side_overload(side).OverloadConfig(
            max_new_caps={"interactive": None, "standard": 4, "best_effort": 2})
        sched, _ = make_sched(side, engine(side)[0], overload=cfg)
        sp = side.SamplingParams(max_new_tokens=10)
        before = sched.submit([1, 2, 3], sp, priority="standard")
        sched.overload.ladder._level = 3
        hs = [sched.submit([4, 5, 6 + k], sp, priority=p)
              for k, p in enumerate(("standard", "best_effort", "interactive"))]
        sched.overload.ladder._level = 0
        drain(sched, [before] + hs)
        return [settled(h) for h in [before] + hs]

    lens = [len(t) for t in both(run)]
    assert lens == [10, 4, 2, 10]


def test_level4_sheds_queued_best_effort():
    def run(side):
        sched, _ = make_sched(side, engine(side)[0])
        sp = side.SamplingParams(max_new_tokens=2)
        running = [sched.submit([1, 2, 3], sp) for _ in range(3)]
        hb = sched.submit([9, 9, 9], sp, priority="best_effort")
        sched.overload.ladder._level = 4
        refused = rejection(lambda: sched.submit([8, 8, 8], sp, priority="best_effort"))
        sched.step()
        shed = settled(hb)
        sched.overload.ladder._level = 0
        drain(sched, running)
        return refused, shed, sched.overload.rejections(), [settled(h) for h in running]

    refused, shed, rej, _ = both(run)
    assert refused[1] == shed[1] == "degraded"
    assert rej["by_reason"]["degraded"] == 2


@pytest.mark.parametrize("deadline_s", [0.5, 2.0])
def test_infeasible_fast_fail_pinned_roofline(deadline_s):
    def run(side):
        sched, _ = make_sched(side, engine(side)[0])
        sched.overload.ttft_predictor = lambda n, depth: 1.0  # pinned roofline
        sp = side.SamplingParams(max_new_tokens=2)
        box = {}
        rej = rejection(lambda: box.setdefault(
            "h", sched.submit([1, 2, 3], sp, deadline_s=deadline_s)))
        if "h" in box:
            drain(sched, [box["h"]])
        return (rej, settled(box["h"]) if "h" in box else None,
                sched.overload.activations(), sched.stats.get("rejected_infeasible"))

    rej, tokens, acts, n = both(run)
    if deadline_s < 1.0:
        assert rej[:2] == ("InfeasibleError", "infeasible") and rej[4] == 1.0
        assert acts["infeasible"] == 1 == n and tokens is None
    else:
        assert rej is None and tokens


def side_overload(side):
    """The side's overload module (the harness carries the others)."""
    if side is JAX:
        from flexflow_tpu.serving import overload
    else:
        from flexflow_tpu_torch.serving import overload
    return overload


def test_serving_admission_fault_site():
    def run(side):
        sched, _ = make_sched(side, engine(side)[0])
        sp = side.SamplingParams(max_new_tokens=2)
        plan = side.faults.FaultPlan(seed=0)
        plan.on(side.faults.SERVING_ADMISSION, mode="error",
                error=side.resilience.OverloadedError(
                    "forced", reason="limiter", priority="standard", retry_after_s=2.0),
                nth=(0,))
        with plan.active():
            rej = rejection(lambda: sched.submit([1, 2, 3], sp))
            h = sched.submit([1, 2, 3], sp)
        drain(sched, [h])
        return rej, plan.fired(side.faults.SERVING_ADMISSION), settled(h)

    rej, fired, tokens = both(run)
    assert rej[:2] == ("OverloadedError", "limiter") and fired == 1 and tokens


def test_overload_machinery_inert_off_pressure_path():
    def run(side):
        sched, clock = make_sched(side, engine(side)[0])
        sp = side.SamplingParams(max_new_tokens=4)
        hs = [sched.submit([i + 1, i + 2, i + 3], sp) for i in range(6)]
        for _ in range(200):
            if all(h.done() for h in hs):
                break
            sched.step()
            clock.advance(0.05)  # cross limiter intervals while serving
        return sched.overload.activations(), [settled(h) for h in hs]

    acts, _ = both(run)
    assert not any(acts.values())


# ------------------------------------------------------- observability
def _trace_view(d):
    """A trace dict without the per-process request id."""
    return {k: v for k, v in d.items() if k != "request_id"}


@pytest.mark.parametrize("overlap", [True, False])
def test_trace_latency_decomposition(overlap):
    def run(side):
        sched, clock = make_sched(side, engine(side)[0], overlap=overlap)
        h = sched.submit([1, 2, 3], side.SamplingParams(max_new_tokens=4), transport="http")
        clock.advance(1.0)  # queued for exactly 1s
        sched.step()  # admit + prefill
        clock.advance(0.5)
        sched.step()
        clock.advance(0.5)
        while not h.done():
            if not sched.step():
                break
        tr = h.trace
        return (settled(h), tr.queue_time_s, tr.ttft_s, tr.tpot_s,
                _trace_view(h.trace_dict()),
                {k: v["count"] for k, v in sched.stats.window_snapshots().items()},
                sched.trace_ring.get(tr.request_id) is tr)

    _, q, ttft, _, d, _, in_ring = both(run)
    assert q == ttft == 1.0 and d["outcome"] == "completed" and in_ring


@pytest.mark.parametrize("overlap", [True, False])
def test_observability_off_gives_identical_streams(overlap):
    def run(side):
        outs = {}
        for obs in (True, False):
            sched, _ = make_sched(side, engine(side)[0], observability=obs, overlap=overlap)
            hs = [sched.submit(p, side.SamplingParams(max_new_tokens=6, temperature=t, seed=s))
                  for p, t, s in (([1, 2, 3], 0.0, 0), ([7, 6, 5, 4], 0.8, 3))]
            drain(sched, hs)
            outs[obs] = ([settled(h) for h in hs], len(sched.trace_ring),
                         len(sched.flight.snapshot()) > 0)
        return outs

    outs = both(run)
    assert outs[True][0] == outs[False][0]
    assert outs[False][1:] == (0, False) and outs[True][1:] == (2, True)


def test_quarantine_attaches_flight_snapshot():
    def run(side):
        import numpy as np

        sched, _ = make_sched(side, engine(side)[0], overlap=False)
        plan = side.faults.FaultPlan(seed=0)
        plan.on("generation.decode_step", mode="nan", nth=(0,),
                select=lambda v: np.ones_like(np.asarray(v[1]), bool))
        with plan.active():
            h = sched.submit([1, 2, 3], side.SamplingParams(max_new_tokens=6))
            drain(sched, [h], steps=50)
        err = h.future.exception(timeout=0)
        snap = err.flight_snapshot
        tr = sched.trace_ring.get(h.trace.request_id)
        return (outcome(h), snap["kind"], [r["kind"] for r in snap["records"]],
                tr.outcome, [e[1] for e in tr.events])

    _, kind, records, tr_outcome, events = both(run)
    assert kind == "quarantine" and "decode" in records
    assert tr_outcome == "PoisonedRequestError" and "quarantine" in events


def test_restart_incident_contains_failing_step():
    def run(side):
        sched, _ = make_sched(side, engine(side)[0], overlap=False)
        plan = side.faults.FaultPlan(seed=0)
        plan.on("generation.decode_step", mode="error",
                error=RuntimeError("injected device crash"), nth=(1, 2))
        with plan.active():
            h = sched.submit([4, 5, 6], side.SamplingParams(max_new_tokens=8))
            drain(sched, [h], steps=100)
        restarts = [i for i in sched.flight.incidents if i["kind"] == "restart"]
        tr = sched.trace_ring.get(h.trace.request_id)
        return (settled(h), [r["kind"] for r in restarts[-1]["records"]], tr.replays,
                [e[1] for e in tr.events], sorted({r["kind"] for r in sched.flight.snapshot()}))

    tokens, records, replays, events, kinds = both(run)
    assert len(tokens) == 8 and "step_failed" in records and replays >= 1
    assert "replay" in events and "recovery" in kinds
