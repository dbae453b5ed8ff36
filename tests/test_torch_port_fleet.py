"""The port's fleet tier (``flexflow_tpu_torch/serving/fleet.py``, the
scheduler's failover sink and scoped step, ``runtime/faults.replica_kill``)
against the JAX package's, on the CPU at ``tests/test_fleet.py``'s
geometry (1 layer, hidden 16, vocab 40) on virtual clocks with
synchronous ``fleet.step()``.

Each of ``tests/test_fleet.py``'s fourteen cases runs once through a JAX
fleet and once through a port fleet (``torch_port_fleet.both``) under the
same prompts, samplings and ``FaultPlan``; the port must give the same
streams (greedy, seeded temperature, speculative), the same
``FleetStats`` counters and router decisions by reason, the same replica
states and queue depths after each lifecycle step, the same recovery
counters, and the same ``/v2/fleet``, ``/v2/fleet/autoscale`` and fleet
families of ``/metrics`` (apart from process clocks and ids). The port
runs the plain paged attention on the CPU."""
import pytest

from conftest import FakeClock
from torch_port_fleet import (
    BLOCK,
    JAX,
    PORT,
    PROMPTS,
    Session,
    both,
    drive,
    fleet_view,
    make_fleet,
    outcome,
    scrub,
    solo_reference,
)

pytestmark = [pytest.mark.torch_port, pytest.mark.fleet]


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    yield
    for side in (JAX, PORT):
        assert side.faults.active_plan() is None, "a test leaked an installed FaultPlan"


def test_port_fleet_module_imports_no_jax():
    import subprocess
    import sys

    code = ("import sys, flexflow_tpu_torch.serving.fleet; "
            "assert 'jax' not in sys.modules; "
            "assert not any(m == 'flexflow_tpu' or m.startswith('flexflow_tpu.') "
            "for m in sys.modules)")
    subprocess.run([sys.executable, "-c", code], check=True)


# ---------------------------------------------------------------------------
# router placement (no stepping)
# ---------------------------------------------------------------------------


def _affinity_ties(side, sess):
    g = side.greedy()
    a, b = [7] * BLOCK, [5] * BLOCK
    f = make_fleet(side, sess, n=2, warmup=False)
    f.submit(a + [1], g)
    f.submit(b + [2], g)
    f.submit(b + [9, 9], g)
    first = fleet_view(f)
    f.submit(a + [3], g)
    f.submit([5, 5, 5, 1, 2, 3], g)
    return first, fleet_view(f)


def test_router_prefix_affinity_wins_ties():
    first, last = both(_affinity_ties)
    assert first["stats"]["router_decisions"] == {"least_loaded": 2, "affinity": 1}
    assert [r[2] for r in first["replicas"]] == [1, 2]
    assert last["stats"]["router_decisions"]["affinity"] == 1
    assert last["replicas"][0][2] == 3


def _radix_affinity(side, sess):
    template = [3] * (2 * BLOCK)
    f = make_fleet(side, sess, n=2, warmup=False)
    r0, r1 = f.replicas
    h = r1.model.submit(template + [4], side.greedy())
    while not h.done():
        f.step()
    resident = r1.engine.prefix_cache.resident_blocks
    f.submit(template + [9], side.greedy())
    out = (resident, fleet_view(f), f.router.affinity(r1, template + [9]),
           f.router.affinity(r0, template + [9]), outcome(h))
    f.stop()
    return out


def test_router_affinity_scores_radix_index():
    resident, view, a1, a0, _ = both(_radix_affinity)
    assert resident == 2 and (a1, a0) == (2 * BLOCK, 0)
    assert view["stats"]["router_decisions"] == {"affinity": 1}


def _skew(side, sess):
    f = make_fleet(side, sess, n=2, warmup=False)
    f.submit([3, 3, 3, 1], side.greedy())
    f.submit([3, 3, 3, 2], side.greedy())
    return fleet_view(f)


def test_router_least_loaded_under_skew():
    view = both(_skew)
    assert view["stats"]["router_decisions"] == {"least_loaded": 2}


def _draining_or_open(side, sess):
    f = make_fleet(side, sess, n=2, warmup=False)
    r0, r1 = f.replicas
    f.drain(r0, reason="test")
    for _ in range(3):
        f.submit([1, 2, 3], side.greedy())
    r1.model.breaker.trip()
    with pytest.raises(side.resilience.CircuitOpenError):
        f.submit([1, 2, 3], side.greedy())
    return fleet_view(f)


def test_router_never_places_on_draining_or_open():
    view = both(_draining_or_open)
    assert view["stats"]["router_decisions"] == {"only_candidate": 3, "no_candidate": 1}


# ---------------------------------------------------------------------------
# cross-replica journal-replay failover
# ---------------------------------------------------------------------------


def _failover_mixed(side, sess):
    S = side.SamplingParams
    spec = side.SpeculationConfig(k=3, method="ngram")
    prompts = [[1, 2, 3], [4, 5, 6, 7], [1, 2, 3, 8], [9, 8, 7, 6, 5], [1, 2, 3, 8, 8]]
    samp = [S(max_new_tokens=12), S(max_new_tokens=12),
            S(max_new_tokens=10, temperature=0.8, top_k=10, seed=42),
            S(max_new_tokens=10, temperature=0.7, top_k=8, seed=7),
            S(max_new_tokens=10)]
    specs = [None, None, None, None, spec]
    ref = [solo_reference(side, sess, [p], [s], speculation=sp)[0]
           for p, s, sp in zip(prompts, samp, specs)]
    f = make_fleet(side, sess, n=2, recovery=side.policy(max_restarts=1))
    plan = side.faults.FaultPlan(seed=0)
    side.faults.replica_kill(plan, "r0", every=1)
    side.faults.replica_kill(plan, "r0", site="generation.verify", every=1)
    with plan.active():
        handles = [f.submit(p, s, speculation=sp) for p, s, sp in zip(prompts, samp, specs)]
        placed = fleet_view(f)
        drive(f.step, handles)
    return {
        "ref": ref, "streams": [outcome(h) for h in handles], "placed": placed,
        "after": fleet_view(f), "replays": [h._request.replays for h in handles],
        "sites": plan.site_counters(),
    }


def test_failover_mixed_streams_exact():
    out = both(_failover_mixed)
    assert out["streams"] == out["ref"]
    fs = out["after"]["stats"]
    assert (fs["failovers"], fs["migrated_streams"], fs["replaced"]) == (1, 3, 1)
    assert out["after"]["states"] == {"active": 2, "draining": 0, "dead": 0}
    assert "r0" not in [r[0] for r in out["after"]["replicas"]]


def _held_queue(side, sess):
    samp = [side.greedy()] * len(PROMPTS)
    ref = solo_reference(side, sess, PROMPTS, samp)
    f = make_fleet(side, sess, n=1, recovery=side.policy(max_restarts=1))
    plan = side.faults.FaultPlan(seed=0)
    side.faults.replica_kill(plan, "r0", every=1)
    plan.on("fleet.replica_spawn", mode="error", error=RuntimeError("spawn infra down"),
            nth=(0,))
    with plan.active():
        handles = [f.submit(p, s) for p, s in zip(PROMPTS, samp)]
        drive(f.step, handles)
    view = fleet_view(f)
    new_engine = f.replicas[0].engine
    h2 = f.submit([2, 4, 6], side.greedy())
    drive(f.step, [h2])
    return {"ref": ref, "streams": [outcome(h) for h in handles], "view": view,
            "fresh": outcome(h2), "recompiles": new_engine.recompiles(),
            "decode_sigs": new_engine.trace_counts["decode"]}


def test_held_queue_survives_full_replacement():
    out = both(_held_queue)
    assert out["streams"] == out["ref"]
    fs = out["view"]["stats"]
    assert (fs["failovers"], fs["replaced"], fs["spawn_failures"]) == (1, 1, 1)
    assert [r[0] for r in out["view"]["replicas"]] == ["r2"]
    assert out["recompiles"] == {} and out["decode_sigs"] == 1


def _pending_deadline(side, sess):
    clock = FakeClock()
    f = make_fleet(side, sess, n=1, recovery=side.policy(max_restarts=1), clock=clock,
                   auto_replace=False, warmup=False)
    plan = side.faults.FaultPlan(seed=0)
    side.faults.replica_kill(plan, "r0", every=1)
    with plan.active():
        h1 = f.submit(PROMPTS[0], side.greedy(), deadline_s=30.0)
        h2 = f.submit(PROMPTS[1], side.greedy(), deadline_s=30.0)
        for _ in range(40):
            f.step()
    held = (h1.done(), h2.done(), fleet_view(f))
    clock.advance(31.0)
    f.check()
    snap = f.stats.snapshot()
    return held, [outcome(h) for h in (h1, h2)], len(f._pending), \
        {k: snap[k] for k in ("admitted", "expired", "failed", "completed")}


def test_pending_deadline_expires_without_replica():
    held, outs, pending, snap = both(_pending_deadline)
    assert held[:2] == (False, False) and held[2]["pending"] == 2
    assert outs == ["DeadlineExceededError"] * 2 and pending == 0
    assert snap["admitted"] == 2 and snap["expired"] == 2


# ---------------------------------------------------------------------------
# drain / replace lifecycle
# ---------------------------------------------------------------------------


def _watchdog_drain(side, sess):
    ref = solo_reference(side, sess, PROMPTS[:2], [side.greedy()] * 2)
    f = make_fleet(side, sess, n=2)
    h_res = f.submit(PROMPTS[0], side.greedy())
    f.step()
    r0 = next(r for r in f.replicas if r.scheduler.has_work())
    old_engine, resets0 = r0.engine, r0.engine.resets
    r0.scheduler.recovery_stats.incr("watchdog_trips")
    f.check()
    drained = (r0.state, fleet_view(f))
    h_new = f.submit(PROMPTS[1], side.greedy())
    drive(f.step, [h_res, h_new])
    survivor_ids = [r.id for r in f.replicas]
    new = [r for r in f.replicas if r.engine is not old_engine and r.id != "r1"]
    return {
        "ref": ref, "streams": [outcome(h_res), outcome(h_new)], "drained": drained,
        "resets": old_engine.resets - resets0, "replays": h_res._request.replays,
        "view": fleet_view(f), "ids": survivor_ids,
        "new_decode": [r.engine.trace_counts.get("decode") for r in new],
        "new_recompiles": [r.engine.recompiles() for r in new],
    }


def test_watchdog_drain_completes_residents_then_replaces():
    out = both(_watchdog_drain)
    assert out["streams"] == out["ref"]
    assert out["drained"][0] == "draining" and out["drained"][1]["stats"]["drains"] == 1
    assert out["resets"] == 0 and out["replays"] == 0
    assert out["view"]["stats"]["replaced"] == 1 and out["view"]["stats"]["failovers"] == 0
    assert out["new_decode"] == [1] and out["new_recompiles"] == [{}]


def _breaker_open(side, sess):
    clock = FakeClock()
    f = make_fleet(side, sess, n=2, warmup=False, clock=clock, drain_timeout_s=10.0)
    r0, r1 = f.replicas
    h = f.submit(PROMPTS[0], side.greedy())
    r0.model.breaker.trip()
    states = []
    for _ in range(2):
        f.check()
        states.append(r0.state)
    clock.advance(11.0)
    f.check()
    return states, h.done(), len(r1.scheduler._queue), r0 in f.replicas, fleet_view(f)


def test_breaker_open_drains_and_rescues_held_queue():
    states, done, r1_queue, r0_kept, view = both(_breaker_open)
    assert states == ["active", "draining"] and not done and r1_queue == 1
    assert not r0_kept
    fs = view["stats"]
    assert (fs["replaced"], fs["migrated_streams"], fs["failovers"]) == (1, 1, 0)


def _drain_timeout(side, sess):
    clock = FakeClock()
    f = make_fleet(side, sess, n=2, warmup=False, clock=clock, drain_timeout_s=5.0)
    ref = solo_reference(side, sess, PROMPTS[:1], [side.greedy()])
    h = f.submit(PROMPTS[0], side.greedy())
    f.step()
    r0 = next(r for r in f.replicas if r.scheduler.has_work())
    f.drain(r0, reason="test")
    clock.advance(6.0)
    f.check()
    retired = (r0 in f.replicas, r0.state, f.states(), h.done())
    drive(f.step, [h])
    f.check()
    return ref, outcome(h), retired, r0 in f._retiring, r0.state, fleet_view(f)


def test_drain_timeout_retires_without_aborting_residents():
    ref, stream, retired, still_retiring, final_state, view = both(_drain_timeout)
    assert stream == ref[0]
    assert retired == (False, "retiring",
                       {"active": 2, "draining": 0, "dead": 0, "retiring": 1}, False)
    assert not still_retiring and final_state == "dead"
    assert view["stats"]["replaced"] == 1


def _quarantine_storm(side, sess):
    f = make_fleet(side, sess, n=2, warmup=False)
    r0 = f.replicas[0]
    r0.scheduler.recovery_stats.incr("quarantined", 2)
    f.check()
    states = [r0.state]
    r0.scheduler.stats.incr("completed")
    r0.scheduler.recovery_stats.incr("quarantined", 2)
    f.check()
    states.append(r0.state)
    r0.scheduler.recovery_stats.incr("quarantined")
    f.check()
    return states, r0 in f.replicas, fleet_view(f)


def test_quarantine_storm_drains_replica():
    states, kept, view = both(_quarantine_storm)
    assert states == ["active", "active"] and not kept
    assert (view["stats"]["drains"], view["stats"]["replaced"]) == (1, 1)


# ---------------------------------------------------------------------------
# single-replica parity
# ---------------------------------------------------------------------------


def _single_replica(side, sess):
    g = side.greedy()
    bare = side.GenerationModel(sess.engine(), name="solo", recovery=side.policy(),
                                clock=FakeClock(), max_queue=4)
    f = make_fleet(side, sess, n=1, scheduler_kwargs=dict(max_queue=4))
    hb = bare.submit(PROMPTS[0], g)
    while not hb.done() and bare.scheduler.step():
        pass
    hf = f.submit(PROMPTS[0], g)
    drive(f.step, [hf])
    keys = (sorted(bare.stats.snapshot()), sorted(f.stats.snapshot()))
    errors = []
    for model in (bare, f):
        for call in (lambda: model.submit([1] * 100, g),
                     lambda: model.submit(PROMPTS[0], g, deadline_s=-1.0)):
            try:
                call()
                errors.append(None)
            except Exception as e:  # noqa: BLE001 - the typed error IS the result
                errors.append(type(e).__name__)
    for _ in range(4):
        bare.submit(PROMPTS[0], g)
        f.submit(PROMPTS[0], g)
    for model in (bare, f):
        with pytest.raises(side.resilience.QueueFullError):
            model.submit(PROMPTS[0], g)
    recompiles = (f.replicas[0].engine.recompiles(), bare.engine.recompiles())
    bare.stop(drain=False)
    f.stop(drain=False)
    for model in (bare, f):
        with pytest.raises(side.resilience.ShuttingDownError):
            model.submit(PROMPTS[0], g)
    return outcome(hb), outcome(hf), keys, errors, recompiles


def test_single_replica_parity():
    hb, hf, keys, errors, recompiles = both(_single_replica)
    assert hb == hf and keys[0] == keys[1]
    assert errors == ["ValueError", "DeadlineExceededError"] * 2
    assert recompiles == ({}, {})


# ---------------------------------------------------------------------------
# observability surfaces
# ---------------------------------------------------------------------------


def _fleet_lines(text):
    return sorted(line for line in text.splitlines()
                  if "fleet" in line or "router_decisions" in line or "autoscale" in line)


def _prom_and_reports(side, sess):
    f = make_fleet(side, sess, n=2, warmup=False, name="gen")
    for p in PROMPTS[:3]:
        f.submit(p, side.greedy())
    models = {("gen", r.id): r.model.stats for r in f.replicas}
    text = side.prom.render_prometheus(models, fleets={"gen": f.prom_fleet()})
    assert not side.prom.validate_exposition(text)
    tricky = side.prom.render_prometheus({("m\"x", "r\\0"): f.replicas[0].model.stats})
    assert not side.prom.validate_exposition(tricky)
    assert 'model="m\\"x",replica="r\\\\0"' in tricky
    admitted = [line for line in text.splitlines()
                if line.startswith("flexflow_serving_requests_total") and "admitted" in line]
    return _fleet_lines(text), sorted(admitted), scrub(f.report()), \
        scrub(f.autoscale_report())


def test_fleet_prometheus_and_reports():
    lines, admitted, report, autoscale = both(_prom_and_reports)
    assert 'flexflow_serving_fleet_replicas{model="gen",state="active"} 2' in lines
    assert 'flexflow_serving_fleet_failovers_total{model="gen"} 0' in lines
    assert any('replica="r0"' in line for line in admitted)
    assert {r["id"] for r in report["replicas"]} == {"r0", "r1"}
    assert autoscale["signal"] == 0 and set(autoscale["replicas"]) == {"r0", "r1"}


def _server_endpoints(side, sess):
    f = make_fleet(side, sess, n=2, warmup=False, name="gen")
    server = side.InferenceServer(port=0)
    server.register_generation(f)
    text = server.metrics_text()
    assert not side.prom.validate_exposition(text)
    ready = [server.model_ready("gen")]
    f.replicas[0].model.breaker.trip()
    ready.append(server.model_ready("gen"))
    f.replicas[1].model.breaker.trip()
    ready.append(server.model_ready("gen"))
    keys = server._all_stats() if side is JAX else server._metric_units()
    return (sorted(list(k) for k in keys),
            _fleet_lines(text), scrub(server.fleet_report()),
            scrub(server.autoscale_report()), ready)


def test_server_integration_fleet_endpoints():
    keys, lines, report, autoscale, ready = both(_server_endpoints)
    assert keys == [["gen", "r0"], ["gen", "r1"]]
    assert ready == [True, True, False]
    assert len(report["models"]["gen"]["replicas"]) == 2
    assert set(autoscale["models"]["gen"]["replicas"]) == {"r0", "r1"}
    assert 'flexflow_serving_fleet_replicas{model="gen",state="active"} 2' in lines


def test_server_units_label_replicas_and_filter():
    """The port's per-engine reports walk a fleet's replicas as
    ``name/replica`` units; ``?model=name`` matches them all and
    ``?model=name/r1`` one (the JAX server's ``_generation_units``)."""
    sess = Session(PORT)
    f = make_fleet(PORT, sess, n=2, warmup=False, name="gen")
    server = PORT.InferenceServer(port=0)
    server.register_generation(f)
    j = make_fleet(JAX, Session(JAX), n=2, warmup=False, name="gen")
    jserver = JAX.InferenceServer(port=0)
    jserver.register_generation(j)
    assert [label for label, _ in server._units()] == \
        [label for label, _ in jserver._generation_units()] == ["gen/r0", "gen/r1"]
    assert list(server.debug_cache(model="gen/r1")["models"]) == ["gen/r1"]
    assert sorted(server.overload_report(model="gen")["models"]) == ["gen/r0", "gen/r1"]
    assert sorted(server.slo_report()["models"]) == ["gen/r0", "gen/r1"]
    text = server.metrics_text()
    assert 'flexflow_serving_requests_total{model="gen",replica="r1"' in text


def _http_generate(side, sess):
    """One JSON and one SSE generate request over loopback to a 2-replica
    fleet behind the side's InferenceServer: (status, tokens or error)."""
    import json
    import time
    import urllib.error
    import urllib.request

    f = make_fleet(side, sess, n=2, warmup=False, name="gen", clock=time.monotonic)
    srv = side.InferenceServer(port=0)
    srv.register_generation(f)
    srv.start()
    out = []
    try:
        for stream in (False, True):
            body = json.dumps({"prompt": PROMPTS[2], "max_new_tokens": 12,
                               "stream": stream}).encode()
            req = urllib.request.Request(f"http://127.0.0.1:{srv.port}/v2/models/gen/generate",
                                         data=body, headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req, timeout=60) as r:
                    text = r.read().decode()
                if stream:
                    events = [json.loads(ln[len("data: "):]) for ln in text.splitlines()
                              if ln.startswith("data: ")]
                    out.append((200, events[-1]["tokens"]))
                else:
                    out.append((200, json.loads(text)["tokens"]))
            except urllib.error.HTTPError as e:
                out.append((e.code, json.loads(e.read())["error"]))
    finally:
        srv.stop()
    return out


def test_http_generate_on_a_fleet():
    """``POST /v2/models/{name}/generate`` on a fleet: the port's server
    routes it through the fleet's router and streams the single-engine
    reference (JSON and SSE). The JAX server answers 400 for the same
    request: its Fleet has no ``response_format_from`` (a discrepancy
    inside the reference, pinned here; ROADMAP queue 3)."""
    ref = solo_reference(PORT, Session(PORT), [PROMPTS[2]], [PORT.greedy()])[0]
    assert _http_generate(PORT, Session(PORT)) == [(200, ref), (200, ref)]
    got = _http_generate(JAX, Session(JAX))
    assert [code for code, _ in got] == [400, 400]
    assert all("response_format_from" in err for _, err in got)
