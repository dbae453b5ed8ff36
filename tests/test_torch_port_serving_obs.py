"""The port's serving statistics, observability units and overload
controller (``flexflow_tpu_torch/serving/stats.py``, ``obs/*``,
``serving/overload.py``) against the JAX package's: each unit is fed the
same event sequence on a virtual clock in both packages and must give
equal snapshots; the port's Prometheus rendering of the golden fixtures,
built from port classes by the recipe of ``tests/test_observability.py``,
must equal ``tests/data/prometheus_golden.txt`` byte for byte."""
import os
import types

import pytest

import test_observability as jgold
from conftest import FakeClock
from flexflow_tpu.generation.cache import BlockAllocator as JBlockAllocator
from flexflow_tpu.generation.cache import CacheConfig as JCacheConfig
from flexflow_tpu.obs import capacity as jcapacity
from flexflow_tpu.obs import flight as jflight
from flexflow_tpu.obs import prom as jprom
from flexflow_tpu.obs import slo as jslo
from flexflow_tpu.obs import steptrace as jsteptrace
from flexflow_tpu.obs import trace as jtrace
from flexflow_tpu.obs import truth as jtruth
from flexflow_tpu.serving import overload as joverload
from flexflow_tpu.serving import stats as jstats
from flexflow_tpu_torch.generation.cache import BlockAllocator, CacheConfig
from flexflow_tpu_torch.generation.recovery import RecoveryStats
from flexflow_tpu_torch.obs import capacity, flight, prom, slo, steptrace, trace, truth
from flexflow_tpu_torch.serving import overload, stats

pytestmark = pytest.mark.torch_port

# (JAX module, port module) pairs; a scenario takes one module of each kind
JAX = types.SimpleNamespace(stats=jstats, trace=jtrace, flight=jflight, slo=jslo,
                            steptrace=jsteptrace, truth=jtruth, capacity=jcapacity,
                            overload=joverload, CacheConfig=JCacheConfig,
                            BlockAllocator=JBlockAllocator)
PORT = types.SimpleNamespace(stats=stats, trace=trace, flight=flight, slo=slo,
                             steptrace=steptrace, truth=truth, capacity=capacity,
                             overload=overload, CacheConfig=CacheConfig,
                             BlockAllocator=BlockAllocator)

LATENCIES = [0.5, 0.25, 3.0, 0.125, 0.75, 0.0625, 1.5, 0.375, 2.0, 0.03125, 5.0]


def both(scenario):
    """The scenario's result in each package; they must be equal."""
    j, p = scenario(JAX), scenario(PORT)
    assert p == j
    return p


# ------------------------------------------------------------------ stats
@pytest.mark.parametrize("n", [1, 2, 5, len(LATENCIES)])
def test_latency_window_nearest_rank(n):
    def run(m):
        w = m.stats.LatencyWindow(maxlen=8)
        for i, v in enumerate(LATENCIES[:n]):
            w.record(v, exemplar=f"j{i}" if i % 2 else None)
        return w.snapshot(), w.slow_exemplars(4)

    snap, _ = both(run)
    assert snap["count"] == n


@pytest.mark.parametrize("buckets", [None, (0.1, 1.0), (0.001, 0.01, 0.1, 10.0)])
def test_histogram_buckets(buckets):
    def run(m):
        h = m.stats.Histogram(buckets=buckets)
        for v in LATENCIES:
            h.observe(v)
        return h.snapshot()

    snap = both(run)
    assert snap["buckets"][-1] == (float("inf"), len(LATENCIES))


def test_serving_stats_and_registered_counters():
    def run(m):
        s = m.stats.ServingStats(latency_window=4)
        s.incr("admitted", 3)
        s.incr("rejected_limiter")
        for v in LATENCIES:
            s.observe("ttft", v)
        spec, good, con = m.stats.SpeculationStats(), m.stats.GoodputStats(), \
            m.stats.ConstrainedStats()
        for obj in (spec, good, con):
            obj.register_gauges(s)
        spec.record_window(proposed=4, accepted=3, emitted=4)
        spec.record_window(proposed=2, accepted=0, emitted=1)
        good.record(8, good=True)
        good.record(3, good=False)
        con.incr("masked_steps", 5)
        con.incr("grammar_compile_seconds", 0.25)
        rate = m.stats.TokenRate(clock=FakeClock(10.0), window_s=4.0)
        rate.record(12)
        return s.snapshot(), s.window_p95("ttft"), rate.rate(), rate.total

    both(run)
    # one RecoveryStats class under both import paths, with the JAX fields
    assert stats.RecoveryStats is RecoveryStats
    assert RecoveryStats.FIELDS == jstats.RecoveryStats.FIELDS


# ------------------------------------------------------------------ traces
def _trace_events(m, clock, rid):
    tr = m.trace.RequestTrace(rid, clock=clock, progress_every=2)
    tr.mark_accept(prompt_len=5, deadline_s=2.0, speculative=False)
    tr.mark_transport("http")
    clock.advance(0.25)
    tr.mark_admit(slot=0, prompt_len=5, preemptions=0, replays=0)
    tr.note_tokens(1, "prefill")
    for _ in range(5):
        clock.advance(0.125)
        tr.note_tokens(1, "decode")
    tr.note_speculation(4, 2)
    tr.note_preempt()
    tr.note_replay()
    tr.event("cache_wait", wait_s=0.5, blocks_short=2, blame="queued")
    return tr


@pytest.mark.parametrize("outcome", ["completed", "PoisonedRequestError"])
def test_trace_ring(outcome):
    def run(m):
        clock = FakeClock()
        ring = m.trace.TraceRing(capacity=2)
        for rid in (11, 12, 13):
            tr = _trace_events(m, clock, rid)
            err = None if outcome == "completed" else RuntimeError("poisoned")
            tr.mark_finish(outcome, err)
            ring.add(tr)
        return ([t.to_dict() for t in ring.recent(5)], ring.get(11), len(ring),
                ring.get(13).to_dict(), m.trace.NULL_TRACE.to_dict())

    recent, evicted, n, _, _ = both(run)
    assert evicted is None and n == 2 and len(recent) == 2


# ------------------------------------------------------------ flight ring
@pytest.mark.parametrize("capacity", [3, 16])
def test_flight_recorder_chrome_trace(capacity):
    def run(m):
        clock, sched_clock = FakeClock(100.0), FakeClock(5.0)
        fr = m.flight.FlightRecorder(capacity=capacity, clock=clock, incident_window=4,
                                     sched_clock=sched_clock)
        for i in range(6):
            clock.advance(0.01)
            sched_clock.advance(1.0)
            fr.record_step("decode" if i % 3 else "prefill",
                           phases={"schedule": 0.001, "device": 0.002 * (i + 1)},
                           execute_s=0.002, occupancy=i, queue_depth=1, blocks_free=9 - i)
            if i == 3:
                fr.record_event("step_failed", step="decode", error="boom")
        inc = fr.incident("quarantine", request_id=7)
        return (fr.snapshot(), fr.snapshot(last=2), fr.to_chrome_trace(pid=2, name="lm"),
                inc, fr.incident_snapshots(), fr.seq)

    both(run)


# -------------------------------------------------------------------- SLO
def test_slo_burn_rates():
    def run(m):
        clock = FakeClock()
        mon = m.slo.SLOMonitor(clock=clock, fast_window_s=10.0, slow_window_s=60.0)
        out = []
        seq = [("completed", 0.5, 0.01), ("completed", 4.0, 0.02),
               ("DeadlineExceededError", None, None), ("completed", 0.25, 0.5),
               ("ShuttingDownError", None, None), ("completed", 3.0, 0.01)]
        for i, (oc, ttft, tpot) in enumerate(seq * 3):
            mon.observe(oc, ttft_s=ttft, tpot_s=tpot)
            clock.advance(2.5)
            if i % 4 == 3:
                out.append((mon.snapshot(), mon.breaching(), mon.healthy(),
                            [mon.burn_rate(o.name, w) for o in mon.objectives
                             for w in ("fast", "slow")]))
        return out

    both(run)


# ----------------------------------------------------------- step anatomy
def test_step_anatomy():
    def run(m):
        an = m.steptrace.StepAnatomy(enabled=True, window=8, min_steps=2)
        an.arm_capture(3)
        t = 0.0
        for i in range(10):
            kind = ("decode", "verify", "admit")[i % 3]
            spans = [("schedule", t, t + 0.0005), ("dispatch", t + 0.0005, t + 0.001),
                     ("block", t + 0.001, t + 0.003), ("execute", t + 0.001, t + 0.003),
                     ("readback", t + 0.003, t + 0.0035), ("bookkeep", t + 0.0035, t + 0.004)]
            an.observe_step(kind, spans, t, t + 0.004 + 0.001 * (i % 2), tokens=4,
                            hot=i != 5)
            t += 0.01
        return (an.report(), an.prom_snapshot(), an.to_chrome_trace(name="lm"),
                an.captured_steps(), an.steps_observed())

    both(run)


# ----------------------------------------------------------- truth ledger
def test_prediction_ledger():
    def run(m):
        alarms = []
        led = m.truth.PredictionLedger(clock=FakeClock(), min_samples=3)
        led.on_alarm = alarms.append
        led.predict("decode", 0.25, label="decode (chip)", provenance="roofline")
        for v in (0.25, 0.375, 0.5, 0.75, 0.5):
            led.measure("decode", v)
        led.observe("prefill[16]", 0.125, 0.125, label="prefill", provenance="roofline",
                    alarm=False)
        led.measure("unpredicted", 0.5)
        return led.report(), led.error_summary(), led.scrape_snapshot(), alarms

    report, _, _, alarms = both(run)
    assert alarms and report["counters"]["pairs_total"] >= 6


# ------------------------------------------------------- cache telemetry
def test_cache_telemetry():
    def run(m):
        clock = FakeClock()
        cc = m.CacheConfig(num_layers=1, num_heads=2, head_dim=4, block_size=4, num_blocks=9)
        alloc = m.BlockAllocator(cc)
        tel = m.capacity.CacheTelemetry(alloc, clock=clock, pressure_threshold=0.25,
                                        reclaimable=lambda: 1)
        req = types.SimpleNamespace(id=3, n_generated=2, preemptions=1)
        a, b = alloc.allocate(3), alloc.allocate(3)
        running = [types.SimpleNamespace(req=req, slot=1, blocks=a, cached_len=9,
                                         shared_idx={0})]
        out = []
        for _ in range(3):
            tel.tick()
            clock.advance(0.5)
            out.append(tel.under_pressure)
        tel.note_preempt(3)
        tel.note_trim(1)
        blame = tel.note_admission_wait(0.125, 2)
        alloc.free(b)
        tel.tick()
        adm = types.SimpleNamespace(id=4, n_generated=0, preemptions=0)
        rep = tel.report(running, queue_depth=2, admitting=(adm, [7]), prefix={"x": 1})
        st = m.stats.ServingStats()
        tel.register_gauges(st, lambda: running)
        return out, blame, rep, tel.fragmentation_slots(running), st.gauge_values()

    both(run)


# ---------------------------------------------------------------- overload
def _limiter_run(m, hot_steps, cfg_kw):
    clock = FakeClock()
    hot = {"on": True}
    lim = m.overload.AdaptiveLimiter(
        m.overload.OverloadConfig(**cfg_kw), clock=clock, slots=4, max_queue=32,
        queue_depth=lambda: 32 if hot["on"] else 0,
        queue_p95=lambda: 9.9 if hot["on"] else 0.0, ttft_p95=lambda: 0.0,
        cache_pressure=lambda: False,
    )
    out = [lim.limit]
    lim.tick()
    for i in range(hot_steps + 40):
        if i == hot_steps:
            hot["on"] = False
        clock.advance(1.0)
        out.append((lim.tick(), lim.limit))
    acq = [lim.try_acquire(p) for p in ("best_effort", "standard", "interactive") * 4]
    return out, acq, lim.snapshot(), lim.counts()


@pytest.mark.parametrize("hot_steps,cfg_kw", [
    (12, dict(limiter_interval_s=1.0, min_limit=4)),
    (3, dict(limiter_interval_s=1.0, md_factor=0.75, additive_step=2.0)),
    (0, dict(limiter_interval_s=2.0)),
])
def test_adaptive_limiter_aimd(hot_steps, cfg_kw):
    both(lambda m: _limiter_run(m, hot_steps, cfg_kw))


@pytest.mark.parametrize("pressures", [
    [1.0] * 10 + [0.5, 0.5] + [0.0] * 40,
    [1.0, 0.0, 1.0, 1.0, 0.95, 0.2, 0.9, 1.0] * 4,
])
def test_degrade_ladder_hysteresis_and_caps(pressures):
    def run(m):
        clock = FakeClock()
        moves = []
        cfg = m.overload.OverloadConfig(up_hold_s=1.0, down_hold_s=3.0)
        ladder = m.overload.DegradeLadder(cfg, clock=clock,
                                          on_transition=lambda o, n, p: moves.append((o, n)))
        out = []
        for p in pressures:
            ladder.update(p)
            clock.advance(0.5)
            out.append((ladder.level, ladder.spec_cap(), ladder.max_new_cap("standard"),
                        ladder.max_new_cap("best_effort"), ladder.shed_best_effort()))
        return out, moves, ladder.history(), ladder.snapshot()

    both(run)


# --------------------------------------------------------------- prometheus
def _rebind(fn, **names):
    """``fn`` with some of its globals replaced: the golden recipe of
    tests/test_observability.py, building port classes."""
    return types.FunctionType(fn.__code__, {**fn.__globals__, **names}, fn.__name__)


def test_prometheus_golden_from_port_classes():
    golden_stats = _rebind(jgold._golden_stats, ServingStats=stats.ServingStats)
    golden_replica = _rebind(jgold._golden_replica_stats, ServingStats=stats.ServingStats)
    golden_anatomy = _rebind(jgold._golden_anatomy, StepAnatomy=steptrace.StepAnatomy)
    golden_ledger = _rebind(jgold._golden_ledger, PredictionLedger=truth.PredictionLedger)
    latency = _rebind(jgold._golden_handoff_latency, Histogram=stats.Histogram)()
    fleet = dict(jgold._GOLDEN_FLEET)
    fleet["handoff"] = dict(fleet["handoff"], latency=latency)
    s = golden_stats()
    assert type(s) is stats.ServingStats
    text = prom.render_prometheus(
        {"lm": s, ("gen", "r0"): golden_replica()},
        fault_sites={"generation.decode_step": {"calls": 5, "fires": 1}},
        ledger=golden_ledger(),
        fleets={"gen": fleet},
        anatomy={"lm": golden_anatomy()},
    )
    assert not prom.validate_exposition(text)
    with open(os.path.join(os.path.dirname(__file__), "data", "prometheus_golden.txt")) as f:
        assert text == f.read()


@pytest.mark.parametrize("name", ['mo"del\\with\nnewline', "plain"])
def test_prometheus_label_escaping_and_validation(name):
    def run(m):
        mod = jprom if m is JAX else prom
        s = m.stats.ServingStats()
        s.incr("admitted")
        s.observe("ttft", 0.25)
        text = mod.render_prometheus({name: s})
        return text, mod.validate_exposition(text), mod.escape_label_value(name)

    text, errors, escaped = both(run)
    assert not errors and f'model="{escaped}"' in text
