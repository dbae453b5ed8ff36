"""Request journeys of the port (``flexflow_tpu_torch/obs/journey.py``,
the scheduler's hops and the server's traceparent ingress and
``/v2/debug/journey``) against the JAX package's, on the CPU.

traceparent parsing over one table of inputs; the context chain,
snapshot/restore and the inert null journey, run through both packages
with span ids numbered by appearance; ``stitch`` and the chrome://tracing
and OTLP renderings of the same fixed-id spans (equal dicts); the on-disk
spool's ring bound and torn tail (the same bytes on disk, each package
reading the other's), and the index's merge of ring and spool without a
double count. Over HTTP, a port and a JAX ``InferenceServer`` on the
same weights take the same request with a client ``traceparent``: the
journey id, the egress header's trace id, and the stitched hop names and
lanes of ``/v2/debug/journey/{id}`` must be equal. Journeys off is inert
and byte-exact, and a warm restart keeps each stream's journey identity,
its stitched hops equal to the JAX package's."""
import contextlib
import json
import os
import urllib.request

import pytest

from conftest import FakeClock
from flexflow_tpu import obs as jobs
from flexflow_tpu.serving import InferenceServer as JInferenceServer
from flexflow_tpu.serving import durable as jdurable
from flexflow_tpu.serving.generation import GenerationModel as JGenerationModel
from flexflow_tpu_torch import obs
from flexflow_tpu_torch.obs.trace import NULL_TRACE
from flexflow_tpu_torch.serving import durable
from flexflow_tpu_torch.serving import GenerationModel, InferenceServer
from torch_port_chaos import JAX, PORT, engine

pytestmark = [pytest.mark.torch_port, pytest.mark.journey]

# tests/test_journey.py's config
JCFG = dict(num_layers=1, hidden_size=16, num_heads=2, ff_size=32, seq_length=64,
            vocab_size=40, causal=True)
PROMPTS = [[1, 2, 3], [4, 5, 6, 7], [9, 8, 7, 6, 5], [1, 2, 3, 4, 4]]
GREEDY = dict(max_new_tokens=8)
REMOTE_TRACE = "0af7651916cd43dd8448eb211c80319c"
REMOTE_SPAN = "b7ad6b7169203331"
REMOTE_TP = f"00-{REMOTE_TRACE}-{REMOTE_SPAN}-01"
PACKAGES = {"jax": jobs, "port": obs}


def make_engine(side):
    return engine(side, cfg=JCFG)[0]


def drive(sched, handles, steps=500):
    for _ in range(steps):
        if all(h.done() for h in handles):
            return
        if not sched.step():
            return


def assert_gap_free(journey):
    """Exactly one root, every other span's parent in the stitched set."""
    assert journey["complete"], journey
    assert journey["n_roots"] == 1
    ids = {s["span_id"] for s in journey["spans"]}
    dangling = [s for s in journey["spans"]
                if s["parent_id"] is not None and s["parent_id"] not in ids]
    assert len(dangling) <= 1, dangling  # the root may carry a remote parent


def shape(journey):
    """A stitched journey with its ids numbered by appearance (random
    ids differ between runs), its times and attributes dropped."""
    ids = {}

    def n(x):
        return None if x is None else ids.setdefault(x, len(ids))

    return {
        "complete": journey["complete"], "n_spans": journey["n_spans"],
        "n_roots": journey["n_roots"], "lanes": journey["lanes"],
        "spans": [(s["name"], s["lane"], n(s["span_id"]), n(s["parent_id"]))
                  for s in journey["spans"]],
    }


# ---------------------------------------------------------------------------
# no engine: traceparent, the context chain, stitch, renderings, the spool
# ---------------------------------------------------------------------------

TRACEPARENTS = [
    REMOTE_TP, f"  {REMOTE_TP.upper()}  ", None, "", "garbage", "00-xyz-abc-01",
    f"ff-{REMOTE_TRACE}-{REMOTE_SPAN}-01", f"00-{'0' * 32}-{REMOTE_SPAN}-01",
    f"00-{REMOTE_TRACE}-{'0' * 16}-01", f"00-{REMOTE_TRACE[:-2]}-{REMOTE_SPAN}-01",
    f"01-{REMOTE_TRACE}-{REMOTE_SPAN}-00", f"00-{REMOTE_TRACE}-{REMOTE_SPAN}-01-extra",
]


@pytest.mark.parametrize("header", TRACEPARENTS)
def test_traceparent_parse_same(header):
    got = obs.parse_traceparent(header)
    assert got == jobs.parse_traceparent(header)
    if got is not None:
        assert obs.format_traceparent(*got) == jobs.format_traceparent(*got)
        assert obs.parse_traceparent(obs.format_traceparent(*got)) == got
    if header in TRACEPARENTS[:2]:
        assert got == (REMOTE_TRACE, REMOTE_SPAN)


def _chain(m):
    clock = FakeClock()
    rec = m.JourneyRecorder(lane="r0", clock=clock)
    ctx = rec.mint(parent=m.parse_traceparent(REMOTE_TP))
    assert ctx.journey_id == REMOTE_TRACE and ctx.remote_parent
    s1 = ctx.hop("ingress", transport="http")
    clock.advance(0.5)
    s2 = ctx.hop("submit")
    spans = rec.spans(REMOTE_TRACE)
    assert spans[0].parent_id == REMOTE_SPAN and spans[1].parent_id == s1
    assert ctx.traceparent() == m.format_traceparent(REMOTE_TRACE, s2)
    snap = ctx.snapshot()
    restored = m.JourneyContext.restore(snap)
    restored.recorder = rec
    restored.hop("warm_restart")
    assert rec.spans(REMOTE_TRACE)[-1].parent_id == s2  # onto the pre-crash tip
    journey = m.stitch(REMOTE_TRACE, rec.spans(REMOTE_TRACE))
    assert_gap_free(journey)
    stats = rec.stats
    return (shape(journey), {k: v for k, v in snap.items() if k != "parent"},
            restored.hops, [(s.t0, s.t1, s.attrs) for s in rec.spans()],
            {f: getattr(stats, f) for f in stats.FIELDS})


def test_context_chain_snapshot_restore_same():
    assert _chain(obs) == _chain(jobs)


def test_null_journey_is_inert():
    for m in (obs, jobs):
        nj = m.NULL_JOURNEY
        assert nj.hop("anything", key=1) is None and nj.traceparent() is None
        assert nj.snapshot() is None and nj.journey_id is None and nj.hops == 0


def _spans(m, spec, jid="a" * 32):
    """JourneySpans of ``spec``: (span index, parent index or a foreign
    id, name, lane, t0), ids fixed."""
    return [m.JourneySpan(jid, f"{i + 1:016x}",
                          (f"{p + 1:016x}" if isinstance(p, int) else p), name, lane,
                          t0, t0 + 0.25, {"i": i, "lane": lane})
            for i, p, name, lane, t0 in spec]


STITCH_CASES = {
    "chain": [(0, None, "submit", "r0", 0.0), (1, 0, "admit", "r0", 1.0),
              (2, 1, "prefill", "r0", 2.0), (3, 2, "finish", "r1", 3.0)],
    "missing_mid_span": [(0, None, "submit", "r0", 0.0),
                         (2, 1, "prefill", "r0", 2.0), (3, 2, "finish", "r0", 3.0)],
    "remote_root": [(0, REMOTE_SPAN, "ingress", "http", 0.5), (1, 0, "submit", "r0", 0.7)],
    "branches": [(0, None, "submit", "r0", 0.0), (1, 0, "admit", "r0", 2.0),
                 (2, 0, "replay", "r1", 1.0), (3, 2, "adopt", "r1", 1.5)],
    "out_of_order": [(3, 2, "finish", "r0", 3.0), (1, 0, "admit", "http", 1.0),
                     (2, 1, "prefill", "r0", 2.0), (0, None, "submit", "http", 0.0)],
}


@pytest.mark.parametrize("case", list(STITCH_CASES))
def test_stitch_and_renderings_same(case):
    """Fixed-id spans: the same stitched journey, chrome://tracing and
    OTLP renderings; a missing mid-chain span splits the tree."""
    out = {}
    for name, m in PACKAGES.items():
        journey = m.stitch("a" * 32, _spans(m, STITCH_CASES[case]))
        out[name] = (journey, m.journey_to_chrome_trace(journey), m.journey_to_otlp(journey))
    assert out["port"] == out["jax"]
    journey = out["port"][0]
    if case == "missing_mid_span":
        assert not journey["complete"] and journey["n_roots"] == 2
    else:
        assert_gap_free(journey)
    lanes = {rs["resource"]["attributes"][1]["value"]["stringValue"]
             for rs in out["port"][2]["resourceSpans"]}
    assert lanes == set(journey["lanes"])


def _span(m, i, jid="j" * 32):
    return m.JourneySpan(jid, f"{i:016x}", None, f"hop{i}", "r0", float(i), float(i) + 0.5,
                         {"i": i})


def _tree(d):
    return {n: open(os.path.join(d, n), "rb").read() for n in sorted(os.listdir(d))}


def test_spool_ring_bound_same_bytes(tmp_path):
    dirs = {}
    for name, m in PACKAGES.items():
        d = dirs[name] = str(tmp_path / name)
        spool = m.JourneySpool(d, max_bytes=4096, segment_bytes=1024)
        for i in range(200):
            spool.append(_span(m, i))
        spool.close()
    assert _tree(dirs["port"]) == _tree(dirs["jax"])
    total = sum(len(b) for b in _tree(dirs["port"]).values())
    assert total <= 4096 + 1024
    # each package scans the other's spool
    for writer, reader in (("jax", "port"), ("port", "jax")):
        spans, torn = PACKAGES[reader].JourneySpool(dirs[writer]).scan()
        got = [s.attrs["i"] for s in spans]
        assert torn == 0 and got == sorted(got) and 199 in got and 0 not in got


def test_spool_torn_tail_truncated_and_counted(tmp_path):
    out = {}
    for name, m in PACKAGES.items():
        d = str(tmp_path / name)
        stats = m.JourneyStats()
        spool = m.JourneySpool(d, stats=stats)
        for i in range(3):
            spool.append(_span(m, i))
        spool.close()
        (seg,) = [f for f in os.listdir(d) if f.endswith(".seg")]
        with open(os.path.join(d, seg), "ab") as f:
            f.write(b"\x40\x00\x00\x00\xde\xad\xbe\xefcrash")  # a torn frame
        spans, torn = spool.scan()
        spans2, torn2 = spool.scan()  # truncated in place: a clean rescan
        out[name] = ([s.to_dict() for s in spans], torn, stats.spool_truncated,
                     [s.to_dict() for s in spans2], torn2, _tree(d))
    assert out["port"] == out["jax"]
    assert out["port"][1:3] == (1, 1) and out["port"][4] == 0
    assert [s["attrs"]["i"] for s in out["port"][0]] == [0, 1, 2]


def test_index_merges_ring_and_spool_without_double_count(tmp_path):
    for name, m in PACKAGES.items():
        spool = m.JourneySpool(str(tmp_path / name))
        try:
            rec = m.JourneyRecorder(lane="r0", clock=FakeClock(), spool=spool)
            ctx = rec.mint()
            ctx.hop("submit")
            ctx.hop("admit")  # both hops in the ring AND the spool
            journey = m.JourneyIndex(recorders=[rec], spools=[spool]).get(ctx.journey_id)
            assert journey["n_spans"] == 2 == ctx.hops
            assert_gap_free(journey)
            from_spool = m.JourneyIndex(spools=[spool]).get(ctx.journey_id)  # the ring is gone
            assert from_spool["n_spans"] == 2
            assert_gap_free(from_spool)
            assert shape(from_spool) == shape(journey)
        finally:
            spool.close()


# ---------------------------------------------------------------------------
# HTTP ingress, against the JAX server
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def served():
    """{"jax": base URL, "port": base URL} of two servers on one weight set."""
    servers = {"jax": JInferenceServer(port=0), "port": InferenceServer(port=0)}
    servers["jax"].register_generation(JGenerationModel(make_engine(JAX), name="lm"))
    servers["port"].register_generation(GenerationModel(make_engine(PORT), name="lm"))
    try:
        for srv in servers.values():
            srv.start()
        yield {k: f"http://127.0.0.1:{srv.port}" for k, srv in servers.items()}
    finally:
        for srv in servers.values():
            srv.stop()


def _post(base, body, traceparent=None):
    headers = {"Content-Type": "application/json"}
    if traceparent is not None:
        headers["traceparent"] = traceparent
    req = urllib.request.Request(f"{base}/v2/models/lm/generate",
                                 data=json.dumps(body).encode(), headers=headers)
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.headers, r.read().decode()


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=30) as r:
        return json.loads(r.read())


@pytest.mark.parametrize("stream", [False, True], ids=["json", "sse"])
def test_http_traceparent_in_out_and_debug_endpoint(served, stream):
    trace = ("ab" if stream else "cd") * 16
    tp = f"00-{trace}-{REMOTE_SPAN}-01"
    out = {}
    for name, base in served.items():
        hdrs, text = _post(base, {"prompt": [1, 2, 3], "max_new_tokens": 6, "stream": stream},
                           traceparent=tp)
        body = json.loads(text.strip().split("\n\n")[-1].split("data: ", 1)[1]) if stream \
            else json.loads(text)
        assert body["journey_id"] == trace  # the client's trace id IS the journey id
        assert obs.parse_traceparent(hdrs["traceparent"])[0] == trace
        dbg = _get(base, f"/v2/debug/journey/{trace}")
        journey = dbg["journey"]
        assert_gap_free(journey)
        assert dbg["chrome_trace"]["traceEvents"] and dbg["otlp"]["resourceSpans"]
        assert trace in _get(base, "/v2/debug/journey")["journeys"]
        # a malformed header roots locally, never fails the request
        _, bad = _post(base, {"prompt": [4, 5], "max_new_tokens": 4}, traceparent="ff-bogus")
        local = json.loads(bad)["journey_id"]
        assert local and local != trace
        out[name] = (shape(journey), body["tokens"], [
            (e["name"], e["args"]["lane"]) for e in dbg["chrome_trace"]["traceEvents"]
            if e["ph"] == "X"])
    assert out["port"] == out["jax"]
    names = [s[0] for s in out["port"][0]["spans"]]
    assert names == ["ingress", "submit", "admit", "prefill", "finish"]
    assert out["port"][0]["lanes"][0] == "http" and len(out["port"][0]["lanes"]) == 2


def test_slow_exemplars_link_to_journeys(served):
    """The latency windows keep journey ids as exemplars, and
    /v2/debug/journey?slow= lists only ids that stitch."""
    base = served["port"]
    _post(base, {"prompt": [3, 1, 2], "max_new_tokens": 5})
    listing = _get(base, "/v2/debug/journey?slow=p99")
    assert listing["journeys"] and set(listing["slow"]["lm"]) >= {"ttft", "queue_time"}
    for jid in listing["journeys"]:
        assert_gap_free(_get(base, f"/v2/debug/journey/{jid}")["journey"])


# ---------------------------------------------------------------------------
# off switches, warm restart
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kwargs,traced", [
    ({"observability": False}, False), ({"journeys": False}, True),
], ids=["observability_off", "journeys_off"])
def test_journeys_off_is_inert_and_byte_exact(kwargs, traced):
    ref = [list(make_engine(JAX).generate([list(p)], JAX.SamplingParams(**GREEDY))[0])
           for p in PROMPTS]
    eng = make_engine(PORT)
    sched = PORT.Scheduler(eng, recovery=PORT.no_sleep(), clock=FakeClock(), **kwargs)
    assert sched.journeys is None
    handles = [sched.submit(p, PORT.SamplingParams(**GREEDY)) for p in PROMPTS]
    reqs = [h._request for h in handles]
    assert all(r.journey is obs.NULL_JOURNEY for r in reqs)
    assert all((r.trace is not NULL_TRACE) == traced for r in reqs)
    drive(sched, handles)
    assert [h.result(0) for h in handles] == ref
    assert all(r.journey is obs.NULL_JOURNEY for r in reqs)
    assert sched.journey_stats.spans == 0
    used = eng.allocator.num_total - eng.allocator.num_free
    assert used == eng.prefix_cache.resident_blocks  # every block back or in the index


def paths(journey):
    """A stitched journey as the sorted (lane, name) paths from its root
    to each span: sibling branches order by span id when their t0 tie (a
    virtual clock), and span ids are random."""
    by_id = {s["span_id"]: s for s in journey["spans"]}

    def path(s):
        out = []
        while s is not None:
            out.append((s["lane"], s["name"]))
            s = by_id.get(s["parent_id"])
        return tuple(reversed(out))

    return sorted(path(s) for s in journey["spans"])


def _warm_restart_journeys(side, mod, d):
    """Three streams, abandoned after 5 steps, warm-restarted by a new
    scheduler of the same package; the stitched journey of each adopted
    stream from the successor's ring and the spool alone."""
    sched = side.Scheduler(make_engine(side), recovery=side.no_sleep(), clock=FakeClock())
    dead = mod.Durability(sched, mod.DurabilityConfig(wal_dir=d, fsync=False))
    with contextlib.ExitStack() as stack:
        stack.callback(dead.close)
        handles = [sched.submit(p, side.SamplingParams(**GREEDY)) for p in PROMPTS[:3]]
        for _ in range(5):
            sched.step()
        assert any(not h.done() for h in handles)
        pre = {tuple(h._request.original_prompt): h._request.journey.journey_id
               for h in handles}
        sched2 = side.Scheduler(make_engine(side), recovery=side.no_sleep(), clock=FakeClock())
        dur2 = mod.Durability(sched2, mod.DurabilityConfig(wal_dir=d, fsync=False))
        stack.callback(dur2.close)
        dur2.warm_restart()
        adopted = [e.req for e in sched2.journal.entries()]
        assert adopted
        drive(sched2, [r.handle for r in adopted])
        m = obs if side is PORT else jobs
        index = m.JourneyIndex().add(sched2.journeys).add_spool(dur2.journey_spool)
        out = {}
        for req in adopted:
            jid = req.journey.journey_id
            assert jid == pre[tuple(req.original_prompt)]  # identity survived the process
            journey = index.get(jid)
            assert_gap_free(journey)
            out[tuple(req.original_prompt)] = paths(journey)
        return out


def test_warm_restart_keeps_journey_identity(tmp_path):
    out = {side.name: _warm_restart_journeys(side, mod, str(tmp_path / side.name))
           for side, mod in ((JAX, jdurable), (PORT, durable))}
    assert out["port"] == out["jax"]
    for journey in out["port"].values():
        names = [p[-1][1] for p in journey]
        for hop in ("submit", "admit", "adopt", "warm_restart", "finish"):
            assert hop in names, names
        # the restart's hops parent onto the pre-crash chain
        assert (("local", "submit"), ("local", "adopt"), ("local", "warm_restart")) in journey


# ---------------------------------------------------------------------------
# one journey stitched across replicas: failover and the KV handoff
# ---------------------------------------------------------------------------


def _fleet_journeys(fside, sess, disagg):
    """tests/test_journey.py's failover (a 2-replica fleet whose r0 dies)
    or disaggregated-handoff (1+1 pools) case on ``fside``: each stream's
    stitched journey over the fleet's recorders, as its (lane, name)
    paths, with the attempted-hop count."""
    from torch_port_fleet import drive as fdrive
    from torch_port_fleet import make_disagg, make_fleet

    m = obs if fside.name == "port" else jobs
    if disagg:
        f = make_disagg(fside, sess)
        prompts = PROMPTS[:2]
        handles = [f.submit(p, fside.greedy()) for p in prompts]
        fdrive(f.step, handles)
    else:
        f = make_fleet(fside, sess, n=2, warmup=True,
                       recovery=fside.policy(max_restarts=1))
        prompts = PROMPTS
        plan = fside.faults.FaultPlan(seed=0)
        fside.faults.replica_kill(plan, "r0", every=1)
        with plan.active():
            handles = [f.submit(p, fside.greedy()) for p in prompts]
            fdrive(f.step, handles)
        assert f.fleet_stats.snapshot()["failovers"] == 1
    assert all(h.done() for h in handles)
    index = m.JourneyIndex(recorders=f.journey_recorders())
    out = {}
    for h in handles:
        req = h._request
        journey = index.get(req.journey.journey_id)
        assert_gap_free(journey)
        assert journey["n_spans"] == req.journey.hops  # every attempted hop stitched
        out[tuple(req.original_prompt)] = (paths(journey), journey["lanes"])
    f.stop()
    return out


def test_failover_yields_single_stitched_journey():
    from torch_port_fleet import both

    out = both(_fleet_journeys, False)
    migrated = 0
    for journey, lanes in out.values():
        names = [p[-1][1] for p in journey]
        if "failover" in names:
            migrated += 1
            assert "adopt" in names
            assert len(lanes) >= 3, lanes  # router lane + both schedulers
    assert migrated >= 1


def test_disagg_handoff_yields_single_stitched_journey():
    from torch_port_fleet import both

    out = both(_fleet_journeys, True)
    for journey, lanes in out.values():
        names = [p[-1][1] for p in journey]
        for hop in ("kv_handoff_pack", "kv_handoff", "adopt", "finish"):
            assert hop in names, names
        assert any(lane.startswith("p") for lane in lanes), lanes
        assert any(lane.startswith("d") for lane in lanes), lanes
