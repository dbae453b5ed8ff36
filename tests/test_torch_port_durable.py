"""Durable serving of the port (``flexflow_tpu_torch/runtime/wal.py``,
``serving/durable.py`` and the scheduler's journal hooks) against the JAX
package's, on the CPU at a 1-layer width-16 config.

The WAL is held to the same bytes: ``encode_record`` frames, and whole
segment directories written by the same operations through each
package's ``WriteAheadLog`` (torn tails, typed mid-file corruption,
rotation and reaping, predecessor segments kept until recovered, the
commit frontier), each read back by the OTHER package's ``scan_wal``
with the same records and torn counts. ``replay_streams`` folds the same
records the same way, and ``engine_fingerprint`` gives one digest for
one configuration in both. The port scheduler's journal records (admit,
tok, end) equal the JAX scheduler's record by record, apart from the
durable ids, wall times and journey snapshots. A warm restart after an
abandoned scheduler (the state SIGKILL leaves) is byte-exact against the
JAX engine's solo streams, greedy and seeded, and a WAL the JAX
scheduler left mid-decode is warm-restarted by the port into the JAX
streams. The fingerprint refusal, append-failure degradation, both
deadline cases (FakeClock) and the SSE resume events of the two servers
are compared the same way. Every Durability is closed in a ``finally``:
its WAL's commit thread is joined there."""
import contextlib
import json
import os
import shutil
import urllib.error
import urllib.request

import pytest

from conftest import FakeClock
from flexflow_tpu.runtime import wal as jwal
from flexflow_tpu.serving import durable as jdurable
from flexflow_tpu.serving import InferenceServer as JInferenceServer
from flexflow_tpu.serving.generation import GenerationModel as JGenerationModel
from flexflow_tpu_torch.runtime import wal
from flexflow_tpu_torch.serving import durable
from flexflow_tpu_torch.serving import GenerationModel, InferenceServer
from torch_port_chaos import JAX, PORT, engine

pytestmark = [pytest.mark.torch_port, pytest.mark.durable]

# tests/test_durable.py's config
DCFG = dict(num_layers=1, hidden_size=16, num_heads=2, ff_size=32, seq_length=64,
            vocab_size=40, causal=True)
PROMPTS = [[1, 2, 3], [4, 5, 6, 7], [9, 8, 7, 6, 5]]
GREEDY = dict(max_new_tokens=12)
SEEDED = dict(max_new_tokens=12, temperature=0.8, top_k=10, seed=42)
WALL = 1000.0  # a fixed header wall time: the two packages' segments are then byte-equal
SIDES = {"jax": (JAX, jwal, jdurable), "port": (PORT, wal, durable)}


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    yield
    for side in (JAX, PORT):
        assert side.faults.active_plan() is None, "a test leaked an installed FaultPlan"


def make_engine(side):
    return engine(side, cfg=DCFG)[0]


def make_sched(side, eng=None, clock=None, overlap=True):
    return side.Scheduler(eng if eng is not None else make_engine(side),
                          recovery=side.no_sleep(), clock=clock or FakeClock(), overlap=overlap)


def drive(sched, handles, steps=500):
    for _ in range(steps):
        if all(h.done() for h in handles):
            return
        if not sched.step():
            return


@contextlib.contextmanager
def closing(*durs):
    try:
        yield
    finally:
        for d in durs:
            d.close()


_REF = {}


def solo_reference(prompts, samplings):
    """Each request alone through the JAX engine."""
    out = []
    for p, s in zip(prompts, samplings):
        key = (tuple(p), tuple(sorted(s.items())))
        if key not in _REF:
            _REF[key] = list(make_engine(JAX).generate([list(p)], JAX.SamplingParams(**s))[0])
        out.append(_REF[key])
    return out


# ---------------------------------------------------------------------------
# WAL layer
# ---------------------------------------------------------------------------

RECORDS = [
    {"t": "admit", "id": "s1", "prompt": [1, 2], "generated": [], "wall_deadline": None},
    {"t": "tok", "id": "s1", "toks": [5, 6, 7]},
    {"t": "end", "id": "s1", "outcome": "completed"},
    {"t": "header", "v": 1, "seg": 3, "fp": "ab" * 32, "wall": 1234.5678},
    {"t": "admit", "id": "ü-ß", "sampling": {"temperature": 0.8, "top_k": 10, "seed": 42},
     "journey": {"id": "0" * 31 + "1", "parent": None, "hops": 2, "remote": True}},
]


@pytest.mark.parametrize("i", range(len(RECORDS)))
def test_encode_record_same_bytes(i):
    assert wal.encode_record(RECORDS[i]) == jwal.encode_record(RECORDS[i])


def _w_roundtrip(m, d):
    w = m.WriteAheadLog(d, fsync=False, fingerprint="fp-abc", wall_clock=lambda: WALL)
    for r in RECORDS[:3]:
        w.append(r)
    w.flush()
    w.close()
    with pytest.raises(m.WalError):
        w.append({"t": "tok", "id": "s1", "toks": [7]})
    w.close()  # idempotent
    return {}


def _w_torn(m, d):
    w = m.WriteAheadLog(d, fsync=False, wall_clock=lambda: WALL)
    w.append({"t": "admit", "id": "s1", "prompt": [1]})
    w.append({"t": "tok", "id": "s1", "toks": [9, 9]})
    w.flush()
    w.close()
    (_, path), = m.list_segments(d)
    frame = m.encode_record({"t": "tok", "id": "s1", "toks": [3]})
    with open(path, "ab") as f:
        f.write(frame[: len(frame) - 3])  # cut mid-payload
    return {}


def _w_corrupt(m, d):
    w = m.WriteAheadLog(d, fsync=False, wall_clock=lambda: WALL)
    w.append({"t": "admit", "id": "s1", "prompt": [1]})
    w.append({"t": "end", "id": "s1", "outcome": "completed"})
    w.flush()
    w.close()
    (_, path), = m.list_segments(d)
    with open(path, "rb") as f:
        data = bytearray(f.read())
    data[10] ^= 0xFF  # a payload byte of the first record, framed data after it
    with open(path, "wb") as f:
        f.write(bytes(data))
    return {}


def _w_rotation(m, d):
    w = m.WriteAheadLog(d, fsync=False, max_segment_bytes=256, wall_clock=lambda: WALL)
    obs = {}
    for i in range(8):
        w.append({"t": "admit", "id": f"s{i}", "prompt": [i] * 8})
        w.append({"t": "tok", "id": f"s{i}", "toks": [1, 2, 3]})
        w.append({"t": "end", "id": f"s{i}", "outcome": "completed"})
        w.flush()
    obs["rotated"] = (w.active_index, w.segment_count(), w.counters()["reaped_segments"])
    assert w.active_index > 0 and w.segment_count() <= 2 and obs["rotated"][2] >= 1
    w.append({"t": "admit", "id": "pinned", "prompt": [7] * 8})  # an open stream
    w.flush()
    seg = w.active_index
    for i in range(8, 16):
        w.append({"t": "admit", "id": f"s{i}", "prompt": [i] * 8})
        w.append({"t": "end", "id": f"s{i}", "outcome": "completed"})
        w.flush()
    assert w.active_index > seg
    obs["watermark"] = {k: v for k, v in w.watermark().items() if k != "commit_lag"}
    # fsync cycles follow the commit thread's timing: not compared
    obs["counters"] = {k: v for k, v in w.counters().items()
                       if k not in ("fsyncs", "fsync_p50_s")}
    w.close()
    return obs


def _w_predecessor(m, d):
    dead = m.WriteAheadLog(d, fsync=False, wall_clock=lambda: WALL)
    dead.append({"t": "admit", "id": "s1", "prompt": [1]})
    dead.flush()  # never closed until the end: a dead writer
    w = m.WriteAheadLog(d, fsync=False, wall_clock=lambda: WALL)
    assert w.active_index == dead.active_index + 1
    for i in range(4):
        w.append({"t": "admit", "id": f"n{i}", "prompt": [i]})
        w.append({"t": "end", "id": f"n{i}", "outcome": "completed"})
        w.flush()
    before = [idx for idx, _ in m.list_segments(d)]
    assert dead.active_index in before, "predecessor segment reaped early"
    w.mark_recovered()
    after = [idx for idx, _ in m.list_segments(d)]
    assert dead.active_index not in after
    w.close()
    dead.close()
    return {"before": before, "after": after}


def _w_frontier(m, d):
    # a pacing interval the committer does not reach before sync(): a
    # zero lag then proves sync() committed inline
    w = m.WriteAheadLog(d, fsync=True, commit_interval_s=0.5, wall_clock=lambda: WALL)
    try:
        w.append({"t": "admit", "id": "s1", "prompt": [1]})
        w.flush()
        w.sync()
        wm = w.watermark()
        assert wm["commit_lag"] == 0 and wm["unflushed"] == 0
        assert w.counters()["fsyncs"] >= 1
        return {"watermark": wm}
    finally:
        w.close()


WRITERS = {"roundtrip": _w_roundtrip, "torn_tail": _w_torn, "mid_file_corruption": _w_corrupt,
           "rotation_and_reap": _w_rotation, "predecessor_until_recovered": _w_predecessor,
           "commit_frontier": _w_frontier}


def _tree(d):
    return {name: open(os.path.join(d, name), "rb").read() for name in sorted(os.listdir(d))}


@pytest.mark.parametrize("case", list(WRITERS))
def test_segments_same_bytes_and_cross_read(tmp_path, case):
    """The same operations through each package's WriteAheadLog leave the
    same files with the same bytes and the same counters; each package's
    scan_wal then reads the other's segments into the same records and
    torn counts (a copy of each directory per reader: a scan truncates)."""
    dirs = {}
    obs = {}
    for name, (_, m, _) in SIDES.items():
        dirs[name] = str(tmp_path / f"{name}-wal")
        obs[name] = WRITERS[case](m, dirs[name])
    assert obs["port"] == obs["jax"]
    assert _tree(dirs["port"]) == _tree(dirs["jax"])
    for writer in SIDES:
        scans = {}
        for reader, (_, m, _) in SIDES.items():
            d = str(tmp_path / f"{writer}-by-{reader}")
            shutil.copytree(dirs[writer], d)
            try:
                scans[reader] = m.scan_wal(d) + (_tree(d),)
            except m.WalCorruptionError as e:
                scans[reader] = ("corrupt", str(e).replace(d, "<dir>"))
        assert scans["port"] == scans["jax"], (writer, case)
        if case == "mid_file_corruption":
            assert scans["port"][0] == "corrupt"
        if case == "torn_tail":
            assert scans["port"][1] == 1
            assert [r["t"] for r in scans["port"][0]] == ["header", "admit", "tok"]


REPLAY_CASES = {
    "readmit_wins": [
        {"t": "admit", "id": "a", "prompt": [1], "generated": []},
        {"t": "tok", "id": "a", "toks": [5]},
        {"t": "admit", "id": "a", "prompt": [1], "generated": [5]},
        {"t": "tok", "id": "a", "toks": [6, 7]},
        {"t": "admit", "id": "b", "prompt": [2], "generated": []},
        {"t": "end", "id": "b", "outcome": "completed"},
    ],
    "orphans_and_late_tokens": [
        {"t": "header", "v": 1, "seg": 0, "fp": "x", "wall": 0.0},
        {"t": "tok", "id": "gone", "toks": [1]},
        {"t": "end", "id": "gone", "outcome": "completed"},
        {"t": "admit", "id": "c", "prompt": [3], "generated": [4, 4]},
        {"t": "end", "id": "c", "outcome": "DeadlineExceededError"},
        {"t": "tok", "id": "c", "toks": [9]},
        {"t": "header", "v": 1, "seg": 1, "fp": "y", "wall": 1.0},
        {"t": "admit", "id": "d", "prompt": [5], "generated": []},
        {"t": "admit", "id": "c", "prompt": [3], "generated": [4, 4, 2]},
        {"t": "header", "v": 1, "seg": 2, "fp": "x", "wall": 2.0},
    ],
}


@pytest.mark.parametrize("case", list(REPLAY_CASES))
def test_replay_streams_same_order_and_dedup(case):
    records = REPLAY_CASES[case]

    def fold(m):
        return ([(s.admit, s.tokens, s.ended, s.outcome, s.order)
                 for s in m.replay_streams(records)], m.wal_fingerprints(records))

    assert fold(wal) == fold(jwal)
    if case == "readmit_wins":
        streams = {s.admit["id"]: s for s in wal.replay_streams(records)}
        assert streams["a"].tokens == [5, 6, 7] and not streams["a"].ended
        assert streams["b"].ended


# ---------------------------------------------------------------------------
# fingerprint, journal records, warm restart
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cfg,kw", [
    (DCFG, {}),
    (DCFG, {"kv_dtype": "BFLOAT16", "slots": 2, "num_blocks": 24}),
    (dict(DCFG, vocab_size=50), {}),
], ids=["base", "bf16_cache", "vocab50"])
def test_engine_fingerprint_same_digest(cfg, kw):
    fp = durable.engine_fingerprint(engine(PORT, cfg=cfg, **kw)[0])
    assert fp == jdurable.engine_fingerprint(engine(JAX, cfg=cfg, **kw)[0])
    assert len(fp) == 64


def _norm(records):
    """Records with durable ids numbered by first appearance, wall times
    and journey snapshots dropped."""
    ids = {}
    out = []
    for r in records:
        r = dict(r)
        if "id" in r:
            r["id"] = ids.setdefault(r["id"], len(ids))
        for k in ("wall", "wall_deadline", "journey"):
            r.pop(k, None)
        out.append(r)
    return out


def _journal_run(side, d, overlap):
    sched = make_sched(side, overlap=overlap)
    dur = side_durable(side).Durability(
        sched, side_durable(side).DurabilityConfig(wal_dir=d, fsync=False))
    with closing(dur):
        samps = [GREEDY, SEEDED, GREEDY]
        handles = [sched.submit(p, side.SamplingParams(**s)) for p, s in zip(PROMPTS, samps)]
        drive(sched, handles)
        results = [list(h.result(0)) for h in handles]
        dur.sync()
    return results, side_wal(side).scan_wal(d)


def side_durable(side):
    return durable if side is PORT else jdurable


def side_wal(side):
    return wal if side is PORT else jwal


@pytest.mark.parametrize("overlap", [True, False], ids=["overlap", "sequential"])
def test_journal_records_equal_jax(tmp_path, overlap):
    """The port scheduler journals the same admit, tok and end records, in
    the same order, as the JAX scheduler; the journal holds each stream."""
    got = {side.name: _journal_run(side, str(tmp_path / side.name), overlap)
           for side in (JAX, PORT)}
    (pres, (precs, ptorn)), (jres, (jrecs, jtorn)) = got["port"], got["jax"]
    assert pres == jres and ptorn == jtorn == 0
    assert _norm(precs) == _norm(jrecs)
    assert [r["t"] for r in precs].count("end") == 3
    streams = {s.admit["id"]: s for s in wal.replay_streams(precs)}
    by_prompt = {tuple(s.admit["prompt"]): s for s in streams.values()}
    for p, res in zip(PROMPTS, pres):
        assert by_prompt[tuple(p)].tokens == res and by_prompt[tuple(p)].ended
    admit = next(r for r in precs if r["t"] == "admit")
    assert admit["sampling"]["max_new_tokens"] == 12 and admit["max_new"] == 12
    assert admit["journey"]["id"] and admit["journey"]["hops"] >= 1


def _abandoned(side, d, samps, steps=5, clock=None, wall_clock=None, deadline_s=None,
               prompts=PROMPTS):
    """A scheduler with durability, stepped ``steps`` times and then
    abandoned (never closed: the state SIGKILL leaves). Returns (its
    Durability, handles)."""
    sched = make_sched(side, clock=clock)
    cfg = side_durable(side).DurabilityConfig(wal_dir=d, fsync=False,
                                              **({"wall_clock": wall_clock} if wall_clock else {}))
    dur = side_durable(side).Durability(sched, cfg)
    handles = [sched.submit(p, side.SamplingParams(**s), deadline_s=deadline_s)
               for p, s in zip(prompts, samps)]
    for _ in range(steps):
        sched.step()
    assert any(not h.done() for h in handles), "died too late to test replay"
    return dur, handles


@pytest.mark.parametrize("overlap", [True, False], ids=["overlap", "sequential"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_warm_restart_byte_exact(tmp_path, writer, overlap):
    """A WAL left by an abandoned scheduler (the port's, or the JAX
    package's) is warm-restarted by the port into the JAX engine's solo
    streams, greedy and seeded, the un-flushed tail regrown."""
    samps = [GREEDY, SEEDED, GREEDY]
    ref = solo_reference(PROMPTS, samps)
    d = str(tmp_path)
    dead, handles = _abandoned(SIDES[writer][0], d, samps)
    sched2 = make_sched(PORT, overlap=overlap)
    dur2 = durable.Durability(sched2, durable.DurabilityConfig(wal_dir=d, fsync=False))
    with closing(dur2, dead):
        replay = dur2.warm_restart()
        unfinished = sum(1 for h in handles if not h.done())
        assert replay["replayed_streams"] == unfinished
        assert replay["fingerprint"] == dead.fingerprint
        adopted = [e.req for e in sched2.journal.entries()]
        assert len(adopted) == unfinished
        drive(sched2, [r.handle for r in adopted])
        want = {tuple(p): t for p, t in zip(PROMPTS, ref)}
        for req in adopted:
            assert req.handle.result(0) == want[tuple(req.original_prompt)], "forked stream"
        assert dur2.report()["counters"]["replayed_streams"] == unfinished
        assert sched2.recovery_stats.replayed_tokens == replay["replayed_tokens"]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_fingerprint_mismatch_refuses_typed(tmp_path, writer):
    side = SIDES[writer][0]
    dead, _ = _abandoned(side, str(tmp_path), [GREEDY], steps=3, prompts=[[7, 7, 7]])
    other = engine(PORT, cfg=dict(DCFG, vocab_size=50))[0]  # the vocab drifted
    sched_b = make_sched(PORT, eng=other)
    dur_b = durable.Durability(sched_b, durable.DurabilityConfig(wal_dir=str(tmp_path),
                                                                 fsync=False))
    with closing(dur_b, dead):
        with pytest.raises(durable.FingerprintMismatchError) as ei:
            dur_b.warm_restart()
        assert ei.value.expected != ei.value.found == dead.fingerprint
        assert not sched_b.journal.entries()


def test_append_failure_degrades_one_stream(tmp_path):
    """A failed append takes ONE stream off the log, counted as in JAX;
    the streams and the other journals are untouched."""
    out = {}
    for side in (JAX, PORT):
        d = str(tmp_path / side.name)
        sched = make_sched(side)
        dur = side_durable(side).Durability(
            sched, side_durable(side).DurabilityConfig(wal_dir=d, fsync=False))
        with closing(dur):
            plan = side.faults.FaultPlan(seed=0)
            plan.on(side.faults.SERVING_WAL_APPEND, mode="error",
                    error=OSError("disk says no"), nth=(0,))
            with plan.active():
                handles = [sched.submit(p, side.SamplingParams(**GREEDY)) for p in PROMPTS]
                drive(sched, handles)
            dur.sync()
            records, _ = side_wal(side).scan_wal(d)
            out[side.name] = ([h.result(0) for h in handles], dur.journal.degraded_count(),
                              dur.stats.counts(), plan.site_counters(),
                              sum(s.ended for s in side_wal(side).replay_streams(records)))
    assert out["port"][:2] == out["jax"][:2] == (out["jax"][0], 1)
    # fsync cycles follow the commit thread's timing: not compared
    pc, jc = ({k: v for k, v in out[n][2].items() if k != "fsyncs"} for n in ("port", "jax"))
    assert pc == jc and pc["wal_append_failures"] == 1
    site = "serving.wal_append"
    assert out["port"][3][site] == out["jax"][3][site]
    assert out["port"][4] == out["jax"][4] == 2


def test_deadline_remaining_budget_survives_restart(tmp_path):
    """The journal stores the deadline as wall time: a 4 s down-window
    takes 4 s off a 30 s budget on the new scheduler's clock."""
    wall_c = FakeClock(1000.0)
    dead, handles = _abandoned(PORT, str(tmp_path), [GREEDY], steps=3, clock=FakeClock(0.0),
                               wall_clock=wall_c, deadline_s=30.0, prompts=[[1, 2, 3]])
    wall_c.advance(4.0)
    sclock2 = FakeClock(500.0)
    sched2 = make_sched(PORT, clock=sclock2)
    dur2 = durable.Durability(sched2, durable.DurabilityConfig(
        wal_dir=str(tmp_path), fsync=False, wall_clock=wall_c))
    with closing(dur2, dead):
        replay = dur2.warm_restart()
        assert replay["replayed_streams"] == 1 and not replay["expired_streams"]
        (req,) = [e.req for e in sched2.journal.entries()]
        assert req.deadline - sclock2() == pytest.approx(30.0 - 4.0)
        drive(sched2, [req.handle])
        assert req.handle.result(0) == solo_reference([[1, 2, 3]], [GREEDY])[0]


def test_deadline_expired_during_down_window(tmp_path):
    wall_c = FakeClock(1000.0)
    dead, _ = _abandoned(PORT, str(tmp_path), [GREEDY], steps=3, clock=FakeClock(0.0),
                         wall_clock=wall_c, deadline_s=10.0, prompts=[[4, 5, 6]])
    wall_c.advance(60.0)  # well past the 10 s budget
    sched2 = make_sched(PORT, clock=FakeClock(0.0))
    dur2 = durable.Durability(sched2, durable.DurabilityConfig(
        wal_dir=str(tmp_path), fsync=False, wall_clock=wall_c))
    with closing(dur2, dead):
        replay = dur2.warm_restart()
        assert replay["replayed_streams"] == 0 and len(replay["expired_streams"]) == 1
        assert not sched2.journal.entries()
        state, obj = dur2.lookup(replay["expired_streams"][0])
        assert state == "done" and obj["outcome"] == "expired" and len(obj["tokens"]) >= 1


# ---------------------------------------------------------------------------
# HTTP: SSE event ids and the resume endpoint, against the JAX server
# ---------------------------------------------------------------------------


def _sse(text):
    """[(event id or None, data)] of an SSE body."""
    out = []
    for chunk in text.strip().split("\n\n"):
        lines = dict(ln.split(": ", 1) for ln in chunk.split("\n"))
        out.append((lines.get("id"), json.loads(lines["data"])))
    return out


def _resume_events(base, did, last=None, header=False):
    url = f"{base}/v2/generate/resume/{did}"
    headers = {}
    if last is not None and header:
        headers["Last-Event-ID"] = str(last)
    elif last is not None:
        url += f"?last_event_id={last}"
    with urllib.request.urlopen(urllib.request.Request(url, headers=headers), timeout=60) as r:
        assert r.headers["X-Durable-Id"] == did
        events = _sse(r.read().decode())
    return [(i, {k: v for k, v in e.items() if k != "durable_id"}) for i, e in events]


def test_resume_endpoint_same_events(tmp_path):
    """The streaming response carries monotonic event ids and its
    durable id; the resume endpoint replays the same tokens with the same
    ids, and Last-Event-ID (header or query) skips what the client holds:
    event for event as the JAX server's."""
    servers, models = {}, {}
    for name, srv_cls, model_cls, side in (("jax", JInferenceServer, JGenerationModel, JAX),
                                           ("port", InferenceServer, GenerationModel, PORT)):
        models[name] = model_cls(make_engine(side), name="lm")
        models[name].enable_durability(side_durable(side).DurabilityConfig(
            wal_dir=str(tmp_path / name), fsync=False))
        servers[name] = srv_cls(port=0)
        servers[name].register_generation(models[name])
    try:
        for srv in servers.values():
            srv.start()
        got = {}
        for name, srv in servers.items():
            base = f"http://127.0.0.1:{srv.port}"
            body = {"prompt": [1, 2, 3], "max_new_tokens": 8, "temperature": 0.8, "top_k": 10,
                    "seed": 3, "stream": True}
            req = urllib.request.Request(f"{base}/v2/models/lm/generate",
                                         data=json.dumps(body).encode(),
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as r:
                did = r.headers["X-Durable-Id"]
                events = _sse(r.read().decode())
            done = events[-1][1]
            assert done["durable_id"] == did and done["done"] is True
            tokens = done["tokens"]
            assert [i for i, _ in events[:-1]] == [str(k) for k in range(len(tokens))]
            replay = _resume_events(base, did)
            assert [e["token"] for _, e in replay[:-1]] == tokens
            assert replay[-1][1]["outcome"] == "completed"
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(f"{base}/v2/generate/resume/nope-0", timeout=30)
            got[name] = {
                "stream": [(i, {k: v for k, v in e.items() if k not in ("durable_id",
                                                                         "journey_id")})
                           for i, e in events],
                "replay": replay,
                "query": _resume_events(base, did, last=2),
                "header": _resume_events(base, did, last=4, header=True),
                "missing": ei.value.code,
                "durable": sorted(json.loads(urllib.request.urlopen(
                    f"{base}/v2/durable", timeout=30).read())["models"]["lm"]),
            }
        assert got["port"] == got["jax"]
        assert [e["token"] for _, e in got["port"]["query"][:-1]] == \
            [e["token"] for _, e in got["port"]["replay"][3:-1]]
        assert got["port"]["missing"] == 404
    finally:
        for srv in servers.values():
            srv.stop()


# ---------------------------------------------------------------------------
# rolling restart of a durable virtual-clock fleet
# ---------------------------------------------------------------------------


def _rolling_restart(fside, sess, root):
    from torch_port_fleet import make_fleet

    clock = FakeClock()
    f = make_fleet(fside, sess, n=2, clock=clock, warmup=False,
                   durability_root=root, durability_fsync=False)
    prompts = PROMPTS + [[2, 4, 6, 8]]
    handles = [f.submit(p, fside.SamplingParams(**GREEDY)) for p in prompts]

    def pump():
        f.step()
        clock.advance(0.05)

    try:
        roll = f.rolling_restart(drain_wait_s=30.0, pump=pump)
        for _ in range(500):
            if all(h.done() for h in handles):
                break
            pump()
        rep = f.durable_report()
        out = {
            "roll": roll, "streams": [h.result(0) for h in handles],
            "replicas": sorted(rep["replicas"]) == sorted(r.id for r in f.replicas),
            "counts": [v["counters"]["rolling_restarts"] for v in rep["replicas"].values()],
            "slots": sorted(os.listdir(root)), "stats": f.fleet_stats.snapshot(),
        }
    finally:
        f.stop()
    return out


def test_fleet_rolling_restart_zero_loss(tmp_path):
    """tests/test_durable.py's 2-replica rolling restart through both
    packages' fleets: every in-flight stream finishes byte-exactly (equal
    to the JAX package's), both slots swap with a passed report, and the
    successors' durable stats count the rotation."""
    from torch_port_fleet import JAX as FJAX
    from torch_port_fleet import PORT as FPORT
    from torch_port_fleet import Session

    out = {s.name: _rolling_restart(s, Session(s), str(tmp_path / s.name))
           for s in (FJAX, FPORT)}
    assert out["port"] == out["jax"]
    got = out["port"]
    assert got["roll"]["ok"] and [e["slot"] for e in got["roll"]["replicas"]] == [0, 1]
    assert got["replicas"] and got["counts"] == [1, 1]
    assert got["slots"] == ["slot-0", "slot-1"]
    ref = [make_engine(JAX).generate([list(p)], JAX.SamplingParams(**GREEDY))[0]
           for p in PROMPTS + [[2, 4, 6, 8]]]
    assert got["streams"] == [list(t) for t in ref]
