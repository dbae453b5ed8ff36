"""The port's disaggregated serving (``DisaggregatedFleet``,
``HandoffManager``, the engine's ``pack_kv_blocks`` / ``import_kv_blocks``,
the scheduler's hand-off at the first token and ``adopt(imported=...)``)
against the JAX package's, on the CPU at ``tests/test_disagg.py``'s
geometry (1 layer, hidden 16, vocab 40, one prefill bucket) on virtual
clocks with synchronous ``dfleet.step()``.

Six of ``tests/test_disagg.py``'s cases run once through a JAX fleet and
once through a port fleet (``torch_port_fleet.both``): the streams
(greedy, seeded temperature, speculative), the handoff's transfer
outcomes, retries and replays, and the decode pool's ``kv_imports`` /
``kv_imports_rejected`` must be equal. The wire round trip runs in both
packages over the same cache contents (the packed CRCs equal, float32
and a bfloat16 cache), and the wire crosses the packages both ways: a
payload the JAX engine packed imports into the port's decode scheduler
and the reverse, with the decode streams equal to the reference and a
corrupted block rejected (and the stream recomputed) in each package.
The per-pool layout chooser (``choose_pool_strategies``) is not ported.
"""
import time

import ml_dtypes
import numpy as np
import pytest
import torch

from conftest import FakeClock
from torch_port_fleet import (
    BLOCK,
    JAX,
    PORT,
    PROMPTS,
    Session,
    both,
    drive,
    make_disagg,
    outcome,
)

pytestmark = [pytest.mark.torch_port, pytest.mark.disagg]

BUCKETS = (8,)  # tests/test_disagg.py's: every prompt here is <= 5 tokens
EK = dict(prompt_buckets=BUCKETS)


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    yield
    for side in (JAX, PORT):
        assert side.faults.active_plan() is None, "a test leaked an installed FaultPlan"


def kv_imports(pool):
    return [(r.scheduler.recovery_stats.kv_imports,
             r.scheduler.recovery_stats.kv_imports_rejected)
            for r in pool._replicas_snapshot()]


def snap(d):
    return {
        "transfers": dict(d.handoff.transfers),
        "retries": d.handoff.retries_total,
        "replays": d.handoff.replay_fallbacks,
        "bytes": d.handoff.bytes_total,
        "in_flight": d.handoff.in_flight,
        "decode_imports": kv_imports(d.decode),
        "prefill_imports": kv_imports(d.prefill),
        "free": [r.engine.allocator.num_free == r.engine.allocator.num_total
                 for pool in (d.prefill, d.decode) for r in pool._replicas_snapshot()],
    }


def reference(side, sess, prompts, samplings, specs=None):
    eng = sess.engine(**EK)
    specs = specs or [None] * len(prompts)
    return [eng.generate([list(p)], s, speculation=sp)[0]
            for p, s, sp in zip(prompts, samplings, specs)]


# ---------------------------------------------------------------------------
# wire format
# ---------------------------------------------------------------------------


def _fill(side, eng, seed=0):
    """Deterministic nonzero cache contents, the same in both packages."""
    rng = np.random.default_rng(seed)
    if side is JAX:
        import jax.numpy as jnp

        shape = eng.cache.k.shape
        k = jnp.asarray(rng.standard_normal(shape), dtype=eng.cache.k.dtype)
        v = jnp.asarray(rng.standard_normal(shape), dtype=eng.cache.v.dtype)
        eng.cache.update(k, v)
        return
    shape = tuple(eng.cache.k.shape)
    for t in (eng.cache.k, eng.cache.v):
        t.copy_(torch.from_numpy(rng.standard_normal(shape)).to(t.dtype))


def _roundtrip(side, sess, kv_dtype):
    from_pkg = side.fleet
    a = sess.engine(**EK, kv_dtype=kv_dtype)
    b = sess.engine(**EK, kv_dtype=kv_dtype)
    _fill(side, a)
    n_pos = 2 * BLOCK - 3  # the trailing partial block packs too
    payload = a.pack_kv_blocks([0, 1], n_pos)
    b.import_kv_blocks([2, 4], payload.blocks)
    echo = b.pack_kv_blocks([2, 4], n_pos)
    same = all(np.array_equal(s.host_k, g.host_k) and np.array_equal(s.host_v, g.host_v)
               for s, g in zip(payload.blocks, echo.blocks))
    bad_k = payload.blocks[0].host_k.copy()
    bad_k.view(np.uint8).flat[0] ^= 1
    tampered = from_pkg.PackedBlock(bad_k, payload.blocks[0].host_v, crc=payload.blocks[0].crc)
    return {
        "n_blocks": len(payload.blocks), "verify": payload.verify(), "echo": echo.verify(),
        "same": same, "nbytes": payload.nbytes, "geometry": payload.geometry,
        "crcs": [blk.crc for blk in payload.blocks],
        "tampered": (tampered.verify(), from_pkg.KVHandoffPayload(
            n_pos, BLOCK, [tampered] + list(payload.blocks[1:])).verify()),
    }


@pytest.mark.parametrize("kv_dtype", ["FLOAT", "BFLOAT16"])
def test_wire_pack_import_roundtrip(kv_dtype):
    """pack -> wire -> import -> repack is byte-identical, CRCs verify on
    arrival, a flipped bit fails verification, and the same cache
    contents pack to the same CRCs in both packages."""
    out = both(_roundtrip, kv_dtype)
    assert out["n_blocks"] == 2 and out["verify"] and out["echo"] and out["same"]
    assert out["tampered"] == (False, False)
    itemsize = 4 if kv_dtype == "FLOAT" else 2
    assert out["nbytes"] == 2 * 2 * BLOCK * 2 * 8 * itemsize  # blocks x K/V x bs x H x D


def _prefilled(side, sess, kv_dtype, prompt, sampling):
    """(request, payload) from a prefill-pool scheduler of ``side``."""
    from flexflow_tpu.generation import ContinuousBatchingScheduler as JScheduler
    from flexflow_tpu_torch.generation import ContinuousBatchingScheduler

    cls = JScheduler if side is JAX else ContinuousBatchingScheduler
    sched = cls(sess.engine(**EK, kv_dtype=kv_dtype), recovery=side.policy(),
                clock=FakeClock())
    got = []
    sched.handoff_sink = lambda req, payload: got.append((req, payload))
    sched.submit(prompt, sampling)
    while not got:
        sched.step()
    return got[0]


def _to_other(payload, pkg, dst_is_jax):
    """A payload's blocks re-wrapped in the other package's classes, with
    the CRC stamped at packing (a 2-byte cache crosses as its bytes: the
    port packs bfloat16 as uint16 bits, the JAX engine as ml_dtypes'
    bfloat16)."""
    def conv(a):
        if dst_is_jax and a.dtype == np.uint16:
            return a.view(ml_dtypes.bfloat16)
        return a
    return pkg.KVHandoffPayload(payload.n_positions, payload.block_size, [
        pkg.PackedBlock(conv(b.host_k), conv(b.host_v), crc=b.crc) for b in payload.blocks])


def _corrupt(payload, pkg):
    blocks = list(payload.blocks)
    k = blocks[0].host_k.copy()
    k.view(np.uint8).flat[3] ^= 0x40
    blocks[0] = pkg.PackedBlock(k, blocks[0].host_v, crc=blocks[0].crc)
    return pkg.KVHandoffPayload(payload.n_positions, payload.block_size, blocks)


@pytest.mark.parametrize("kv_dtype", ["FLOAT", "BFLOAT16"])
def test_wire_crosses_packages_both_ways(kv_dtype):
    """A payload packed by the JAX engine imports into the port's decode
    scheduler, and one packed by the port into the JAX scheduler; each
    decode stream equals the single-engine reference of its package (and
    the two are equal), the CRC stamped by one package verifies in the
    other, and a corrupted block is caught in each package: the import is
    rejected and the stream recomputed, byte-exact."""
    from flexflow_tpu.generation import ContinuousBatchingScheduler as JScheduler
    from flexflow_tpu_torch.generation import ContinuousBatchingScheduler

    prompt = PROMPTS[2]
    js, ps = Session(JAX), Session(PORT)
    ref = {side.name: reference(side, sess, [prompt], [side.greedy()])[0]
           for side, sess in ((JAX, js), (PORT, ps))}
    assert ref["jax"] == ref["port"]
    results = {}
    for src, dst, cls in ((JAX, PORT, ContinuousBatchingScheduler),
                          (PORT, JAX, JScheduler)):
        for corrupt in (False, True):
            s_sess, d_sess = (js, ps) if src is JAX else (ps, js)
            _, payload = _prefilled(src, s_sess, kv_dtype, prompt, src.greedy())
            dst_req, _ = _prefilled(dst, d_sess, kv_dtype, prompt, dst.greedy())
            wire = _to_other(payload, dst.fleet, dst is JAX)
            assert wire.verify() and [b.crc for b in wire.blocks] == \
                [b.crc for b in payload.blocks]
            if corrupt:
                wire = _corrupt(wire, dst.fleet)
                assert not wire.verify()
            sched = cls(d_sess.engine(**EK, kv_dtype=kv_dtype), recovery=dst.policy(),
                        clock=FakeClock())
            sched.adopt(dst_req, front=True, imported=wire)
            drive(sched.step, [dst_req.handle])
            rs = sched.recovery_stats
            results[(src.name, corrupt)] = (outcome(dst_req.handle), rs.kv_imports,
                                            rs.kv_imports_rejected, dst_req.replays)
    for (src, corrupt), (stream, imports, rejected, replays) in results.items():
        assert stream == ref["jax"], (src, corrupt)
        assert (imports, rejected, replays) == ((0, 1, 1) if corrupt else (1, 0, 0))


# ---------------------------------------------------------------------------
# byte-exact handoff, pool-aware routing
# ---------------------------------------------------------------------------


def _streams_mixed(side, sess):
    S = side.SamplingParams
    spec = side.SpeculationConfig(k=3, method="ngram")
    samp = [S(max_new_tokens=12),
            S(max_new_tokens=10, temperature=0.8, top_k=10, seed=42),
            S(max_new_tokens=10, temperature=0.7, top_k=8, seed=7),
            S(max_new_tokens=10)]
    specs = [None, None, None, spec]
    ref = reference(side, sess, PROMPTS, samp, specs)
    d = make_disagg(side, sess, engine_kw=EK, handoff_timeout_s=5.0)
    before = snap(d)
    handles = [d.submit(p, s, speculation=sp) for p, s, sp in zip(PROMPTS, samp, specs)]
    drive(d.step, handles)
    return ref, [outcome(h) for h in handles], before, snap(d)


def test_disagg_streams_byte_exact_mixed():
    ref, streams, before, after = both(_streams_mixed)
    assert streams == ref
    assert after["transfers"]["ok"] - before["transfers"]["ok"] == len(PROMPTS)
    assert after["replays"] == before["replays"] and after["in_flight"] == 0
    assert after["decode_imports"][0][0] - before["decode_imports"][0][0] == len(PROMPTS)
    assert after["prefill_imports"] == [(0, 0)] and all(after["free"])


# ---------------------------------------------------------------------------
# failure classes: every one terminates in a byte-exact stream
# ---------------------------------------------------------------------------


def _faulted(side, sess, rule, prompts):
    ref = reference(side, sess, prompts, [side.greedy()] * len(prompts))
    d = make_disagg(side, sess, engine_kw=EK, handoff_timeout_s=5.0)
    before = snap(d)
    plan = side.faults.FaultPlan(seed=0)
    rule(side, plan)
    with plan.active():
        handles = [d.submit(p, side.greedy()) for p in prompts]
        drive(d.step, handles)
    return ref, [outcome(h) for h in handles], before, snap(d), plan.site_counters()


def test_transfer_error_bounded_retry_exact():
    def rule(side, plan):
        plan.on(side.faults.FLEET_KV_HANDOFF, mode="error",
                error=RuntimeError("injected transfer failure"), nth=(0,))
    ref, streams, before, after, _ = both(_faulted, rule, PROMPTS[:2])
    assert streams == ref
    assert after["retries"] - before["retries"] >= 1
    assert after["transfers"]["ok"] - before["transfers"]["ok"] == 2
    assert after["replays"] == before["replays"]


def test_corruption_crc_caught_replays_exact():
    def rule(side, plan):
        plan.on(side.faults.FLEET_KV_HANDOFF, mode="nan", nth=(0,))
    ref, streams, before, after, _ = both(_faulted, rule, PROMPTS[:2])
    assert streams == ref
    assert after["transfers"]["corrupt"] - before["transfers"]["corrupt"] == 1
    assert after["transfers"]["ok"] - before["transfers"]["ok"] == 1
    assert after["replays"] - before["replays"] == 1


def test_retry_exhaustion_replays_on_decode_pool():
    def rule(side, plan):
        plan.on(side.faults.FLEET_KV_HANDOFF, mode="error",
                error=RuntimeError("injected transfer failure"), every=1)
    ref, streams, before, after, _ = both(_faulted, rule, PROMPTS[:1])
    assert streams == ref
    assert after["transfers"]["error"] - before["transfers"]["error"] == 1
    assert after["replays"] - before["replays"] == 1
    assert after["decode_imports"] == before["decode_imports"]


def test_import_fault_rejects_into_recompute():
    """The decode side's ``generation.kv_import`` site: an error there
    rejects the import (``kv_imports_rejected``) and the decode replica
    recomputes the stream, byte-exact."""
    def rule(side, plan):
        plan.on(side.faults.GENERATION_KV_IMPORT, mode="error",
                error=RuntimeError("injected import failure"), nth=(0,))
    ref, streams, before, after, sites = both(_faulted, rule, PROMPTS[:2])
    assert streams == ref
    assert after["decode_imports"][0][1] - before["decode_imports"][0][1] == 1
    assert sites["generation.kv_import"]["fires"] == 1


def _stalled(side, sess, monkeypatch):
    clock = FakeClock()
    ref = reference(side, sess, PROMPTS[:1], [side.greedy()])
    d = make_disagg(side, sess, engine_kw=EK, clock=clock, handoff_timeout_s=5.0)
    before = snap(d)
    monkeypatch.setattr(d.decode.router, "place_failover", lambda reps: None)
    h = d.submit(PROMPTS[0], side.greedy())
    for _ in range(50):
        d.step()
        if d.handoff.in_flight:
            break
    pending = d.handoff.in_flight
    clock.advance(6.0)
    d.handoff.check()
    expired = snap(d)
    monkeypatch.undo()
    drive(d.step, [h])
    return ref, outcome(h), pending, before, expired


def test_stalled_deadline_expires_into_replay(monkeypatch):
    ref, stream, pending, before, expired = both(_stalled, monkeypatch)
    assert stream == ref[0] and pending == 1
    assert expired["transfers"]["stalled"] - before["transfers"]["stalled"] == 1
    assert expired["replays"] - before["replays"] == 1 and expired["in_flight"] == 0


# ---------------------------------------------------------------------------
# live mode: the dedicated handoff worker thread
# ---------------------------------------------------------------------------


def _live(side, sess):
    ref = reference(side, sess, PROMPTS[:1], [side.greedy()])
    d = make_disagg(side, sess, engine_kw=EK, clock=time.monotonic, poll_s=0.01)
    d.start()
    try:
        worker = d.handoff._worker
        alive = worker is not None and worker.is_alive()
        got = d.generate(PROMPTS[0], side.greedy(), timeout=30)
    finally:
        d.stop()
    return ref[0], got, alive, worker.is_alive(), d.handoff.replay_fallbacks


def test_live_worker_thread_delivers_exact():
    ref, got, alive, alive_after, replays = both(_live)
    assert got == ref and alive and not alive_after and replays == 0
