"""The port's loadgen (``flexflow_tpu_torch/tools/loadgen.py``) against
the JAX package's ``tools/loadgen.py``.

The seeded Poisson schedule is the JAX tool's, arrival by arrival, for
several seeds and mixes; a schedule file written by either package loads
in the other; and ``drive_virtual`` over one schedule, through the JAX
scheduler and the port's over the same weights (the chaos harness's tiny
engines) on the same virtual clock, gives the same report dict, TTFT
samples and streams. The canned storm the port ships is byte-equal to the
JAX package's test data.
"""
import dataclasses
from pathlib import Path

import pytest

import torch_port_chaos as chaos
from flexflow_tpu.serving.overload import OverloadConfig as JOverload
from flexflow_tpu_torch.serving.overload import OverloadConfig
from flexflow_tpu_torch.tools import _common
from flexflow_tpu_torch.tools import loadgen as tloadgen
from tools import loadgen as jloadgen

pytestmark = pytest.mark.torch_port

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("seed,mix,deadlines", [
    (0, (0.2, 0.3, 0.5), (None, 5.0, 30.0)),
    (7, (0.15, 0.15, 0.7), (None,)),
    (42, (1.0, 0.0, 0.0), (0.5, 2.0)),
])
def test_schedule_equals_jax(seed, mix, deadlines):
    kw = dict(mix=mix, seed=seed, vocab=50, deadlines_s=deadlines, max_new=6,
              prompt_len_lo=2, prompt_len_hi=20)
    ours = tloadgen.build_schedule(60.0, 2.0, **kw)
    theirs = jloadgen.build_schedule(60.0, 2.0, **kw)
    assert len(ours) > 50
    assert [dataclasses.asdict(a) for a in ours] == [dataclasses.asdict(a) for a in theirs]


def test_schedule_files_cross_both_ways(tmp_path):
    sched = tloadgen.build_schedule(30.0, 1.0, seed=5)
    meta = {"rate_rps": 30.0, "duration_s": 1.0, "seed": 5}
    tloadgen.save_schedule(sched, str(tmp_path / "port.json"), meta=meta)
    jloadgen.save_schedule(jloadgen.build_schedule(30.0, 1.0, seed=5), str(tmp_path / "jax.json"),
                           meta=meta)
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    got, got_meta = jloadgen.load_schedule(str(tmp_path / "port.json"), with_meta=True)
    assert [dataclasses.asdict(a) for a in got] == [dataclasses.asdict(a) for a in sched]
    assert got_meta == meta
    back = tloadgen.load_schedule(str(tmp_path / "jax.json"))
    assert [dataclasses.asdict(a) for a in back] == [dataclasses.asdict(a) for a in sched]
    (tmp_path / "bad.json").write_text('{"schema": "other"}')
    with pytest.raises(ValueError, match="not a load schedule"):
        tloadgen.load_schedule(str(tmp_path / "bad.json"))


def test_storm_copy_is_byte_equal():
    ours = Path(_common.STORM_SCHEDULE).read_bytes()
    assert ours == (ROOT / "tests" / "data" / "storm_schedule.json").read_bytes()


def _drive(side, mod, overload_cls, schedule):
    eng, _ = chaos.engine(side, slots=3, num_blocks=40)
    clock = _common.Clock()
    sched = side.Scheduler(eng, clock=clock, max_queue=8, overload=overload_cls(),
                           recovery=side.no_sleep())
    report = mod.drive_virtual(sched, schedule, clock, dt=0.02,
                               sampling_cls=side.SamplingParams)
    sched.stop()
    return report, sched


def test_drive_virtual_equals_jax():
    """One virtual second of mixed-priority load (a queue bound that
    sheds) through both schedulers: the same report, TTFTs and streams."""
    schedule = jloadgen.build_schedule(40.0, 1.0, seed=3, vocab=40, max_new=6,
                                       deadlines_s=(None, 0.3, 30.0))
    port_schedule = [tloadgen.Arrival(**dataclasses.asdict(a)) for a in schedule]
    j_rep, j_sched = _drive(chaos.JAX, jloadgen, JOverload, schedule)
    t_rep, t_sched = _drive(chaos.PORT, tloadgen, OverloadConfig, port_schedule)
    assert t_rep.render(1.0) == j_rep.render(1.0)
    assert t_rep.per == j_rep.per
    assert t_rep.streams() == j_rep.streams() and t_rep.streams()
    assert t_sched.overload.activations() == j_sched.overload.activations()
    per = t_rep.render(1.0)["per_priority"]
    assert sum(p["completed"] for p in per.values()) > 10
    assert sum(p["shed"] + p["expired"] for p in per.values()) > 0


def _default_device_calls():
    from flexflow_tpu_torch.tools import chaoscheck, genbench, obsreport, simfleet

    return {
        "loadgen": lambda: tloadgen.run_inprocess(tloadgen.parse_args([])),
        "genbench": lambda: genbench.main(["--requests", "1", "--bench-out", "",
                                           "--history-out", ""]),
        "simfleet": lambda: simfleet._live_storm(_common.STORM_SCHEDULE),
        "chaoscheck": chaoscheck.run_recovery_sweep,
        "obsreport": obsreport.selfcheck,
    }


@pytest.mark.parametrize("tool", ["loadgen", "genbench", "simfleet", "chaoscheck", "obsreport"])
def test_in_process_engines_default_to_the_card(tool):
    """Without ``--device cpu`` every tool's in-process engine is built on
    the GPU: on a host without one it raises, and nothing falls back to
    the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the tools' engines run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _default_device_calls()[tool]()
