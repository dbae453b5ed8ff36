"""The port's native binding (``flexflow_tpu_torch/_native``) against the
JAX package's, on the CPU.

The port builds its own ``libffcore.so`` from the repo's ``native/src``
(``model_capi.cc`` left out) into ``flexflow_tpu_torch/_native/_build``;
the JAX package loads its own. Both are the same sources under the same
flags, so every entry point gives the same bits on the same inputs:
task-graph replays, machine models and routes, allreduce patterns, the
dataloader's gather and shuffle, the native PCG search and the hybrid
proposer. The port's Python fallback (``FF_NATIVE_DISABLE``) is the JAX
package's contract: the import raises and the search replays in Python.
"""
import os
import random
import subprocess
import sys

import numpy as np
import pytest

from flexflow_tpu import _native as JN
from flexflow_tpu.core.graph import PCGraph as JPCGraph
from flexflow_tpu.models.transformer import TransformerConfig as JTransformerConfig
from flexflow_tpu.models.transformer import build_transformer as jbuild_transformer
from flexflow_tpu.config import FFConfig as JFFConfig
from flexflow_tpu.parallel.machine import MachineSpec as JMachineSpec
from flexflow_tpu.search import machine_model as jmm
from flexflow_tpu.search.simulator import TaskManager as JTaskManager
from flexflow_tpu_torch import _native as N
from flexflow_tpu_torch.core.graph import PCGraph
from flexflow_tpu_torch.parallel.machine import MachineSpec
from flexflow_tpu_torch.search import machine_model as tmm
from flexflow_tpu_torch.search import simulator as tsim

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _random_tasks(tm_cls, n_tasks: int, n_deps: int, n_devices: int, seed: int):
    rng = random.Random(seed)
    tm = tm_cls()
    for _ in range(n_tasks):
        dev = rng.randrange(n_devices) if rng.random() < 0.9 else -1
        tm.new_task(rng.randrange(5), dev, rng.random() * 1e-3)
    for _ in range(n_deps):
        a, b = sorted(rng.sample(range(n_tasks), 2))
        tm.add_dep(a, b)
    return tm


def test_library_is_the_ports_own_build_of_the_shared_sources():
    lib = N._LIB_PATH
    assert lib.exists() and lib.parent == (
        __import__("pathlib").Path(REPO) / "flexflow_tpu_torch" / "_native" / "_build")
    assert [p.name for p in N._SOURCES] == [
        "simulator.cc", "machine_model.cc", "allreduce.cc", "dataloader.cc", "pcg_search.cc"]
    assert all(str(p).startswith(os.path.join(REPO, "native", "src")) for p in N._SOURCES)
    assert N.version() == JN.version()
    # never the JAX package's library
    assert os.path.realpath(N._lib._name) != os.path.realpath(JN._lib._name)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_taskgraph_replay_equals_jax(seed):
    jtm = _random_tasks(JTaskManager, 300, 600, 8, seed)
    ttm = _random_tasks(tsim.TaskManager, 300, 600, 8, seed)
    calls = N.CALLS["simulate_taskgraph"]
    got = N.simulate_taskgraph(ttm.tasks)
    assert got == JN.simulate_taskgraph(jtm.tasks)
    assert N.CALLS["simulate_taskgraph"] == calls + 1
    # the port's search path takes the library, and agrees with its
    # Python replay to the last bit the replay order allows
    before = dict(tsim.REPLAYS)
    assert tsim._simulate(ttm) == got
    assert tsim.REPLAYS["native"] == before["native"] + 1
    assert tsim.REPLAYS["python"] == before["python"]


def test_deadlock_raises_in_both():
    for mod, tm_cls in ((N, tsim.TaskManager), (JN, JTaskManager)):
        tm = tm_cls()
        a, b = tm.new_task(0, 0, 1e-3), tm.new_task(0, 0, 1e-3)
        tm.add_dep(a, b)
        tm.add_dep(b, a)
        with pytest.raises(ValueError):
            mod.simulate_taskgraph(tm.tasks)


TOPOLOGIES = {
    "fat_tree": lambda m: m.NetworkTopology.fat_tree(4, 2, devices_per_node=4),
    "big_switch": lambda m: m.NetworkTopology.big_switch(6, devices_per_node=2, uplinks=2),
    "torus": lambda m: m.NetworkTopology.torus((2, 3), devices_per_node=2),
    "flat_deg": lambda m: m.NetworkTopology.flat_deg_constraint(8, 3, devices_per_node=2, seed=1),
}


@pytest.mark.parametrize("routing", ["shortest", "weighted_shortest", "ecmp"])
@pytest.mark.parametrize("topo", list(TOPOLOGIES))
def test_networked_model_comm_routes_and_allreduce_equal_jax(routing, topo):
    jm = jmm.NetworkedMachineModel(TOPOLOGIES[topo](jmm), routing=routing)
    tm = tmm.NetworkedMachineModel(TOPOLOGIES[topo](tmm), routing=routing)
    jn, tn = JN.NativeMachineModel.from_python(jm), N.NativeMachineModel.from_python(tm)
    nd = tm.num_devices()
    assert tn.num_devices() == jn.num_devices() == nd
    for s in range(0, nd, 3):
        for d in range(0, nd, 5):
            assert tn.comm_time(s, d, 1e6) == jn.comm_time(s, d, 1e6)
    nodes = tm.topo.num_nodes
    for s in range(nodes):
        for d in range(nodes):
            if s != d:
                assert tn.get_routes(s, d) == jn.get_routes(s, d)
    for parts in (list(range(min(nd, 4))), list(range(nd)), [0, 3, 5, 9][: max(2, nd // 4)]):
        for pattern in ("ring", "butterfly", "double_binary_tree"):
            assert tn.allreduce_time(parts, 1e8, pattern) == jn.allreduce_time(parts, 1e8,
                                                                                pattern)
        assert tn.allreduce_optimize(parts, 3e7) == jn.allreduce_optimize(parts, 3e7)


def test_simple_model_equal_jax():
    jn = JN.NativeMachineModel.from_python(jmm.SimpleMachineModel(JMachineSpec(2, 4)))
    tn = N.NativeMachineModel.from_python(tmm.SimpleMachineModel(MachineSpec(2, 4)))
    for s, d, b in [(0, 0, 1e6), (0, 1, 1e6), (0, 3, 1e9), (1, 5, 1e7), (4, 7, 128.0)]:
        assert tn.comm_time(s, d, b) == jn.comm_time(s, d, b)
    assert tn.allreduce_time(list(range(8)), 1e8, "ring") == jn.allreduce_time(
        list(range(8)), 1e8, "ring")


def test_dataloader_gather_and_shuffle_equal_jax():
    rs = np.random.RandomState(3)
    src = rs.randn(1000, 7, 3).astype(np.float32)
    idx = rs.randint(0, 1000, size=257)
    a = np.empty((257, 7, 3), np.float32)
    b = np.empty_like(a)
    N.batch_gather(src, a, idx, num_threads=4)
    JN.batch_gather(src, b, idx, num_threads=4)
    assert np.array_equal(a, src[idx]) and np.array_equal(a, b)
    with pytest.raises(IndexError):
        N.batch_gather(src, a, np.full(257, 1000))
    for n, seed in ((10, 0), (1000, 7)):
        got = N.shuffle_indices(n, seed)
        assert np.array_equal(got, JN.shuffle_indices(n, seed))
        assert sorted(got.tolist()) == list(range(n))


@pytest.fixture(scope="module")
def graphs():
    """A 4-layer transformer graph in both packages (guids kept)."""
    jm = jbuild_transformer(JFFConfig(batch_size=16), JTransformerConfig(
        num_layers=4, hidden_size=64, num_heads=4, ff_size=128, seq_length=32))
    text = jm.graph.to_json()
    return JPCGraph.from_json(text), PCGraph.from_json(text)


@pytest.mark.parametrize("nodes,per_node", [(1, 8), (2, 4)])
def test_native_pcg_search_equals_jax(graphs, nodes, per_node):
    jg, tg = graphs
    jmach, tmach = JMachineSpec(nodes, per_node), MachineSpec(nodes, per_node)
    jp, jidx = JN.pcg_from_graph(jg, jmach, batch=16)
    tp, tidx = N.pcg_from_graph(tg, tmach, batch=16)
    assert tidx == jidx
    jmodel = JN.NativeMachineModel.from_python(jmm.SimpleMachineModel(jmach))
    tmodel = N.NativeMachineModel.from_python(tmm.SimpleMachineModel(tmach))
    assert tp.optimize(tmodel, batch=16) == jp.optimize(jmodel, batch=16)
    assert tp.uniform_best(tmodel, batch=16) == jp.uniform_best(jmodel, batch=16)
    for capacity in (0.0, 1e6):
        assert tp.propose_hybrid(tmodel, 16, seq_len=32, capacity=capacity) == \
            jp.propose_hybrid(jmodel, 16, seq_len=32, capacity=capacity)
    assert N.native_hybrid_search(tg, tmach, 16) == JN.native_hybrid_search(jg, jmach, 16)


def test_disabled_library_means_the_python_path():
    """FF_NATIVE_DISABLE: the import raises ImportError, the simulator
    replays in Python with the same answer (JAX's contract)."""
    code = (
        "import sys, random\n"
        "try:\n"
        "    import flexflow_tpu_torch._native\n"
        "    print('loaded')\n"
        "except ImportError:\n"
        "    print('disabled')\n"
        "from flexflow_tpu_torch.search import simulator as s\n"
        "tm = s.TaskManager()\n"
        "a = tm.new_task(0, 0, 1e-3); b = tm.new_task(0, 1, 2e-3); tm.add_dep(a, b)\n"
        "print(s._simulate(tm), s.REPLAYS['python'], s.REPLAYS['native'])\n"
        "print(any(m == 'jax' or m.startswith(('jax.', 'flexflow_tpu.')) for m in sys.modules))\n"
    )
    env = dict(os.environ, FF_NATIVE_DISABLE="1", PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.split()
    assert lines[0] == "disabled" and float(lines[1]) == 3e-3
    assert lines[2:4] == ["1", "0"] and lines[4] == "False"
