"""Checkpoints of the port (``runtime/checkpoint.py``) on the CPU: a run
resumed from its ``CheckpointManager`` equals the uninterrupted run bit
for bit, the canonical keys restore into a model with other guids,
bfloat16 state crosses bit for bit, the manager keeps its newest steps,
falls back past a corrupt newest and leaves nothing of a failed save,
and a JAX run saved and restored by the JAX package, then carried into
the port with its optimizer and BatchNorm state, continues with JAX's
losses (rtol 1e-5) and weights (atol 1e-5: float32 in another summation
order).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.config import FFConfig as JFFConfig
from flexflow_tpu.core.types import LossType as JLossType
from flexflow_tpu.core.types import MetricsType as JMetricsType
from flexflow_tpu.model import FFModel as JFFModel
from flexflow_tpu.runtime.checkpoint import CheckpointManager as JCheckpointManager
from flexflow_tpu.runtime.optimizers import AdamOptimizer as JAdamOptimizer
from flexflow_tpu.runtime.optimizers import SGDOptimizer as JSGDOptimizer
from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.core.graph import PCGraph
from flexflow_tpu_torch.core.types import CompMode, DataType, LossType, MetricsType
from flexflow_tpu_torch.generation import prng
from flexflow_tpu_torch.model import FFModel
from flexflow_tpu_torch.models import TransformerConfig, build_transformer
from flexflow_tpu_torch.runtime import AdamOptimizer, CheckpointManager, SGDOptimizer
from flexflow_tpu_torch.runtime.faults import FaultInjected, FaultPlan
from flexflow_tpu_torch.serving.model import InferenceModel
from flexflow_tpu_torch.serving.repository import load_model, save_model

from torch_port_cnn import assert_weights_match, carry, cnn_data, small_cnn

pytestmark = pytest.mark.torch_port

BATCH = 4


def _compile(model, optimizer=None):
    return model.compile(optimizer=optimizer or SGDOptimizer(lr=0.05, momentum=0.9),
                         loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
                         metrics=[MetricsType.ACCURACY])


def _cnn(graph=None):
    """The small CNN with dropout on the CPU: built anew (new guids), or
    over ``graph`` (the same guids)."""
    if graph is not None:
        m = FFModel.from_graph(PCGraph.from_json(graph.to_json()), FFConfig(batch_size=BATCH),
                               device="cpu")
        return _compile(m)
    return _compile(small_cnn(FFModel(FFConfig(batch_size=BATCH), seed=2, device="cpu"),
                              BATCH, dropout=0.2))


def _snapshot(ex) -> list:
    """Every tensor of the executor by topological position."""
    out = []
    for n in ex.graph.topo_order():
        key = f"{n.op_type.value}_{n.guid}"
        for tree in (ex.params, ex.state, ex.opt_state["v"]):
            out.extend(t.detach().clone() for _, t in sorted(tree.get(key, {}).items()))
    return out


def _steps(model, x, y, steps):
    return [float(model.executor.train_batch([x[s * BATCH:(s + 1) * BATCH]],
                                             y[s * BATCH:(s + 1) * BATCH],
                                             rng=prng.key(50 + s))["loss"]) for s in steps]


def test_resumed_run_equals_the_uninterrupted_one_bit_for_bit(tmp_path):
    """Four steps with dropout, BatchNorm and momentum; checkpoints after
    steps 1 and 2 (max_to_keep 2); a model rebuilt over the same graph
    restores the newest and runs steps 3-4."""
    x, y = cnn_data(21, 4 * BATCH)
    ref = _cnn()
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    losses = []
    for s in range(4):
        losses += _steps(ref, x, y, [s])
        if s < 2:
            mgr.save(ref.executor, s + 1)
    assert sorted(os.listdir(mgr.directory)) == ["step_1", "step_2"]
    resumed = _cnn(ref.graph)
    assert mgr.restore_latest(resumed.executor) == 2
    assert resumed.executor.opt_state["step"] == 2
    assert _steps(resumed, x, y, [2, 3]) == losses[2:]
    for a, b in zip(_snapshot(ref.executor), _snapshot(resumed.executor)):
        assert torch.equal(a, b)


def test_canonical_keys_restore_into_other_guids(tmp_path):
    """``save_checkpoint`` / ``load_checkpoint`` through FFModel between
    two builds of the model (other guids): every weight, running
    statistic and momentum buffer comes back, and the step."""
    x, y = cnn_data(22, 2 * BATCH)
    a, b = _cnn(), _cnn()
    assert set(a.executor.params).isdisjoint(b.executor.params)
    _steps(a, x, y, [0, 1])
    a.save_checkpoint(str(tmp_path / "one"), step=7)
    assert b.load_checkpoint(str(tmp_path / "one")) == 7
    for u, v in zip(_snapshot(a.executor), _snapshot(b.executor)):
        assert torch.equal(u, v)


def test_bf16_adam_state_crosses_bit_for_bit(tmp_path):
    cfg = TransformerConfig(num_layers=1, hidden_size=16, num_heads=2, ff_size=32, seq_length=4,
                            dtype=DataType.BFLOAT16)
    m = build_transformer(FFConfig(batch_size=2), cfg, device="cpu")
    m.compile(optimizer=AdamOptimizer(alpha=0.01), loss_type=LossType.MEAN_SQUARED_ERROR)
    rs = np.random.RandomState(0)
    x, y = (torch.from_numpy(rs.randn(2, 4, 16).astype(np.float32)).bfloat16() for _ in range(2))
    m.executor.train_batch([x], y)
    m.save_checkpoint(str(tmp_path / "bf16"), step=1)
    saved = [(t.clone(), t) for tree in (m.executor.params, m.executor.opt_state["m"],
                                         m.executor.opt_state["v"])
             for g in tree.values() for t in g.values()]
    assert all(t.dtype == torch.bfloat16 for t, _ in saved)
    m.executor.train_batch([x], y)  # moves every tensor on
    assert m.load_checkpoint(str(tmp_path / "bf16")) == 1
    assert all(torch.equal(a.view(torch.int16), b.view(torch.int16)) for a, b in saved)
    assert m.executor.opt_state["step"] == 1


def test_manager_keeps_the_newest_and_falls_back_past_a_corrupt_one(tmp_path):
    m = _cnn()
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    assert mgr.latest_step() is None and mgr.restore_latest(m.executor) is None
    for s in (1, 3, 7, 20, 100):
        mgr.save(m.executor, s)
    assert sorted(os.listdir(mgr.directory)) == ["step_100", "step_20"]
    want = _snapshot(m.executor)
    corrupt = tmp_path / "ck" / "step_200"
    corrupt.mkdir()
    (corrupt / "train_state.pt").write_bytes(b"not a checkpoint")
    assert mgr.latest_step() == 200
    x, y = cnn_data(23, BATCH)
    _steps(m, x, y, [0])
    assert mgr.restore_latest(m.executor) == 100
    assert all(torch.equal(a, b) for a, b in zip(want, _snapshot(m.executor)))
    # a partial newest (its file never renamed into place) falls back too
    (tmp_path / "ck" / "step_300").mkdir()
    (tmp_path / "ck" / "step_300" / "train_state.pt.tmp").write_bytes(b"\0" * 16)
    assert mgr.restore_latest(m.executor) == 100
    for s in ("step_20", "step_100"):
        (tmp_path / "ck" / s / "train_state.pt").write_bytes(b"junk")
    with pytest.raises(Exception):
        mgr.restore_latest(m.executor)


def test_failed_save_leaves_no_step_dir(tmp_path):
    """A ``checkpoint.save`` fault fires at the top of the save: no
    directory of that step remains, the previous checkpoint restores."""
    m = _cnn()
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=3)
    mgr.save(m.executor, 1)
    with FaultPlan().on("checkpoint.save", mode="error").active():
        with pytest.raises(FaultInjected):
            mgr.save(m.executor, 2)
    assert sorted(os.listdir(mgr.directory)) == ["step_1"]
    assert mgr.restore_latest(m.executor) == 1


def test_repository_carries_the_running_statistics(tmp_path):
    """A served CNN reads its BatchNorm running statistics back from the
    model repository (``s::`` keys, as the JAX package writes them)."""
    m = _cnn()
    x, y = cnn_data(24, 2 * BATCH)
    _steps(m, x, y, [0, 1])
    save_model(InferenceModel(m, name="cnn"), str(tmp_path))
    served = load_model(str(tmp_path), "cnn", device="cpu")
    assert served.model.comp_mode == CompMode.INFERENCE
    assert torch.equal(served.model.predict(x[:BATCH]), m.predict(x[:BATCH]))


OPTIMIZERS = {
    "sgd_momentum": (lambda: JSGDOptimizer(lr=0.05, momentum=0.9),
                     lambda: SGDOptimizer(lr=0.05, momentum=0.9)),
    "adam": (lambda: JAdamOptimizer(alpha=0.01), lambda: AdamOptimizer(alpha=0.01)),
}


@pytest.mark.parametrize("opt", list(OPTIMIZERS))
def test_jax_checkpoint_carried_into_the_port_continues_with_jax_losses(tmp_path, opt):
    """JAX trains two steps and saves with its CheckpointManager; a fresh
    JAX model restores it; its params, BatchNorm state and optimizer
    state (by layer name, as ``_opt_rekey`` names them) cross into the
    port; both continue two steps on the same keys."""
    jopt, topt = OPTIMIZERS[opt]

    def jmodel(seed):
        jm = small_cnn(JFFModel(JFFConfig(batch_size=BATCH, workers_per_node=1), seed=seed),
                       BATCH, dropout=0.2)
        return jm.compile(optimizer=jopt(), loss_type=JLossType.SPARSE_CATEGORICAL_CROSSENTROPY,
                          metrics=[JMetricsType.ACCURACY])

    x, y = cnn_data(25, 4 * BATCH)

    def jstep(jm, s):
        sl = slice(s * BATCH, (s + 1) * BATCH)
        return float(jm.executor.train_batch([jnp.asarray(x[sl])], jnp.asarray(y[sl]),
                                             jax.random.key(60 + s))["loss"])

    first = jmodel(1)
    for s in range(2):
        jstep(first, s)
    JCheckpointManager(str(tmp_path / "jck"), max_to_keep=2).save(first.executor, 2)
    jm = jmodel(9)  # other initial weights, other guids
    assert JCheckpointManager(str(tmp_path / "jck")).restore_latest(jm.executor) == 2
    tm = FFModel.from_graph(PCGraph.from_json(jm.graph.to_json()), FFConfig(batch_size=BATCH),
                            device="cpu")
    tm.compile(optimizer=topt(), loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
               metrics=[MetricsType.ACCURACY],
               outputs=tm.output_tensors([(t.node.guid, t.idx) for t in jm._outputs]))
    carry(jm, tm, opt_state=True)
    assert tm.executor.opt_state["step"] == int(jm.executor.opt_state["step"]) == 2
    jl = [jstep(jm, s) for s in (2, 3)]
    tl = [float(tm.executor.train_batch([x[s * BATCH:(s + 1) * BATCH]],
                                        y[s * BATCH:(s + 1) * BATCH],
                                        rng=prng.key(60 + s))["loss"]) for s in (2, 3)]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert_weights_match(jm, tm, atol=1e-5)
