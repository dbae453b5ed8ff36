"""The port's torch.fx importer (``frontends/torch``) against the JAX
package's on the CPU.

Each module of ``tests/test_torch_frontend.py`` (the MLP, the CNN, the
residual block with scalar ops, the embedding and mean, the scalar-first
sub/div, the chunked split, the module applied twice, the HF-style BERT
encoder) is traced by both importers: the same op sequence and node
names, then ``copy_weights`` from the same module into each, and outputs
within that file's tolerances of each other and of the module's own
forward. The ``.ff`` file: the two packages write the same file, and a
file written by either replays in the other with the same predictions
(rtol 1e-5, atol 1e-6, the JAX test's). Three SGD steps of the imported
BERT in both packages: losses within rtol 1e-5 (float32 in another
summation order), weights after within atol 1e-5. ``nn.MultiheadAttention``
used as torch code uses it (``attn(x, x, x)[0]``) fails to import in
both with the same ``TypeError``, and ``copy_weights`` skips its
weights in both: a discrepancy inside the reference, kept.
"""
import json

import numpy as np
import pytest
import torch
import torch.nn as nn

from flexflow_tpu import DataType as JDataType
from flexflow_tpu import FFConfig as JFFConfig
from flexflow_tpu import FFModel as JFFModel
from flexflow_tpu import LossType as JLossType
from flexflow_tpu import SGDOptimizer as JSGD
from flexflow_tpu.frontends.torch import PyTorchModel as JPyTorchModel
from flexflow_tpu.frontends.torch import copy_weights as jcopy_weights
from flexflow_tpu.frontends.torch import replay_ff as jreplay_ff
from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.core.types import DataType, LossType
from flexflow_tpu_torch.frontends.torch import PyTorchModel, copy_weights, replay_ff
from flexflow_tpu_torch.frontends.torch import torch_to_flexflow
from flexflow_tpu_torch.model import FFModel
from flexflow_tpu_torch.runtime.optimizers import SGDOptimizer
from test_torch_frontend import _BertEncoder

pytestmark = pytest.mark.torch_port


class _Side:
    def __init__(self, name, ffmodel, config, pt_cls, copy, replay, loss, sgd, dtypes):
        self.name, self.FFModel, self.Config, self.PyTorchModel = name, ffmodel, config, pt_cls
        self.copy_weights, self.replay_ff, self.Loss, self.SGD = copy, replay, loss, sgd
        self.DataType = dtypes

    def model(self, batch):
        if self.name == "jax":
            return self.FFModel(self.Config(batch_size=batch, workers_per_node=1))
        return self.FFModel(self.Config(batch_size=batch), device="cpu")

    def compile(self, ff, outs, lr=0.0):
        ff.compile(optimizer=self.SGD(lr=lr), loss_type=self.Loss.MEAN_SQUARED_ERROR,
                   outputs=outs)

    def predict(self, ff, xs):
        got = ff.predict(list(xs))
        return got.detach().numpy() if hasattr(got, "detach") else np.asarray(got)


JAX = _Side("jax", JFFModel, JFFConfig, JPyTorchModel, jcopy_weights, jreplay_ff, JLossType,
            JSGD, JDataType)
PORT = _Side("port", FFModel, FFConfig, PyTorchModel, copy_weights, replay_ff, LossType,
             SGDOptimizer, DataType)
SIDES = (JAX, PORT)


def _ops(ff):
    return [(n.op_type.name, n.name) for n in sorted(ff.graph.nodes.values(), key=lambda n: n.guid)]


def _import(side, module, xs, dtypes, lr=0.0):
    ff = side.model(xs[0].shape[0])
    pt = side.PyTorchModel(module)
    outs = pt.torch_to_ff(ff, [ff.create_tensor(x.shape, dtype=getattr(side.DataType, dt))
                               for x, dt in zip(xs, dtypes)])
    side.compile(ff, outs, lr)
    side.copy_weights(module, ff, pt.name_map)
    return ff, pt


class _CNN(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 8, 3, padding=1)
        self.pool = nn.MaxPool2d(2)
        self.conv2 = nn.Conv2d(8, 8, 3, padding=1)
        self.fc = nn.Linear(8 * 8 * 8, 10)

    def forward(self, x):
        x = self.pool(torch.relu(self.conv1(x)))
        x = self.pool(torch.relu(self.conv2(x)))
        return self.fc(torch.flatten(x, 1))


class _Block(nn.Module):
    def __init__(self):
        super().__init__()
        self.fc1, self.fc2, self.ln = nn.Linear(16, 16), nn.Linear(16, 16), nn.LayerNorm(16)

    def forward(self, x):
        h = self.fc2(torch.relu(self.fc1(x))) + x
        return self.ln(h) * 2.0 - 1.0


class _Emb(nn.Module):
    def __init__(self):
        super().__init__()
        self.emb, self.fc = nn.Embedding(50, 8), nn.Linear(8, 4)

    def forward(self, ids):
        return self.fc(torch.mean(self.emb(ids), 1))


class _ScalarFirst(nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = nn.Linear(8, 8)

    def forward(self, x):
        y = self.fc(x)
        return 1.0 - torch.sigmoid(y) + 2.0 / (torch.exp(y) + 3.0)


class _Split(nn.Module):
    def forward(self, x):
        a, b, c = torch.split(x, 2, dim=1)
        return a + b + c


class _Twice(nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = nn.Linear(8, 8)

    def forward(self, x):
        return self.fc(torch.relu(self.fc(x)))


def _x(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# name: (module factory, torch seed, inputs, input dtypes, atol of test_torch_frontend.py)
MODULES = {
    "mlp": (lambda: nn.Sequential(nn.Linear(16, 32), nn.ReLU(), nn.Linear(32, 8), nn.Tanh()), 0,
            lambda: [_x(0, 8, 16)], ["FLOAT"], 2e-5),
    "cnn": (_CNN, 1, lambda: [_x(1, 4, 3, 32, 32)], ["FLOAT"], 1e-4),
    "residual_block": (_Block, 2, lambda: [_x(2, 4, 16)], ["FLOAT"], 2e-5),
    "embedding_and_mean": (_Emb, 3, lambda: [np.random.RandomState(3).randint(0, 50, (4, 12))
                                             .astype(np.int32)], ["INT32"], 2e-5),
    "scalar_first_sub_div": (_ScalarFirst, 2, lambda: [_x(3, 4, 8)], ["FLOAT"], 2e-5),
    "split_int_is_chunk_size": (_Split, 0, lambda: [_x(4, 4, 6)], ["FLOAT"], 2e-5),
    "module_called_twice": (_Twice, 5, lambda: [_x(6, 4, 8)], ["FLOAT"], 2e-5),
    "hf_style_bert": (_BertEncoder, 3, lambda: [_x(5, 4, 6, 16)], ["FLOAT"], 5e-5),
}


@pytest.mark.parametrize("name", sorted(MODULES))
def test_module_imports_and_aligns_as_jax(name):
    make, seed, inputs, dtypes, atol = MODULES[name]
    torch.manual_seed(seed)
    module = make().eval()
    xs = inputs()
    (jff, jpt), (tff, tpt) = (_import(s, module, xs, dtypes) for s in SIDES)
    assert _ops(tff) == _ops(jff)
    assert tpt.name_map == jpt.name_map and tpt.to_records() == jpt.to_records()
    jgot, tgot = JAX.predict(jff, xs), PORT.predict(tff, xs)
    with torch.no_grad():
        want = module(*[torch.from_numpy(x) for x in xs]).numpy()
    np.testing.assert_allclose(tgot, want, atol=atol, rtol=1e-4)
    np.testing.assert_allclose(tgot, jgot, atol=atol, rtol=1e-4)


def test_torch_to_flexflow_returns_the_importer():
    torch.manual_seed(0)
    module = nn.Sequential(nn.Linear(4, 3), nn.ReLU())
    ff = PORT.model(2)
    outs, pt = torch_to_flexflow(module, ff, [ff.create_tensor((2, 4))])
    assert outs[0].shape == (2, 3) and pt.name_map == {"0": ["_0"], "1": ["_1"]}


def test_flatten_with_nonunit_start_dim_rejected_as_jax():
    class M(nn.Module):
        def forward(self, x):
            return torch.flatten(x)

    for side in SIDES:
        ff = side.model(4)
        with pytest.raises(AssertionError, match="flatten"):
            side.PyTorchModel(M()).torch_to_ff(ff, [ff.create_tensor([4, 2, 3])])


def _export(side, module, path):
    side.PyTorchModel(module).export_ff(str(path), lambda: side.model(4), [(4, 6, 16)])
    return json.loads(path.read_text())


@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)], ids=["jax->port", "port->jax"])
def test_ff_file_replays_across_packages(tmp_path, writer, reader):
    torch.manual_seed(7)
    module = _BertEncoder(layers=1)
    path = tmp_path / f"{writer.name}.ff"
    payload = _export(writer, module, path)
    other = _export(reader, module, tmp_path / "other.ff")
    assert payload == other and payload["format"] == "flexflow_tpu.ff.v1"
    x = _x(8, 4, 6, 16)
    direct, pt = _import(reader, module, [x], ["FLOAT"])
    replayed = reader.model(4)
    outs = reader.replay_ff(str(path), replayed, [replayed.create_tensor((4, 6, 16))])
    reader.compile(replayed, outs)
    reader.copy_weights(module, replayed, pt.name_map)
    assert [op for op, _ in _ops(replayed)] == [op for op, _ in _ops(direct)]
    np.testing.assert_allclose(reader.predict(replayed, [x]), reader.predict(direct, [x]),
                               rtol=1e-5, atol=1e-6)


def test_bert_sgd_steps_equal_jaxs():
    import jax

    torch.manual_seed(4)
    module = _BertEncoder()
    x, y = _x(6, 4, 6, 16), _x(7, 4, 6, 16)
    (jff, _), (tff, _) = (_import(s, module, [x], ["FLOAT"], lr=0.05) for s in SIDES)
    jl = [float(jff.executor.train_batch([x], y, jax.random.key(0))["loss"]) for _ in range(3)]
    tl = [float(tff.executor.train_batch([x], y)["loss"]) for _ in range(3)]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0]
    for key, ws in jff.executor.params.items():
        name = jff.graph.nodes[int(key.rsplit("_", 1)[1])].name
        tws = tff.executor.params[tff.executor.node_key(name)]
        for w, a in ws.items():
            np.testing.assert_allclose(tws[w].detach().numpy(), np.asarray(a), atol=1e-5, rtol=0,
                                       err_msg=f"{name}.{w}")


class _MHAIndexed(nn.Module):
    def __init__(self):
        super().__init__()
        self.attn = nn.MultiheadAttention(8, 2, batch_first=True)

    def forward(self, x):
        return self.attn(x, x, x, need_weights=False)[0]


class _MHAWhole(nn.Module):
    def __init__(self):
        super().__init__()
        self.attn = nn.MultiheadAttention(8, 2, batch_first=True)

    def forward(self, x):
        return self.attn(x, x, x, need_weights=False)


def test_multihead_attention_gap_is_kept_as_jax():
    """The reference's gap, pinned: indexing the module's output raises
    the same TypeError in both importers, and copy_weights leaves the
    attention's weights at their initial values in both."""
    msgs = []
    for side in SIDES:
        ff = side.model(2)
        with pytest.raises(TypeError) as e:
            side.PyTorchModel(_MHAIndexed()).torch_to_ff(ff, [ff.create_tensor((2, 5, 8))])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] == "'Tensor' object is not subscriptable"
    torch.manual_seed(0)
    module = _MHAWhole()
    for side in SIDES:
        ff = side.model(2)
        pt = side.PyTorchModel(module)
        side.compile(ff, pt.torch_to_ff(ff, [ff.create_tensor((2, 5, 8))]))
        (key,) = ff.executor.params
        before = {w: np.array(_host(v)) for w, v in ff.executor.params[key].items()}
        side.copy_weights(module, ff, pt.name_map)
        after = {w: _host(v) for w, v in ff.executor.params[key].items()}
        assert pt.name_map == {"attn": ["attn"]} and set(before) == {"wq", "wk", "wv", "wo", "bq",
                                                                    "bk", "bv", "bo"}
        for w in before:
            np.testing.assert_array_equal(after[w], before[w])


def _host(v):
    return v.detach().numpy() if hasattr(v, "detach") else np.asarray(v)
