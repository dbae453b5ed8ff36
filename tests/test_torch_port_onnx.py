"""The port's ONNX importer (``frontends/onnx``) and
``InferenceModel.from_onnx`` against the JAX package's on the CPU.

Every graph of ``tests/test_onnx_frontend.py``, from the same mock protos
(where that file's initializers are zeros, here they are drawn from a
seed, so that the outputs say something), goes through both importers:
the same op sequence and node names, the same count of nodes
``load_weights`` updates, outputs within atol 1e-5 (float32 in another
summation order), and the same refusals with the same messages. Then the
fused BERT graph of ``flexflow_tpu_torch/tools/frontend_probe.py`` (2
layers x 32, 2 heads) through both packages' ``from_onnx`` and ``infer``:
logits and probabilities within atol 1e-5.
"""
import numpy as np
import pytest

from flexflow_tpu import CompMode as JCompMode
from flexflow_tpu import DataType as JDataType
from flexflow_tpu import FFConfig as JFFConfig
from flexflow_tpu import FFModel as JFFModel
from flexflow_tpu.frontends.onnx import ONNXModel as JONNXModel
from flexflow_tpu.frontends.onnx.model import _to_numpy as j_to_numpy
from flexflow_tpu.serving import InferenceModel as JInferenceModel
from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.core.types import CompMode, DataType
from flexflow_tpu_torch.frontends.onnx import ONNXModel, onnx_to_flexflow
from flexflow_tpu_torch.frontends.onnx.model import _to_numpy
from flexflow_tpu_torch.model import FFModel
from flexflow_tpu_torch.serving import InferenceModel
from flexflow_tpu_torch.tools.frontend_probe import bert_onnx_graph
from test_onnx_frontend import Attr, GraphProto, Init, ModelProto, NodeProto, ValueInfo, ints

pytestmark = pytest.mark.torch_port

ATOL = 1e-5  # float32 outputs of one graph in another summation order


class _Side:
    def __init__(self, name, ffmodel, config, onnx_cls, comp_mode, dtypes):
        self.name, self.FFModel, self.Config, self.ONNXModel = name, ffmodel, config, onnx_cls
        self.INFERENCE, self.DataType = comp_mode, dtypes

    def model(self, batch):
        if self.name == "jax":
            return self.FFModel(self.Config(batch_size=batch, workers_per_node=1))
        return self.FFModel(self.Config(batch_size=batch), device="cpu")


JAX = _Side("jax", JFFModel, JFFConfig, JONNXModel, JCompMode.INFERENCE, JDataType)
PORT = _Side("port", FFModel, FFConfig, ONNXModel, CompMode.INFERENCE, DataType)


def _host(x):
    return x.detach().numpy() if hasattr(x, "detach") else np.asarray(x)


def _run(side, proto, feeds, batch):
    """(op sequence with names, load count, outputs) of ``proto`` imported
    into a fresh model of ``side``; ``feeds``: {name: (array, dtype name)}."""
    ff = side.model(batch)
    tensors = {n: ff.create_tensor(a.shape, getattr(side.DataType, dt), name=n)
               for n, (a, dt) in feeds.items()}
    om = side.ONNXModel(proto)
    outs = om.apply(ff, tensors)
    ff.compile(comp_mode=side.INFERENCE, outputs=outs)
    loaded = om.load_weights(ff)
    got = ff.executor.predict([a for a, _ in feeds.values()])
    ops = [(n.op_type.name, n.name) for n in sorted(ff.graph.nodes.values(), key=lambda n: n.guid)]
    return ops, loaded, [_host(g) for g in got]


def _both(proto, feeds, batch):
    (jops, jn, jout), (pops, pn, pout) = (_run(s, proto, feeds, batch) for s in (JAX, PORT))
    assert pops == jops and pn == jn
    assert len(pout) == len(jout)
    for p, j in zip(pout, jout):
        assert p.shape == j.shape
        np.testing.assert_allclose(p, j, atol=ATOL, rtol=0)
    return pout, pn


def _rand(rs, *shape, scale=0.3):
    return (rs.randn(*shape) * scale).astype(np.float32)


def g_mlp(rs):
    g = GraphProto(
        node=[
            NodeProto("Gemm", ["x", "w1", "b1"], ["h"], "gemm1", [Attr("transB", 2, i=1)]),
            NodeProto("Relu", ["h"], ["hr"], "relu1"),
            NodeProto("Gemm", ["hr", "w2", "b2"], ["logits"], "gemm2", [Attr("transB", 2, i=1)]),
            NodeProto("Softmax", ["logits"], ["probs"], "sm", [Attr("axis", 2, i=-1)]),
        ],
        input=[ValueInfo("x")], output=[ValueInfo("probs")],
        initializer=[Init("w1", _rand(rs, 32, 16)), Init("b1", _rand(rs, 32)),
                     Init("w2", _rand(rs, 10, 32)), Init("b2", _rand(rs, 10))])
    return g, {"x": (rs.randn(8, 16).astype(np.float32), "FLOAT")}, 8


def g_cnn(rs):
    g = GraphProto(
        node=[
            NodeProto("Conv", ["x", "cw", "cb"], ["c"], "conv",
                      [ints("strides", (1, 1)), ints("pads", (1, 1, 1, 1))]),
            NodeProto("Relu", ["c"], ["cr"], "relu"),
            NodeProto("MaxPool", ["cr"], ["p"], "pool", [ints("kernel_shape", (2, 2)),
                                                         ints("strides", (2, 2))]),
            NodeProto("GlobalAveragePool", ["p"], ["gap"], "gap"),
            NodeProto("Flatten", ["gap"], ["f"], "flat"),
            NodeProto("Gemm", ["f", "fw", "fb"], ["y"], "fc", [Attr("transB", 2, i=1)]),
        ],
        input=[ValueInfo("x")], output=[ValueInfo("y")],
        initializer=[Init("cw", _rand(rs, 8, 3, 3, 3)), Init("cb", _rand(rs, 8)),
                     Init("fw", _rand(rs, 10, 8)), Init("fb", _rand(rs, 10))])
    return g, {"x": (rs.randn(4, 3, 16, 16).astype(np.float32), "FLOAT")}, 4


def g_elementwise_and_shape(rs):
    g = GraphProto(
        node=[
            NodeProto("Add", ["a", "b"], ["s"], "add"),
            NodeProto("Mul", ["s", "b"], ["m"], "mul"),
            NodeProto("Transpose", ["m"], ["t"], "tr", [ints("perm", (0, 2, 1))]),
            NodeProto("Reshape", ["t", "shape"], ["r"], "rs"),
            NodeProto("Concat", ["r", "r"], ["cat"], "cat", [Attr("axis", 2, i=1)]),
        ],
        input=[ValueInfo("a"), ValueInfo("b")], output=[ValueInfo("cat")],
        initializer=[Init("shape", np.array([4, -1], np.int64))])
    return g, {"a": (rs.randn(4, 6, 5).astype(np.float32), "FLOAT"),
               "b": (rs.randn(4, 6, 5).astype(np.float32), "FLOAT")}, 4


def g_scalar_binary(rs):
    g = GraphProto(
        node=[
            NodeProto("Mul", ["x", "scale"], ["xs"], "mul1"),
            NodeProto("Sub", ["one", "xs"], ["inv"], "sub1"),
            NodeProto("Add", ["inv", "three"], ["shifted"], "add1"),
            NodeProto("Div", ["two", "shifted"], ["out"], "div1"),
        ],
        input=[ValueInfo("x")], output=[ValueInfo("out")],
        initializer=[Init(n, np.array([v], np.float32))
                     for n, v in (("scale", 2.0), ("one", 1.0), ("two", 2.0), ("three", 3.0))])
    return g, {"x": (rs.randn(4, 8).astype(np.float32), "FLOAT")}, 4


def g_unnamed_matmuls(rs):
    g = GraphProto(
        node=[NodeProto("MatMul", ["x", "w1"], ["h"]), NodeProto("Relu", ["h"], ["hr"]),
              NodeProto("MatMul", ["hr", "w2"], ["y"])],
        input=[ValueInfo("x")], output=[ValueInfo("y")],
        initializer=[Init("w1", rs.randn(8, 8).astype(np.float32)),
                     Init("w2", rs.randn(8, 2).astype(np.float32))])
    return g, {"x": (rs.randn(4, 8).astype(np.float32), "FLOAT")}, 4


def g_scalar_fold(rs):
    g = GraphProto(
        node=[NodeProto("Div", ["one", "two"], ["half"], "d"), NodeProto("Mul", ["x", "half"], ["y"], "m")],
        input=[ValueInfo("x")], output=[ValueInfo("y")],
        initializer=[Init("one", np.array([1.0], np.float32)), Init("two", np.array([2.0], np.float32))])
    return g, {"x": (rs.randn(4, 8).astype(np.float32), "FLOAT")}, 4


def g_add_zero_scalar(rs):
    g = GraphProto(
        node=[NodeProto("Add", ["one", "zero"], ["c"], "a"), NodeProto("Mul", ["x", "c"], ["y"], "m")],
        input=[ValueInfo("x")], output=[ValueInfo("y")],
        initializer=[Init("one", np.array([1.0], np.float32)), Init("zero", np.array([0.0], np.float32))])
    return g, {"x": (rs.randn(2, 4).astype(np.float32), "FLOAT")}, 2


def g_batchnorm(rs):
    g = GraphProto(
        node=[NodeProto("BatchNormalization", ["x", "s", "b", "m", "v"], ["y"], "bn",
                        [Attr("epsilon", 1, f=1e-5)])],
        input=[ValueInfo("x")], output=[ValueInfo("y")],
        initializer=[Init("s", rs.rand(3).astype(np.float32) + 0.5), Init("b", _rand(rs, 3)),
                     Init("m", _rand(rs, 3)), Init("v", rs.rand(3).astype(np.float32) + 0.5)])
    return g, {"x": (rs.randn(2, 3, 4, 4).astype(np.float32), "FLOAT")}, 2


def g_gather_embedding(rs):
    g = GraphProto(
        node=[NodeProto("Gather", ["table", "ids"], ["y"], "gat", [Attr("axis", 2, i=0)])],
        input=[ValueInfo("ids")], output=[ValueInfo("y")],
        initializer=[Init("table", rs.randn(6, 4).astype(np.float32))])
    return g, {"ids": (rs.randint(0, 6, (3, 5)).astype(np.int32), "INT32")}, 3


def g_gather_scalar_index(rs):
    g = GraphProto(
        node=[NodeProto("Gather", ["x", "idx"], ["y"], "cls", [Attr("axis", 2, i=1)])],
        input=[ValueInfo("x")], output=[ValueInfo("y")],
        initializer=[Init("idx", np.array(2, np.int64))])
    return g, {"x": (rs.randn(2, 5, 3).astype(np.float32), "FLOAT")}, 2


def g_layernorm(rs):
    g = GraphProto(
        node=[NodeProto("LayerNormalization", ["x", "s", "b"], ["y"], "ln",
                        [Attr("axis", 2, i=-1), Attr("epsilon", 1, f=1e-5)])],
        input=[ValueInfo("x")], output=[ValueInfo("y")],
        initializer=[Init("s", rs.rand(6).astype(np.float32) + 0.5), Init("b", _rand(rs, 6))])
    return g, {"x": (rs.randn(2, 4, 6).astype(np.float32), "FLOAT")}, 2


def g_attention(rs):
    g = GraphProto(
        node=[NodeProto("Attention", ["x", "w"], ["y"], "attn", [Attr("num_heads", 2, i=2)])],
        input=[ValueInfo("x")], output=[ValueInfo("y")],
        initializer=[Init("w", _rand(rs, 8, 24))])
    return g, {"x": (rs.randn(2, 5, 8).astype(np.float32), "FLOAT")}, 2


def g_attention_with_bias(rs):
    g = GraphProto(
        node=[NodeProto("Attention", ["x", "w", "b"], ["y"], "attn", [Attr("num_heads", 2, i=2)])],
        input=[ValueInfo("x")], output=[ValueInfo("y")],
        initializer=[Init("w", _rand(rs, 8, 24)), Init("b", _rand(rs, 24))])
    return g, {"x": (rs.randn(2, 5, 8).astype(np.float32), "FLOAT")}, 2


def g_anonymous_relu(rs):
    g = GraphProto(node=[NodeProto("Relu", ["x"], ["y"])], input=[ValueInfo("x")],
                   output=[ValueInfo("y")], initializer=[])
    return g, {"x": (rs.randn(2, 4).astype(np.float32), "FLOAT")}, 2


GRAPHS = {f.__name__[2:]: f for f in (
    g_mlp, g_cnn, g_elementwise_and_shape, g_scalar_binary, g_unnamed_matmuls, g_scalar_fold,
    g_add_zero_scalar, g_batchnorm, g_gather_embedding, g_gather_scalar_index, g_layernorm,
    g_attention, g_attention_with_bias, g_anonymous_relu)}
LOADED = {"mlp": 2, "cnn": 2, "unnamed_matmuls": 2, "batchnorm": 1, "gather_embedding": 1,
          "layernorm": 1, "attention": 1, "attention_with_bias": 1}


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_graph_imports_and_runs_as_jax(name):
    g, feeds, batch = GRAPHS[name](np.random.RandomState(sorted(GRAPHS).index(name)))
    names = [n.name for n in g.node]
    outs, loaded = _both(ModelProto(g), feeds, batch)
    assert loaded == LOADED.get(name, 0)
    assert [n.name for n in g.node] == names  # the caller's proto is never changed
    assert all(np.isfinite(o).all() for o in outs)


def test_numeric_anchors():
    """Two of the JAX file's closed forms, on the port's outputs."""
    g, feeds, batch = g_scalar_binary(np.random.RandomState(1))
    x = feeds["x"][0]
    (out,), _ = _both(ModelProto(g), feeds, batch)
    np.testing.assert_allclose(out, 2.0 / ((1.0 - x * 2.0) + 3.0), rtol=1e-5)
    g, feeds, batch = g_unnamed_matmuls(np.random.RandomState(9))
    w1, w2 = (i.numpy for i in g.initializer)
    (out,), _ = _both(ModelProto(g), feeds, batch)
    np.testing.assert_allclose(out, np.maximum(feeds["x"][0] @ w1, 0) @ w2, rtol=1e-5, atol=1e-6)


def _refusal(side, proto, feeds, batch, corrupt=None):
    ff = side.model(batch)
    tensors = {n: ff.create_tensor(shape, getattr(side.DataType, dt), name=n)
               for n, (shape, dt) in feeds.items()}
    om = side.ONNXModel(proto)
    try:
        outs = om.apply(ff, tensors)
        ff.compile(comp_mode=side.INFERENCE, outputs=outs)
        if corrupt:
            corrupt(om)
        om.load_weights(ff)
    except Exception as e:  # the refusal under comparison
        return type(e).__name__, str(e)
    return None


def _corrupt_kernel(om):
    om.weight_map["g"]["kernel"] = np.zeros((7, 7), np.float32)


REFUSALS = {
    "nonscalar_initializer_binary": (
        [NodeProto("Add", ["x", "bias"], ["y"], "add1")], [Init("bias", np.zeros(8, np.float32))],
        {"x": ((4, 8), "FLOAT")}, 4, None, "NotImplementedError"),
    "dilated_conv": (
        [NodeProto("Conv", ["x", "w"], ["y"], "conv1", [ints("strides", [1, 1]),
                                                        ints("pads", [1, 1, 1, 1]),
                                                        ints("dilations", [2, 2])])],
        [Init("w", np.zeros((8, 3, 3, 3), np.float32))], {"x": ((2, 3, 16, 16), "FLOAT")}, 2,
        None, "AssertionError"),
    "gemm_nondefault_attrs": (
        [NodeProto("Gemm", ["x", "w", "b"], ["y"], "g", [Attr("alpha", 1, f=0.5)])],
        [Init("w", np.zeros((4, 8), np.float32)), Init("b", np.zeros(4, np.float32))],
        {"x": ((2, 8), "FLOAT")}, 2, None, "NotImplementedError"),
    "load_weights_shape_mismatch": (
        [NodeProto("Gemm", ["x", "w", "b"], ["y"], "g", [Attr("transB", 2, i=1)])],
        [Init("w", np.zeros((4, 8), np.float32)), Init("b", np.zeros(4, np.float32))],
        {"x": ((2, 8), "FLOAT")}, 2, _corrupt_kernel, "ValueError"),
    "unsupported_op": (
        [NodeProto("LSTM", ["x"], ["y"], "lstm")], [], {"x": ((2, 8), "FLOAT")}, 2, None,
        "NotImplementedError"),
    "gather_of_a_tensor_by_a_tensor": (
        [NodeProto("Gather", ["x", "ids"], ["y"], "gat", [Attr("axis", 2, i=0)])], [],
        {"x": ((2, 8), "FLOAT"), "ids": ((2, 3), "INT32")}, 2, None, "NotImplementedError"),
    "auto_pad": (
        [NodeProto("MaxPool", ["x"], ["y"], "pool", [ints("kernel_shape", (2, 2)),
                                                      Attr("auto_pad", 3, s=b"SAME_UPPER")])],
        [], {"x": ((2, 3, 8, 8), "FLOAT")}, 2, None, "AssertionError"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_equal_jaxs(case):
    nodes, inits, feeds, batch, corrupt, kind = REFUSALS[case]
    proto = ModelProto(GraphProto(node=nodes, input=[ValueInfo(n) for n in feeds],
                                  output=[ValueInfo("y")], initializer=inits))
    j, p = (_refusal(s, proto, feeds, batch, corrupt) for s in (JAX, PORT))
    assert p == j and p is not None and p[0] == kind


def test_initializer_conversion_and_the_onnx_guard_equal_jaxs():
    class Raw:  # a TensorProto-shaped mock without ``numpy``
        def __init__(self, name, dims, float_data=(), int64_data=()):
            self.name, self.dims = name, dims
            self.float_data, self.int64_data = list(float_data), list(int64_data)

    for init in (Raw("f", [2, 2], float_data=[1.0, 2.0, 3.0, 4.0]), Raw("i", [3], int64_data=[4, 5, 6])):
        got, want = _to_numpy(init), j_to_numpy(init)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    msgs = []
    for fn in (_to_numpy, j_to_numpy):
        with pytest.raises(ValueError) as e:
            fn(Raw("empty", [0]))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    from flexflow_tpu_torch.frontends.onnx import model as tmod

    if not tmod.HAS_ONNX:  # a path needs the onnx package, in both
        for cls in (ONNXModel, JONNXModel):
            with pytest.raises(AssertionError, match="onnx package"):
                cls("model.onnx")


def test_onnx_to_flexflow_is_apply():
    g, feeds, batch = g_mlp(np.random.RandomState(0))
    ff = PORT.model(batch)
    outs = onnx_to_flexflow(ModelProto(g), ff, {"x": ff.create_tensor((8, 16))})
    assert outs[0].shape == (8, 10)


BERT = dict(vocab=50, layers=2, hidden=32, heads=2, ff=64, classes=2)
SEQ = 8


def test_bert_graph_from_onnx_and_infer_equal_jaxs():
    proto = bert_onnx_graph(3, **BERT)
    kw = dict(input_shapes={"ids": (SEQ,)}, name="bert", max_batch=4)
    jim = JInferenceModel.from_onnx(proto, input_dtypes={"ids": JDataType.INT32},
                                    config=JFFConfig(batch_size=4, workers_per_node=1), **kw)
    tim = InferenceModel.from_onnx(proto, input_dtypes={"ids": DataType.INT32}, device="cpu", **kw)
    assert tim.model.executor is not None and tim.model.device.type == "cpu"
    jmd, tmd = jim.metadata(), tim.metadata()
    assert {**tmd, "platform": 0} == {**jmd, "platform": 0}
    assert [o["name"] for o in tmd["outputs"]] == ["output_0", "output_1"]
    rows = np.random.RandomState(4).randint(0, BERT["vocab"], (3, SEQ)).astype(np.int32)
    got, want = tim.infer([rows]), jim.infer([rows])
    assert [g.shape for g in got] == [(3, 2), (3, 2)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got[1].sum(-1), 1.0, atol=1e-6)
    # the nodes that carry weights: the word table, 1 + 2 x 2 LayerNorms,
    # 2 Attentions, 3 MatMuls a layer and the classifier
    om = ONNXModel(proto)
    ff = FFModel(FFConfig(batch_size=4), device="cpu")
    om.apply(ff, {"ids": ff.create_tensor((4, SEQ), DataType.INT32)})
    assert len(om.weight_map) == 1 + 5 + 2 + 6 + 1


def test_from_onnx_refuses_a_strategy_file(tmp_path):
    """The JAX package's served BERT on its 8 CPU devices writes a
    data-parallel strategy over 8; the port reads that file, remaps it
    by layer name and refuses it with the JAX package's device-count
    error (it runs on one device). A one-device strategy file compiles
    (tests/test_torch_port_strategy.py)."""
    proto = bert_onnx_graph(0, **BERT)
    jim = JInferenceModel.from_onnx(proto, {"ids": (SEQ,)}, max_batch=8,
                                    input_dtypes={"ids": JDataType.INT32})
    assert jim.model.strategy.axis_sizes == {"data": 8}
    path = tmp_path / "strategy.json"
    path.write_text(jim.model.strategy.to_json())
    with pytest.raises(ValueError, match="^mesh needs 8 devices, have 1$"):
        InferenceModel.from_onnx(proto, {"ids": (SEQ,)}, max_batch=8, strategy_file=str(path),
                                 input_dtypes={"ids": DataType.INT32}, device="cpu")


def test_new_modules_import_with_jax_grpc_and_protobuf_blocked():
    """The frontends, the gRPC module, the twin, and the search with the
    strategy layer and the native binding import in a fresh interpreter
    where jax, the JAX package, grpc and protobuf cannot be imported;
    there ``GrpcInferenceServer(...)`` alone raises."""
    import subprocess
    import sys
    from pathlib import Path

    code = (
        "import importlib.abc, sys\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'flexflow_tpu', 'grpc') or "
        "name.startswith('google.protobuf'):\n"
        "            raise ImportError('blocked ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import flexflow_tpu_torch.frontends.onnx, flexflow_tpu_torch.frontends.torch\n"
        "import flexflow_tpu_torch.serving.grpc_server, flexflow_tpu_torch.sim\n"
        "import flexflow_tpu_torch.search, flexflow_tpu_torch.parallel.strategy\n"
        "import flexflow_tpu_torch.core.parallel_tensor, flexflow_tpu_torch._native\n"
        "from flexflow_tpu_torch.serving import GrpcInferenceServer\n"
        "try:\n"
        "    GrpcInferenceServer()\n"
        "except RuntimeError as e:\n"
        "    assert 'protobuf' in str(e), e\n"
        "else:\n"
        "    raise AssertionError('GrpcInferenceServer started without protobuf')\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=Path(__file__).resolve().parent.parent,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr
