"""The vision path of the port against the JAX package on the CPU: every
new op forward and backward, the four vision builders' graphs, and a
small CNN trained with SGD and momentum with and without remat.

Op gates, each case from one numpy seed. float32: forward and every
gradient within 1e-5 of the largest |JAX value| of that output (another
summation order in fp32 only; the largest difference measured is about
4e-7 of it). bfloat16: the forward within one bf16 unit in the last
place at the JAX value (each package rounds one float32 result once;
average pooling, sigmoid and rsqrt measured one ulp, the rest bit for
bit), every gradient within 2^-6 (four units of bf16 roundoff) of the
largest |JAX value|: JAX rounds a gradient op by op in bf16 (the
broadcast sums, tanh's 1 - y^2) where PyTorch rounds a float32
result once. JAX's own gradient of a bf16 convolution raises a dtype
TypeError (its transpose meets the float32 cotangent of
``preferred_element_type``), so the bf16 convolution holds its forward.
float16: every forward bit for bit with JAX's except ELU, whose
``expm1`` XLA's CPU backend rounds less exactly than PyTorch's
correctly rounded ``elu``; the port keeps the exact ELU (the JAX
package means ``alpha * expm1(x)``), so ELU is held within 2 fp16 ulps
of JAX's value and within half an ulp of the float64 ELU. Every fp16
gradient within 2^-9 (four units of fp16 roundoff, as bf16's four) of
the largest |JAX value| (7.5e-4 of it measured). JAX's fp16 convolution
gradient raises as its bf16 one does: the fp16 convolution holds its
forward.

The CNN (``tests/torch_port_cnn.py``): three SGD steps (lr 0.01,
momentum 0.9) from the JAX model's weights, losses rtol 1e-5, then
every parameter and running statistic atol 1e-5, then the eval-mode
probabilities atol 1e-5; with remat the port's run equals its plain run
bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from flexflow_tpu.config import FFConfig as JFFConfig
from flexflow_tpu.core.types import ActiMode as JActi
from flexflow_tpu.core.types import DataType as JDataType
from flexflow_tpu.core.types import LossType as JLossType
from flexflow_tpu.core.types import MetricsType as JMetricsType
from flexflow_tpu.core.types import OpType as JOpType
from flexflow_tpu.core.types import PoolType as JPoolType
from flexflow_tpu.model import FFModel as JFFModel
from flexflow_tpu.models import vision as jvision
from flexflow_tpu.ops import conv as jconv
from flexflow_tpu.ops import elementwise as jew
from flexflow_tpu.ops import norm as jnorm
from flexflow_tpu.ops.base import LowerCtx as JLowerCtx
from flexflow_tpu.ops.base import get_op_def as jget_op_def
from flexflow_tpu.parallel.propagation import infer_all_specs as jinfer_all_specs
from flexflow_tpu.runtime.optimizers import SGDOptimizer as JSGDOptimizer
from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.core.types import ActiMode, DataType, LossType, MetricsType, OpType, PoolType
from flexflow_tpu_torch.generation import prng
from flexflow_tpu_torch.model import FFModel
from flexflow_tpu_torch.models import vision
from flexflow_tpu_torch.ops import conv, elementwise as ew, norm
from flexflow_tpu_torch.ops.base import LowerCtx, get_op_def
from flexflow_tpu_torch.parallel import infer_all_specs
from flexflow_tpu_torch.runtime import SGDOptimizer
from flexflow_tpu_torch.runtime.convert import to_tensor

from torch_port_cnn import assert_weights_match, cnn_data, port_from_jax, small_cnn

pytestmark = pytest.mark.torch_port

F32_SHARE = 1e-5
BF16_GRAD_SHARE = 2.0 ** -6
F16_GRAD_SHARE = 2.0 ** -9


def _bf16_ulp(a: np.ndarray) -> np.ndarray:
    """One bf16 unit in the last place at |a| (8 significant bits)."""
    mag = np.maximum(np.abs(a), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


def _f16_ulp(a: np.ndarray) -> np.ndarray:
    """One fp16 unit in the last place at |a| (11 significant bits;
    subnormals below 2^-14 have the spacing 2^-24)."""
    mag = np.maximum(np.abs(a), 2.0 ** -14)
    return 2.0 ** (np.floor(np.log2(mag)) - 10)


def _conv(out, k, s, p, groups, bias, acti):
    def make(mod, Acti, D, dt):
        return mod.Conv2DParams(out, (k, k), (s, s), (p, p), groups, bias, getattr(Acti, acti),
                                getattr(D, dt))
    return make


def _pool(k, s, p, kind):
    def make(mod, Acti, D, dt):
        return mod.Pool2DParams((k, k), (s, s), (p, p), getattr(JPoolType if mod is jconv
                                                                  else PoolType, kind))
    return make


def _bn(relu):
    def make(mod, Acti, D, dt):
        return mod.BatchNormParams(relu, 1e-5, 0.9, getattr(D, dt))
    return make


def _binary(op):
    def make(mod, Acti, D, dt):
        return mod.ElementBinaryParams(getattr(JOpType if mod is jew else OpType, op))
    return make


def _unary(op, scalar=0.0):
    def make(mod, Acti, D, dt):
        return mod.ElementUnaryParams(getattr(JOpType if mod is jew else OpType, op), scalar)
    return make


def _inputs(kind, rs):
    """(inputs, weights) of a case, float32 numpy."""
    x = rs.randn(4, 4, 9, 9).astype(np.float32)
    if kind == "conv":
        return [x], {"kernel": 0.3 * rs.randn(6, 2, 3, 3).astype(np.float32),
                     "bias": rs.randn(6).astype(np.float32)}
    if kind == "pool":
        return [np.maximum(x, 0)], {}  # ties at zero, as after a ReLU
    if kind == "bn":
        return [x], {"scale": rs.rand(4).astype(np.float32) + 0.5,
                     "bias": rs.randn(4).astype(np.float32),
                     "running_mean": rs.randn(4).astype(np.float32),
                     "running_var": rs.rand(4).astype(np.float32) + 0.5}
    if kind == "binary":  # broadcasting [4, 1, 5] against [3, 5]
        return [rs.randn(4, 1, 5).astype(np.float32), rs.randn(3, 5).astype(np.float32) + 2], {}
    u = rs.randn(6, 7).astype(np.float32)
    return [np.abs(u) + 0.1 if kind == "positive" else u], {}


# (case, op type name, params maker, input kind, training)
CASES = [
    ("conv_groups_stride_relu", "CONV2D", _conv(6, 3, 2, 1, 2, True, "RELU"), "conv", True),
    ("maxpool_padded", "POOL2D", _pool(3, 2, 1, "MAX"), "pool", True),
    ("avgpool_padded", "POOL2D", _pool(3, 1, 1, "AVG"), "pool", True),
    ("avgpool_global", "POOL2D", _pool(9, 1, 0, "AVG"), "pool", True),
    ("batchnorm_train_relu", "BATCHNORM", _bn(True), "bn", True),
    ("batchnorm_eval", "BATCHNORM", _bn(False), "bn", False),
] + [(op.lower(), op, _binary(op), "binary", True)
     for op in ("EW_ADD", "EW_SUB", "EW_MUL", "EW_DIV", "EW_MAX", "EW_MIN")] + [
    (op.lower(), op, _unary(op, s), "positive" if op in ("RSQRT", "POW") else "any", True)
    for op, s in (("RELU", 0), ("SIGMOID", 0), ("TANH", 0), ("ELU", 0), ("GELU", 0),
                  ("IDENTITY", 0), ("EXP", 0), ("SIN", 0), ("COS", 0), ("RSQRT", 0),
                  ("POW", 1.7), ("SCALAR_ADD", 0.3), ("SCALAR_SUB", 0.7), ("SCALAR_MUL", 1.3),
                  ("SCALAR_TRUE_DIV", 3.0))]


_TYPES = {"float32": ("FLOAT", np.float32), "bfloat16": ("BFLOAT16", ml_dtypes.bfloat16),
          "float16": ("HALF", np.float16)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("case,op,make,kind,training", CASES, ids=[c[0] for c in CASES])
def test_op_forward_and_gradient_match_jax(case, op, make, kind, training, dtype):
    rs = np.random.RandomState(sum(map(ord, case)))
    xs, ws = _inputs(kind, rs)
    jmod = {"conv": jconv, "pool": jconv, "bn": jnorm}.get(kind, jew)
    tmod = {"conv": conv, "pool": conv, "bn": norm}.get(kind, ew)
    dname, jdt = _TYPES[dtype]
    jp = make(jmod, JActi, JDataType, dname)
    tp = make(tmod, ActiMode, DataType, dname)
    jx = tuple(jnp.asarray(x.astype(jdt)) for x in xs)
    jw = {k: jnp.asarray(v.astype(jdt)) for k, v in ws.items()}
    trainable = [k for k in jw if not k.startswith("running")]
    backward = not (op == "CONV2D" and dtype != "float32")

    def jf(xs_, wt):
        return jget_op_def(getattr(JOpType, op)).lower(
            jp, list(xs_), {**jw, **wt}, JLowerCtx(training=training, backend="cpu"))[0]

    jy, vjp = jax.vjp(jf, jx, {k: jw[k] for k in trainable})
    ct = rs.randn(*jy.shape).astype(jdt)
    tx = [to_tensor(np.asarray(a)).requires_grad_(backward) for a in jx]
    tw = {k: to_tensor(np.asarray(v)) for k, v in jw.items()}
    for k in trainable:
        tw[k].requires_grad_(backward)
    tctx = LowerCtx(training=training)
    ty = get_op_def(getattr(OpType, op)).lower(tp, tx, tw, tctx)[0]
    assert ty.dtype == tx[0].dtype and tuple(ty.shape) == tuple(jy.shape)
    pairs = [("y", jy, ty)]
    if backward:
        jgx, jgw = vjp(jnp.asarray(ct))
        tg = torch.autograd.grad(ty, tx + [tw[k] for k in trainable], to_tensor(ct))
        pairs += [(f"d_input{i}", g, tg[i]) for i, g in enumerate(jgx)]
        pairs += [(f"d_{k}", jgw[k], tg[len(tx) + j]) for j, k in enumerate(trainable)]
    if kind == "bn" and training:  # the running statistics' update
        jctx = JLowerCtx(training=True, backend="cpu")
        jget_op_def(JOpType.BATCHNORM).lower(jp, list(jx), jw, jctx)
        assert set(tctx.state_updates) == {(0, "running_mean"), (0, "running_var")}
        pairs += [(f"state_{n}", jctx.state_updates[k], tctx.state_updates[k])
                  for k in jctx.state_updates for n in [k[1]]]
    for name, want, got in pairs:
        want = np.asarray(want, np.float32)
        got = got.detach().float().numpy()
        err = np.abs(got - want)
        if dtype == "float32":
            lim = F32_SHARE * np.abs(want).max()
        elif dtype == "float16" and (name == "y" or name.startswith("state")):
            lim = 2 * _f16_ulp(want) if op == "ELU" else 0.0
            if op == "ELU":  # the exact ELU: half an ulp of float64's
                x64 = np.asarray(jx[0], np.float64)
                exact = np.where(x64 > 0, x64, np.expm1(x64))
                assert (np.abs(got - exact) <= 0.5 * _f16_ulp(exact)).all(), case
        elif name == "y" or name.startswith("state"):
            lim = _bf16_ulp(want)
        elif dtype == "float16":
            lim = F16_GRAD_SHARE * np.abs(want).max()
        else:
            lim = BF16_GRAD_SHARE * np.abs(want).max()
        assert (err <= lim).all(), f"{case} {dtype} {name}: max err {err.max()}"


def _graph_rows(model, infer):
    """Each node in topological order: name, op type, params, output
    shapes and the weight names and shapes (trainable or not)."""
    specs = infer(model.graph)
    rows = []
    for n in model.graph.topo_order():
        params = {k: (v.value if hasattr(v, "value") else v)
                  for k, v in dataclasses.asdict(n.params).items()}
        rows.append((n.name, n.op_type.value, params, [tuple(s.shape) for s in specs[n.guid]]))
    return rows


def _weight_rows(model, infer, get):
    specs = infer(model.graph)
    return [(n.name, w.name, tuple(w.spec.shape), w.trainable, w.initializer)
            for n in model.graph.topo_order()
            for w in get(n.op_type).weight_specs(
                n.params, [specs[e.src][e.src_idx] for e in model.graph.in_edges(n)])]


BUILDERS = {
    "alexnet": ("build_alexnet", dict(num_classes=1000, image_hw=224)),
    "resnet50": ("build_resnet50", dict(num_classes=1000, image_hw=224)),
    "resnext50": ("build_resnext50", dict(num_classes=1000, image_hw=224)),
    "inception_v3": ("build_inception_v3", dict(num_classes=1000, image_hw=299)),
}


@pytest.mark.parametrize("name", list(BUILDERS))
def test_vision_builders_give_jax_graphs(name):
    """The graphs only (no compile): the same layer names, op types and
    params in the same order, the same output shapes and weight specs."""
    fn, kw = BUILDERS[name]
    jm = getattr(jvision, fn)(JFFConfig(batch_size=8, workers_per_node=1), **kw)
    tm = getattr(vision, fn)(FFConfig(batch_size=8), device="cpu", **kw)
    assert _graph_rows(tm, infer_all_specs) == _graph_rows(jm, jinfer_all_specs)
    assert _weight_rows(tm, infer_all_specs, get_op_def) == \
        _weight_rows(jm, jinfer_all_specs, jget_op_def)


def _every_elementwise_builder(model):
    x = model.create_tensor((2, 3, 4, 4), name="x")
    y = model.create_tensor((1, 3, 1, 4), name="y")
    for op in ("subtract", "multiply", "divide", "max", "min", "add"):
        x = getattr(model, op)(x, y, name=op)
    for op in ("relu", "sigmoid", "tanh", "elu", "gelu", "identity", "exp", "sin", "cos",
               "rsqrt"):
        x = getattr(model, op)(x, name=op)
    x = model.pow(x, 1.5, name="pow")
    for op, s in (("scalar_add", 0.5), ("scalar_sub", 0.25), ("scalar_multiply", 2.0),
                  ("scalar_true_divide", 3.0)):
        x = getattr(model, op)(x, s, name=op)
    return model


def test_elementwise_builders_record_jax_nodes():
    """Each elementwise builder with JAX's defaults: the same nodes, params
    and output shapes (broadcast [2, 3, 4, 4] against [1, 3, 1, 4])."""
    jm = _every_elementwise_builder(JFFModel(JFFConfig(batch_size=2, workers_per_node=1)))
    tm = _every_elementwise_builder(FFModel(FFConfig(batch_size=2), device="cpu"))
    assert _graph_rows(tm, infer_all_specs) == _graph_rows(jm, jinfer_all_specs)


CNN_BATCH, CNN_LR, CNN_STEPS = 4, 0.01, 3


@pytest.fixture(scope="module")
def cnn_runs():
    """Three SGD-momentum steps of the small CNN on the same step keys,
    JAX and the port from the JAX model's weights, plain and with remat
    (the JAX package's initial weights depend on the seed and the layer
    order, not on the guids: both JAX models start alike)."""
    x, y = cnn_data(5, CNN_STEPS * CNN_BATCH)
    runs = {}
    for remat in (False, True):
        jm = small_cnn(JFFModel(JFFConfig(batch_size=CNN_BATCH, workers_per_node=1,
                                          remat_blocks=remat), seed=3), CNN_BATCH)
        jm.compile(optimizer=JSGDOptimizer(lr=CNN_LR, momentum=0.9),
                   loss_type=JLossType.SPARSE_CATEGORICAL_CROSSENTROPY,
                   metrics=[JMetricsType.ACCURACY])
        tm = port_from_jax(jm, FFConfig(batch_size=CNN_BATCH, remat_blocks=remat),
                           SGDOptimizer(lr=CNN_LR, momentum=0.9),
                           LossType.SPARSE_CATEGORICAL_CROSSENTROPY, [MetricsType.ACCURACY])
        jl, tl = [], []
        for s in range(CNN_STEPS):
            sl = slice(s * CNN_BATCH, (s + 1) * CNN_BATCH)
            jl.append(float(jm.executor.train_batch([jnp.asarray(x[sl])], jnp.asarray(y[sl]),
                                                    jax.random.key(s))["loss"]))
            tl.append(float(tm.executor.train_batch([x[sl]], y[sl], rng=prng.key(s))["loss"]))
        runs[remat] = (jm, tm, jl, tl)
    return runs, x


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_small_cnn_trains_like_jax(cnn_runs, remat):
    runs, x = cnn_runs
    jm, tm, jl, tl = runs[remat]
    assert (tm.executor._remat_plan is not None) == remat
    assert all(np.isfinite(tl))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert_weights_match(jm, tm, atol=1e-5)
    # eval mode reads the running statistics
    want = np.asarray(jm.predict(jnp.asarray(x[:CNN_BATCH])))
    np.testing.assert_allclose(tm.predict(x[:CNN_BATCH]).numpy(), want, atol=1e-5, rtol=0)


def test_small_cnn_remat_equals_plain_bit_for_bit(cnn_runs):
    runs, _ = cnn_runs
    plain, remat = runs[False][1].executor, runs[True][1].executor
    _, blocks, _ = remat._remat_plan
    assert len(blocks) >= 2 and any(n.op_type == OpType.BATCHNORM for n in blocks[0].nodes)
    assert runs[False][3] == runs[True][3]
    # the two JAX graphs (hence the two port models) have their own guids:
    # compare by topological position
    for tree in ("params", "state"):
        a, b = ([getattr(ex, tree)[f"{n.op_type.value}_{n.guid}"]
                 for n in ex.graph.topo_order()
                 if f"{n.op_type.value}_{n.guid}" in getattr(ex, tree)] for ex in (plain, remat))
        assert len(a) == len(b) > 0
        for ga, gb in zip(a, b):
            assert set(ga) == set(gb) and all(torch.equal(ga[n], gb[n]) for n in ga), tree
