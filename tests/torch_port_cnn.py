"""Shared pieces of the CNN, trainer and checkpoint tests of the port
against the JAX package: a small residual CNN built by either package's
``FFModel`` (their builder APIs match), the carrying of a JAX model's
weights, state and optimizer state into a port model by layer name, and
the comparisons.

The CNN is not degenerate: batch 4 or 8, 8 x 8 maps at every BatchNorm
(at least 2 x 2 at the last one), three repeated residual blocks (so
``detect_repeats`` finds a stack to rematerialize) with a BatchNorm in
each, and an optional dropout before the classifier (so the step keys
matter). Its convolutions feed BatchNorms and carry no bias: such a
bias's gradient is zero up to rounding (the BatchNorm removes the mean),
and Adam would scale that rounding noise to whole steps.
"""
import numpy as np

from flexflow_tpu_torch.core.graph import PCGraph
from flexflow_tpu_torch.model import FFModel
from flexflow_tpu_torch.runtime import opt_state_from_numpy, params_from_numpy

HW, CLASSES = 8, 10


def small_cnn(model, batch: int, dropout: float = 0.0):
    """The CNN on ``model`` (a JAX or a port ``FFModel``)."""
    x = model.create_tensor((batch, 3, HW, HW), name="image")
    t = model.conv2d(x, 8, 3, 3, 1, 1, 1, 1, use_bias=False, name="stem")
    t = model.batch_norm(t, relu=True, name="stem_bn")
    for b in range(3):
        h = model.conv2d(t, 8, 3, 3, 1, 1, 1, 1, use_bias=False, name=f"b{b}_c1")
        h = model.batch_norm(h, relu=True, name=f"b{b}_bn1")
        h = model.conv2d(h, 8, 1, 1, 1, 1, 0, 0, use_bias=False, name=f"b{b}_c2")
        h = model.batch_norm(h, relu=False, name=f"b{b}_bn2")
        t = model.relu(model.add(h, t, name=f"b{b}_add"), name=f"b{b}_relu")
    t = model.pool2d(t, 2, 2, 2, 2, 0, 0, name="pool")
    t = model.flat(t, name="flat")
    if dropout:
        t = model.dropout(t, dropout, name="drop")
    t = model.dense(t, CLASSES, name="fc")
    model.softmax(t, name="softmax")
    return model


def cnn_data(seed: int, n: int, one_hot: bool = False):
    """Images [n, 3, 8, 8] and labels: int32 class ids, or one-hot rows."""
    rs = np.random.RandomState(seed)
    x = rs.randn(n, 3, HW, HW).astype(np.float32)
    y = rs.randint(0, CLASSES, (n,)).astype(np.int32)
    if one_hot:
        return x, np.eye(CLASSES, dtype=np.float32)[y]
    return x, y


def named(model, tree) -> dict:
    """A JAX executor tree keyed by node key as {layer_name: {w: ndarray}}."""
    names = {f"{n.op_type.value}_{n.guid}": n.name for n in model.graph.nodes.values()}
    return {names[k]: {w: np.asarray(a) for w, a in ws.items()} for k, ws in tree.items()}


def port_from_jax(jm, config, optimizer, loss_type, metrics, opt_state: bool = False):
    """The JAX model's graph (from its JSON: the same guids, so dropout
    draws the same masks) in the port on the CPU with the JAX model's
    seed (``fit``'s key chain), its weights and state, and its optimizer
    state when asked."""
    tm = FFModel.from_graph(PCGraph.from_json(jm.graph.to_json()), config, seed=jm._seed,
                            device="cpu")
    tm.compile(optimizer=optimizer, loss_type=loss_type, metrics=metrics,
               outputs=tm.output_tensors([(t.node.guid, t.idx) for t in jm._outputs]))
    carry(jm, tm, opt_state=opt_state)
    return tm


def carry(jm, tm, opt_state: bool = False):
    ex = jm.executor
    opt = None
    if opt_state:
        o = ex.opt_state
        opt = opt_state_from_numpy({
            "step": o["step"], "lr": o["lr"],
            **{f: (None if o.get(f) is None else named(jm, o[f])) for f in ("v", "m") if f in o},
        })
    tm.set_weights(params_from_numpy(named(jm, ex.params)),
                   state=params_from_numpy(named(jm, ex.state)), opt_state=opt)


def assert_weights_match(jm, tm, atol: float, state_atol: float = None):
    """Every parameter and every state entry of the port model against
    the JAX model's, by layer name."""
    for tree, tol in ((jm.executor.params, atol), (jm.executor.state, state_atol or atol)):
        for layer, ws in named(jm, tree).items():
            for name, arr in ws.items():
                np.testing.assert_allclose(tm.get_weight(layer, name), np.asarray(arr, np.float32),
                                           atol=tol, rtol=0, err_msg=f"{layer}.{name}")
