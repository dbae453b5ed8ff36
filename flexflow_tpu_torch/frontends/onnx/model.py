"""ONNX graph -> FFModel importer (port of
``flexflow_tpu/frontends/onnx/model.py``).

Reference: python/flexflow/onnx/model.py: per-op ``handleX`` dispatch
over a ModelProto's graph (handleConv :149, handleDense/Gemm :194,
handleMaxPool :202, Add/Sub/Mul/Concat/Split/Softmax/Reshape/... ).

The ``onnx`` package is optional: the importer takes any object with the
ModelProto structure (graph.node / graph.input / graph.initializer,
nodes with op_type/input/output/attribute). A path to a .onnx file needs
``onnx`` installed. The com.microsoft ``Attention`` node (onnxruntime's
fused BERT) lowers to ``multihead_attention``, whose core is the flash
forward kernel on a GPU. ``load_weights`` copies each initializer into
the compiled model's parameters and state on the model's device.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ...core.types import DataType, PoolType
from ...runtime.convert import to_tensor
from ...runtime.executor import node_key

try:
    import onnx

    HAS_ONNX = True
except Exception:
    onnx = None
    HAS_ONNX = False

# ONNX TensorProto elem_type codes (onnx.TensorProto enum values)
_ELEM_TYPE = {1: DataType.FLOAT, 6: DataType.INT32, 7: DataType.INT64, 10: DataType.HALF, 11: DataType.DOUBLE, 16: DataType.BFLOAT16}


def _attrs(node) -> Dict[str, object]:
    out = {}
    for a in node.attribute:
        # AttributeProto: type 1=FLOAT 2=INT 3=STRING 6=FLOATS 7=INTS
        if a.type == 2:
            out[a.name] = int(a.i)
        elif a.type == 1:
            out[a.name] = float(a.f)
        elif a.type == 7:
            out[a.name] = [int(v) for v in a.ints]
        elif a.type == 6:
            out[a.name] = [float(v) for v in a.floats]
        elif a.type == 3:
            out[a.name] = a.s.decode() if isinstance(a.s, bytes) else str(a.s)
    return out


class _NamedNode:
    """Read-only view of a NodeProto with a generated name — keeps the
    user-owned ModelProto unmutated (an importer assigning node.name was
    an unexpected side effect on caller input)."""

    __slots__ = ("_node", "name")

    def __init__(self, node, name: str):
        self._node = node
        self.name = name

    def __getattr__(self, attr):
        return getattr(self._node, attr)


class ONNXModel:
    """Reference: ONNXModel (onnx/model.py:56)."""

    def __init__(self, model):
        """model: a loaded ModelProto, a mock with the same structure, or
        a path to a .onnx file (requires the onnx package)."""
        if isinstance(model, str):
            assert HAS_ONNX, "onnx package not available to parse files"
            model = onnx.load(model)
        self.model = model
        self.inputs: Dict[str, object] = {}
        self.initializers: Dict[str, np.ndarray] = {}
        # ff node name -> {weight name: value} for load_weights (the
        # serving path needs the graph's trained weights, not random
        # init; reference: triton/src/onnx_parser.cc parses weights too)
        self.weight_map: Dict[str, Dict[str, np.ndarray]] = {}

    def apply(self, ffmodel, input_tensors: Dict[str, object]) -> List:
        """Replay the graph; input_tensors maps graph input name -> ff
        Tensor. Returns the graph outputs (reference: ONNXModel.apply).

        The caller's ModelProto is never mutated: ONNX node names are
        optional, so anonymous nodes get generated names held in a local
        wrapper, uniquified against user-supplied ones."""
        graph = self.model.graph
        env: Dict[str, object] = dict(input_tensors)
        for init in graph.initializer:
            self.initializers[init.name] = _to_numpy(init)
        taken = {n.name for n in graph.node if n.name}
        named_nodes = []
        for i, node in enumerate(graph.node):
            if node.name:
                named_nodes.append(node)
                continue
            name = f"{node.op_type.lower()}_{i}"
            while name in taken:
                name += "_"
            taken.add(name)
            named_nodes.append(_NamedNode(node, name))
        for node in named_nodes:
            handler = getattr(self, f"handle{node.op_type}", None)
            if handler is None:
                raise NotImplementedError(f"unsupported ONNX op {node.op_type}")
            outs = handler(ffmodel, node, env)
            if outs is None:
                continue
            if not isinstance(outs, (list, tuple)):
                outs = [outs]
            for name, t in zip(node.output, outs):
                env[name] = t
        return [env[o.name] for o in graph.output]

    # -- elementwise --------------------------------------------------
    def _binary(self, ff, node, env, kind):
        """Binary op where either side may be a graph initializer: scalar
        constants lower to the scalar op family; non-scalar constants are
        not importable (no constant-tensor op yet) and fail loudly."""
        def resolve(name):
            if name in env:
                return env[name]
            if name in self.initializers:
                c = self.initializers[name]
                if c.size == 1:
                    return float(c.reshape(-1)[0])
                raise NotImplementedError(
                    f"{node.op_type} with non-scalar initializer {name!r} "
                    f"(shape {tuple(c.shape)}) is not supported"
                )
            raise KeyError(f"{node.op_type} input {name!r} is neither a produced tensor nor an initializer")

        a, b = resolve(node.input[0]), resolve(node.input[1])
        if isinstance(a, float) and isinstance(b, float):  # constant fold
            import operator as _op

            return {"add": _op.add, "sub": _op.sub, "mul": _op.mul, "div": _op.truediv}[kind](a, b)
        bin_fn = {"add": ff.add, "sub": ff.subtract, "mul": ff.multiply, "div": ff.divide}[kind]
        scalar_fn = {"add": ff.scalar_add, "sub": ff.scalar_sub, "mul": ff.scalar_multiply, "div": ff.scalar_true_divide}[kind]
        if isinstance(b, float):
            return scalar_fn(a, b, name=node.name)
        if isinstance(a, float):
            if kind in ("add", "mul"):
                return scalar_fn(b, a, name=node.name)
            if kind == "sub":  # c - x = -x + c
                neg = ff.scalar_multiply(b, -1.0, inplace=False, name=f"{node.name}_neg")
                return ff.scalar_add(neg, a, name=node.name)
            inv = ff.pow(b, -1.0, name=f"{node.name}_inv")  # c / x = c * x^-1
            return ff.scalar_multiply(inv, a, inplace=False, name=node.name)
        return bin_fn(a, b, name=node.name)

    def handleAdd(self, ff, node, env):
        return self._binary(ff, node, env, "add")

    def handleSub(self, ff, node, env):
        return self._binary(ff, node, env, "sub")

    def handleMul(self, ff, node, env):
        return self._binary(ff, node, env, "mul")

    def handleDiv(self, ff, node, env):
        return self._binary(ff, node, env, "div")

    def handleRelu(self, ff, node, env):
        return ff.relu(env[node.input[0]], name=node.name)

    def handleSigmoid(self, ff, node, env):
        return ff.sigmoid(env[node.input[0]], name=node.name)

    def handleTanh(self, ff, node, env):
        return ff.tanh(env[node.input[0]], name=node.name)

    def handleElu(self, ff, node, env):
        return ff.elu(env[node.input[0]], name=node.name)

    def handleExp(self, ff, node, env):
        return ff.exp(env[node.input[0]], name=node.name)

    def handleSoftmax(self, ff, node, env):
        axis = _attrs(node).get("axis", -1)
        return ff.softmax(env[node.input[0]], axis=axis, name=node.name)

    # -- shape ops ----------------------------------------------------
    def handleConcat(self, ff, node, env):
        axis = _attrs(node).get("axis", 0)
        return ff.concat([env[i] for i in node.input], axis, name=node.name)

    def handleSplit(self, ff, node, env):
        at = _attrs(node)
        axis = at.get("axis", 0)
        sizes = at.get("split")
        if sizes is None and len(node.input) > 1 and node.input[1] in self.initializers:
            sizes = [int(v) for v in self.initializers[node.input[1]]]
        assert sizes is not None, "Split without sizes unsupported"
        return ff.split(env[node.input[0]], sizes, axis, name=node.name)

    def handleFlatten(self, ff, node, env):
        return ff.flat(env[node.input[0]], name=node.name)

    def handleReshape(self, ff, node, env):
        shape = self.initializers.get(node.input[1])
        assert shape is not None, "Reshape shape must be a constant initializer"
        shape = [int(s) for s in shape]
        x = env[node.input[0]]
        if -1 in shape or 0 in shape:
            total = int(np.prod(x.shape))
            shape = [x.shape[i] if s == 0 else s for i, s in enumerate(shape)]
            known = int(np.prod([s for s in shape if s != -1]))
            shape = [total // known if s == -1 else s for s in shape]
        return ff.reshape(x, tuple(shape), name=node.name)

    def handleTranspose(self, ff, node, env):
        perm = _attrs(node)["perm"]
        return ff.transpose(env[node.input[0]], tuple(perm), name=node.name)

    def handleCast(self, ff, node, env):
        to = _ELEM_TYPE[_attrs(node)["to"]]
        return ff.cast(env[node.input[0]], to, name=node.name)

    def handleDropout(self, ff, node, env):
        rate = _attrs(node).get("ratio", 0.5)
        return ff.dropout(env[node.input[0]], rate, name=node.name)

    def handleIdentity(self, ff, node, env):
        return ff.identity(env[node.input[0]], name=node.name)

    # -- conv/pool/norm ----------------------------------------------
    def handleConv(self, ff, node, env):
        at = _attrs(node)
        w = self.initializers.get(node.input[1])
        assert w is not None, "Conv weight must be an initializer"
        dil = at.get("dilations", [1, 1])
        assert all(d == 1 for d in dil), f"dilated Conv (dilations={dil}) is not supported"
        assert at.get("auto_pad", "NOTSET") in ("", "NOTSET"), (
            f"auto_pad={at['auto_pad']} is not supported; export with explicit pads"
        )
        out_c, _, kh, kw = w.shape
        strides = at.get("strides", [1, 1])
        pads = at.get("pads", [0, 0, 0, 0])  # [top, left, bottom, right]
        ph = (pads[0], pads[2]) if pads[0] != pads[2] else pads[0]
        pw = (pads[1], pads[3]) if pads[1] != pads[3] else pads[1]
        groups = at.get("group", 1)
        use_bias = len(node.input) > 2
        ws = {"kernel": w}
        if use_bias:
            b = self.initializers.get(node.input[2])
            if b is not None:
                ws["bias"] = b
        self.weight_map[node.name] = ws
        return ff.conv2d(
            env[node.input[0]], out_c, kh, kw, strides[0], strides[1], ph, pw,
            groups=groups, use_bias=use_bias, name=node.name,
        )

    def _pool(self, ff, node, env, pool_type):
        at = _attrs(node)
        assert at.get("auto_pad", "NOTSET") in ("", "NOTSET"), (
            f"auto_pad={at['auto_pad']} is not supported; export with explicit pads"
        )
        k = at["kernel_shape"]
        strides = at.get("strides", k)
        pads = at.get("pads", [0, 0, 0, 0])
        ph = (pads[0], pads[2]) if pads[0] != pads[2] else pads[0]
        pw = (pads[1], pads[3]) if pads[1] != pads[3] else pads[1]
        return ff.pool2d(env[node.input[0]], k[0], k[1], strides[0], strides[1], ph, pw, pool_type=pool_type, name=node.name)

    def handleMaxPool(self, ff, node, env):
        return self._pool(ff, node, env, PoolType.MAX)

    def handleAveragePool(self, ff, node, env):
        return self._pool(ff, node, env, PoolType.AVG)

    def handleGlobalAveragePool(self, ff, node, env):
        x = env[node.input[0]]
        h, w = x.shape[2], x.shape[3]
        return ff.pool2d(x, h, w, 1, 1, 0, 0, pool_type=PoolType.AVG, name=node.name)

    def handleBatchNormalization(self, ff, node, env):
        """BatchNormalization(X, scale, B, mean, var) — the trained
        statistics ride weight_map/state (reference: onnx/model.py's
        handleBatchNormalization)."""
        at = _attrs(node)
        ws = {}
        for wname, inp_idx in (("scale", 1), ("bias", 2), ("running_mean", 3), ("running_var", 4)):
            if len(node.input) > inp_idx:
                v = self.initializers.get(node.input[inp_idx])
                if v is not None:
                    ws[wname] = v
        if ws:
            self.weight_map[node.name] = ws
        return ff.batch_norm(
            env[node.input[0]], relu=False, eps=at.get("epsilon", 1e-5), name=node.name
        )

    def handleLayerNormalization(self, ff, node, env):
        """LayerNormalization (opset 17; HF BERT exports use it)."""
        at = _attrs(node)
        x = env[node.input[0]]
        axis = at.get("axis", -1)
        axis = axis % x.ndim
        axes = list(range(axis, x.ndim))
        ws = {}
        if len(node.input) > 1:
            s = self.initializers.get(node.input[1])
            if s is not None:
                ws["scale"] = s
        if len(node.input) > 2:
            b = self.initializers.get(node.input[2])
            if b is not None:
                ws["bias"] = b
        if ws:
            self.weight_map[node.name] = ws
        return ff.layer_norm(x, axes=axes, eps=at.get("epsilon", 1e-5), name=node.name)

    # -- linear -------------------------------------------------------
    def handleGemm(self, ff, node, env):
        """Gemm(x, W, b): W is [out, in] when transB=1 (the common export).

        alpha/beta/transA deviating from the defaults would silently
        change numerics — fail at import instead."""
        at = _attrs(node)
        if at.get("alpha", 1.0) != 1.0 or at.get("beta", 1.0) != 1.0 or at.get("transA", 0):
            raise NotImplementedError(
                f"Gemm node {node.name!r} uses alpha={at.get('alpha', 1.0)}, "
                f"beta={at.get('beta', 1.0)}, transA={at.get('transA', 0)}; "
                "only the default (1.0, 1.0, 0) configuration is supported"
            )
        w = self.initializers.get(node.input[1])
        assert w is not None
        out_dim = w.shape[0] if at.get("transB", 0) else w.shape[1]
        use_bias = len(node.input) > 2
        ws = {"kernel": np.ascontiguousarray(w.T) if at.get("transB", 0) else w}
        if use_bias:
            b = self.initializers.get(node.input[2])
            if b is not None:
                ws["bias"] = b
        self.weight_map[node.name] = ws
        return ff.dense(env[node.input[0]], out_dim, use_bias=use_bias, name=node.name)

    def load_weights(self, ffmodel) -> int:
        """After compile(): overwrite executor params with the graph's
        initializer weights. Returns the number of nodes updated."""
        return _load_weights_impl(self, ffmodel)

    def handleMatMul(self, ff, node, env):
        """MatMul with constant rhs = dense; tensor×tensor = batch_matmul
        (reference: onnx/model.py:309)."""
        rhs = node.input[1]
        if rhs in self.initializers:
            w = self.initializers[rhs]
            self.weight_map[node.name] = {"kernel": w}
            return ff.dense(env[node.input[0]], w.shape[-1], use_bias=False, name=node.name)
        return ff.batch_matmul(env[node.input[0]], env[rhs], name=node.name)

    # -- gather / reductions / misc ---------------------------------
    def handleGather(self, ff, node, env):
        """ONNX Gather = np.take. Supported forms: (a) embedding lookup —
        constant data table + integer index tensor on axis 0; (b) constant
        scalar index on any axis — lowered to split + reshape (the
        CLS-token slice pattern of BERT exports)."""
        at = _attrs(node)
        axis = at.get("axis", 0)
        data_name, idx_name = node.input[0], node.input[1]
        if data_name in self.initializers and axis == 0:
            table = self.initializers[data_name]
            assert table.ndim == 2, f"Gather table must be 2-D, got {table.shape}"
            self.weight_map[node.name] = {"embedding": table}
            return ff.embedding(env[idx_name], table.shape[0], table.shape[1], name=node.name)
        if idx_name in self.initializers:
            idx = self.initializers[idx_name]
            if idx.size == 1:
                x = env[data_name]
                i = int(idx.reshape(-1)[0]) % x.shape[axis]
                sizes = []
                if i > 0:
                    sizes.append(i)
                sizes.append(1)
                if x.shape[axis] - i - 1 > 0:
                    sizes.append(x.shape[axis] - i - 1)
                parts = ff.split(x, sizes, axis, name=f"{node.name}_split")
                picked = parts[1 if i > 0 else 0]
                new_shape = tuple(s for d, s in enumerate(picked.shape) if d != axis)
                return ff.reshape(picked, new_shape, name=node.name)
        raise NotImplementedError(
            f"Gather node {node.name!r}: only constant-table axis-0 lookup "
            "or constant scalar index is supported"
        )

    def handleReduceMean(self, ff, node, env):
        at = _attrs(node)
        axes = at.get("axes")
        if axes is None and len(node.input) > 1 and node.input[1] in self.initializers:
            axes = [int(v) for v in self.initializers[node.input[1]]]
        assert axes is not None, "ReduceMean without axes unsupported"
        return ff.mean(env[node.input[0]], list(axes), keepdims=bool(at.get("keepdims", 1)), name=node.name)

    def handleReduceSum(self, ff, node, env):
        at = _attrs(node)
        axes = at.get("axes")
        if axes is None and len(node.input) > 1 and node.input[1] in self.initializers:
            axes = [int(v) for v in self.initializers[node.input[1]]]
        assert axes is not None, "ReduceSum without axes unsupported"
        return ff.reduce_sum(env[node.input[0]], list(axes), keepdims=bool(at.get("keepdims", 1)), name=node.name)

    def handlePow(self, ff, node, env):
        exp = self.initializers.get(node.input[1])
        assert exp is not None and exp.size == 1, "Pow exponent must be a scalar initializer"
        return ff.pow(env[node.input[0]], float(exp.reshape(-1)[0]), name=node.name)

    def handleSqrt(self, ff, node, env):
        return ff.pow(env[node.input[0]], 0.5, name=node.name)

    def handleGelu(self, ff, node, env):  # com.microsoft / opset 20
        return ff.gelu(env[node.input[0]], name=node.name)

    def handleAttention(self, ff, node, env):
        """com.microsoft Attention: input [B,S,H], combined qkv weight
        [H, 3*H] + bias [3*H] — lowered to MultiHeadAttention with the
        packed projections split into wq/wk/wv (reference parity target:
        the onnx attention handlers)."""
        at = _attrs(node)
        num_heads = at["num_heads"]
        x = env[node.input[0]]
        hidden = x.shape[-1]
        w = self.initializers.get(node.input[1])
        assert w is not None and w.shape == (hidden, 3 * hidden), (
            f"Attention weight must be [{hidden}, {3 * hidden}], got "
            f"{None if w is None else w.shape}"
        )
        head_dim = hidden // num_heads
        wq, wk, wv = (w[:, i * hidden : (i + 1) * hidden] for i in range(3))
        ws = {
            "wq": wq.reshape(hidden, num_heads, head_dim),
            "wk": wk.reshape(hidden, num_heads, head_dim),
            "wv": wv.reshape(hidden, num_heads, head_dim),
        }
        use_bias = len(node.input) > 2 and node.input[2] in self.initializers
        if use_bias:
            b = self.initializers[node.input[2]]
            bq, bk, bv = (b[i * hidden : (i + 1) * hidden] for i in range(3))
            ws.update(
                bq=bq.reshape(num_heads, head_dim),
                bk=bk.reshape(num_heads, head_dim),
                bv=bv.reshape(num_heads, head_dim),
                bo=np.zeros(hidden, w.dtype),
            )
            # our MHA couples use_bias to an output bias too; Attention has
            # no output projection at all, so wo must become identity
        ws["wo"] = np.eye(hidden, dtype=w.dtype).reshape(num_heads, head_dim, hidden)
        self.weight_map[node.name] = ws
        return ff.multihead_attention(x, x, x, hidden, num_heads, bias=use_bias, name=node.name)


def _load_weights_impl(onnx_model: "ONNXModel", ffmodel) -> int:
    """Copy the graph's initializer weights into the compiled executor's
    tensors, in place and on the model's device (serving parity with
    triton/src/onnx_parser.cc, which parses weight tensors out of the
    ModelProto). Returns the number of nodes updated.

    Every initializer is checked against the compiled parameter's shape
    before it is placed: a mismatch raises naming the node and the
    weight, instead of corrupting the parameters."""
    ex = ffmodel.executor
    assert ex is not None, "compile() the ffmodel before load_weights()"
    by_name = {n.name: n for n in ffmodel.graph.nodes.values() if n.name}
    updated = 0
    with torch.no_grad():
        for ff_name, ws in onnx_model.weight_map.items():
            node = by_name.get(ff_name)
            if node is None:
                continue
            key = node_key(node)
            touched = False
            for store in (ex.params, ex.state):
                if key not in store:
                    continue
                cur = store[key]
                for wname, value in ws.items():
                    if wname not in cur:
                        continue
                    value = np.asarray(value)
                    want = tuple(cur[wname].shape)
                    if tuple(value.shape) != want:
                        raise ValueError(
                            f"ONNX initializer for node {ff_name!r} weight {wname!r} "
                            f"has shape {tuple(value.shape)}, compiled parameter "
                            f"expects {want}"
                        )
                    # in place: the executor's captured steps hold these tensors
                    cur[wname].copy_(to_tensor(value).to(cur[wname].dtype))
                    touched = True
            if touched:
                updated += 1
    return updated


def _to_numpy(init) -> np.ndarray:
    """TensorProto -> ndarray (uses onnx.numpy_helper when available,
    raw_data/float_data fields on mocks otherwise)."""
    if HAS_ONNX and isinstance(init, onnx.TensorProto):
        from onnx import numpy_helper

        return numpy_helper.to_array(init)
    if getattr(init, "numpy", None) is not None:
        arr = init.numpy
        return arr() if callable(arr) else arr
    if getattr(init, "float_data", None):
        return np.array(init.float_data, np.float32).reshape(list(init.dims))
    if getattr(init, "int64_data", None):
        return np.array(init.int64_data, np.int64).reshape(list(init.dims))
    raise ValueError(f"cannot convert initializer {getattr(init, 'name', '?')}")


def onnx_to_flexflow(model, ffmodel, input_tensors: Dict[str, object]) -> List:
    """Convenience wrapper (reference: onnx README usage)."""
    return ONNXModel(model).apply(ffmodel, input_tensors)
