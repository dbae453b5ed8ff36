"""torch.fx -> FFModel importer (port of
``flexflow_tpu/frontends/torch/model.py``).

Reference: python/flexflow/torch/model.py: the reference traces with
torch.fx, serializes per-node records to a ``.ff`` file, and replays them
into FFModel (``PyTorchModel.apply``). Here tracing and replay happen in
one pass (a serialized form is available via ``to_records`` and
``export_ff``), and ``copy_weights`` copies the module's parameters into
the compiled executor's tensors on the model's device.

The ``.ff`` file is the JAX package's format (``"flexflow_tpu.ff.v1"``,
enums as ``"ClassName.MEMBER"``, builders called by keyword): a file
written by either package replays in the other.

Layout notes: torch Linear stores weight [out, in]; the Linear kernel is
[in, out] (y = x @ W). torch Conv2d weight is OIHW, matching Conv2DOp.
This subpackage is named ``torch``; it imports the top-level ``torch``
(absolute imports only).
"""
from __future__ import annotations

import operator
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.fx
import torch.nn as nn
import torch.nn.functional as F

from ...core.types import PoolType
from ...runtime.executor import node_key


class PyTorchModel:
    """Reference: PyTorchModel (torch/model.py) — wraps a traced module."""

    def __init__(self, module, seq_length: Optional[int] = None):
        self.module = module
        self.seq_length = seq_length
        self.traced = torch.fx.symbolic_trace(module)
        # fx submodule target -> ALL ff node names created from it (a
        # module applied twice yields two FF nodes; weights are ported
        # to every instance)
        self.name_map: Dict[str, List[str]] = {}

    # -- the importer -------------------------------------------------
    def torch_to_ff(self, ffmodel, input_tensors: Sequence) -> List:
        """Replay the traced graph into ``ffmodel``; returns output tensors.

        ``input_tensors`` are FFModel tensors matching the module's
        placeholders in order (reference: PyTorchModel.apply).
        """
        env: Dict[str, object] = {}
        placeholders = [n for n in self.traced.graph.nodes if n.op == "placeholder"]
        assert len(placeholders) == len(input_tensors), (
            f"model takes {len(placeholders)} inputs, got {len(input_tensors)}"
        )
        outputs: List = []
        for node in self.traced.graph.nodes:
            if node.op == "placeholder":
                env[node.name] = input_tensors[placeholders.index(node)]
            elif node.op == "get_attr":
                raise NotImplementedError(f"get_attr ({node.target}) not supported; register it as a buffer-free module")
            elif node.op == "call_module":
                mod = self.traced.get_submodule(node.target)
                env[node.name] = self._module(ffmodel, node, mod, env)
                self.name_map.setdefault(node.target, []).append(node.name)
            elif node.op == "call_function":
                env[node.name] = self._function(ffmodel, node, env)
            elif node.op == "call_method":
                env[node.name] = self._method(ffmodel, node, env)
            elif node.op == "output":
                args = node.args[0]
                outs = args if isinstance(args, (tuple, list)) else [args]
                outputs = [env[a.name] for a in outs]
        return outputs

    # -- call_module dispatch ----------------------------------------
    def _module(self, ff, node, mod, env):
        x = [env[a.name] for a in node.args if isinstance(a, torch.fx.Node)]
        name = node.name
        if isinstance(mod, nn.Linear):
            return ff.dense(x[0], mod.out_features, use_bias=mod.bias is not None, name=name)
        if isinstance(mod, nn.Conv2d):
            assert mod.padding_mode == "zeros"
            pad = mod.padding if isinstance(mod.padding, tuple) else (mod.padding, mod.padding)
            return ff.conv2d(
                x[0], mod.out_channels, mod.kernel_size[0], mod.kernel_size[1],
                mod.stride[0], mod.stride[1], pad[0], pad[1],
                groups=mod.groups, use_bias=mod.bias is not None, name=name,
            )
        if isinstance(mod, (nn.MaxPool2d, nn.AvgPool2d)):
            k = mod.kernel_size if isinstance(mod.kernel_size, tuple) else (mod.kernel_size,) * 2
            s = mod.stride if isinstance(mod.stride, tuple) else (mod.stride or mod.kernel_size,) * 2
            p = mod.padding if isinstance(mod.padding, tuple) else (mod.padding, mod.padding)
            pt = PoolType.MAX if isinstance(mod, nn.MaxPool2d) else PoolType.AVG
            return ff.pool2d(x[0], k[0], k[1], s[0], s[1], p[0], p[1], pool_type=pt, name=name)
        if isinstance(mod, nn.AdaptiveAvgPool2d):
            # reference AdaptivePool2dNode: supported when it reduces to a
            # realizable fixed-kernel pool; (1,1) is global average
            h, w = x[0].shape[2], x[0].shape[3]
            oh, ow = mod.output_size if isinstance(mod.output_size, tuple) else (mod.output_size,) * 2
            assert h % oh == 0 and w % ow == 0, "adaptive pool must divide input"
            kh, kw = h // oh, w // ow
            return ff.pool2d(x[0], kh, kw, kh, kw, 0, 0, pool_type=PoolType.AVG, name=name)
        if isinstance(mod, nn.BatchNorm2d):
            return ff.batch_norm(x[0], relu=False, name=name)
        if isinstance(mod, nn.LayerNorm):
            axes = list(range(x[0].ndim - len(mod.normalized_shape), x[0].ndim))
            return ff.layer_norm(x[0], axes=axes, elementwise_affine=mod.elementwise_affine, eps=mod.eps, name=name)
        if isinstance(mod, nn.Softmax):
            return ff.softmax(x[0], axis=mod.dim, name=name)
        if isinstance(mod, nn.Dropout):
            return ff.dropout(x[0], mod.p, name=name)
        if isinstance(mod, nn.Flatten):
            assert mod.start_dim == 1
            return ff.flat(x[0], name=name)
        if isinstance(mod, nn.ReLU):
            return ff.relu(x[0], name=name)
        if isinstance(mod, nn.GELU):
            return ff.gelu(x[0], name=name)
        if isinstance(mod, nn.Sigmoid):
            return ff.sigmoid(x[0], name=name)
        if isinstance(mod, nn.Tanh):
            return ff.tanh(x[0], name=name)
        if isinstance(mod, nn.ELU):
            return ff.elu(x[0], name=name)
        if isinstance(mod, nn.Identity):
            return ff.identity(x[0], name=name)
        if isinstance(mod, nn.Embedding):
            return ff.embedding(x[0], mod.num_embeddings, mod.embedding_dim, name=name)
        if isinstance(mod, nn.MultiheadAttention):
            assert mod.batch_first, "only batch_first MultiheadAttention is supported"
            q, k, v = (x + [x[0], x[0]])[:3]
            return ff.multihead_attention(q, k, v, mod.embed_dim, mod.num_heads, bias=mod.in_proj_bias is not None, name=name)
        raise NotImplementedError(f"unsupported module {type(mod).__name__}")

    # -- call_function dispatch --------------------------------------
    def _function(self, ff, node, env):
        t = node.target
        name = node.name

        def get(a):
            return env[a.name] if isinstance(a, torch.fx.Node) else a

        args = [get(a) for a in node.args]
        if t in (operator.add, torch.add):
            return self._bin_or_scalar(ff, "add", args, name)
        if t in (operator.sub, torch.sub):
            return self._bin_or_scalar(ff, "sub", args, name)
        if t in (operator.mul, torch.mul):
            return self._bin_or_scalar(ff, "mul", args, name)
        if t in (operator.truediv, torch.div):
            return self._bin_or_scalar(ff, "div", args, name)
        if t in (F.relu, torch.relu):
            return ff.relu(args[0], name=name)
        if t is F.gelu:
            return ff.gelu(args[0], name=name)
        if t in (F.sigmoid, torch.sigmoid):
            return ff.sigmoid(args[0], name=name)
        if t in (F.tanh, torch.tanh):
            return ff.tanh(args[0], name=name)
        if t in (torch.exp,):
            return ff.exp(args[0], name=name)
        if t in (torch.sin,):
            return ff.sin(args[0], name=name)
        if t in (torch.cos,):
            return ff.cos(args[0], name=name)
        if t in (torch.pow, operator.pow):
            return ff.pow(args[0], float(args[1]), name=name)
        if t is torch.rsqrt:
            return ff.rsqrt(args[0], name=name)
        if t in (torch.cat, torch.concat):
            tensors = args[0]
            axis = node.kwargs.get("dim", args[1] if len(args) > 1 else 0)
            return ff.concat(list(tensors), axis, name=name)
        if t is torch.split:
            axis = node.kwargs.get("dim", args[2] if len(args) > 2 else 0)
            return ff.split(args[0], self._split_sizes(args[0], args[1], axis), axis, name=name)
        if t is torch.flatten:
            start = node.kwargs.get("start_dim", args[1] if len(args) > 1 else 0)
            end = node.kwargs.get("end_dim", args[2] if len(args) > 2 else -1)
            assert start == 1 and end in (-1, args[0].ndim - 1), (
                f"only flatten(start_dim=1, end_dim=-1) is supported, got ({start}, {end})"
            )
            return ff.flat(args[0], name=name)
        if t in (torch.matmul, torch.bmm):
            return ff.batch_matmul(args[0], args[1], name=name)
        if t is F.softmax:
            axis = node.kwargs.get("dim", args[1] if len(args) > 1 else -1)
            return ff.softmax(args[0], axis=axis, name=name)
        if t is F.dropout:
            p = node.kwargs.get("p", args[1] if len(args) > 1 else 0.5)
            return ff.dropout(args[0], p, name=name)
        if t is torch.mean:
            dims = node.kwargs.get("dim", args[1] if len(args) > 1 else None)
            keep = node.kwargs.get("keepdim", False)
            dims = [dims] if isinstance(dims, int) else list(dims)
            return ff.mean(args[0], dims, keepdims=keep, name=name)
        if t is torch.transpose:
            return self._transpose(ff, args[0], args[1], args[2], name)
        if t is operator.getitem:
            seq, idx = args
            return seq[idx]
        if t is torch.reshape:
            return ff.reshape(args[0], tuple(args[1]), name=name)
        raise NotImplementedError(f"unsupported function {t}")

    # -- call_method dispatch ----------------------------------------
    def _method(self, ff, node, env):
        name = node.name

        def get(a):
            return env[a.name] if isinstance(a, torch.fx.Node) else a

        args = [get(a) for a in node.args]
        m = node.target
        if m == "view" or m == "reshape":
            shape = args[1:] if not isinstance(args[1], (tuple, list)) else list(args[1])
            shape = [s for s in shape]
            if -1 in shape:
                known = int(np.prod([s for s in shape if s != -1]))
                total = int(np.prod(args[0].shape))
                shape[shape.index(-1)] = total // known
            return ff.reshape(args[0], tuple(shape), name=name)
        if m == "flatten":
            start = node.kwargs.get("start_dim", args[1] if len(args) > 1 else 0)
            end = node.kwargs.get("end_dim", args[2] if len(args) > 2 else -1)
            assert start == 1 and end in (-1, args[0].ndim - 1), (
                f"only flatten(start_dim=1, end_dim=-1) is supported, got ({start}, {end})"
            )
            return ff.flat(args[0], name=name)
        if m == "transpose":
            return self._transpose(ff, args[0], args[1], args[2], name)
        if m == "permute":
            perm = args[1:] if not isinstance(args[1], (tuple, list)) else list(args[1])
            return ff.transpose(args[0], tuple(perm), name=name)
        if m == "contiguous":
            return args[0]
        if m == "relu":
            return ff.relu(args[0], name=name)
        if m == "split":
            axis = node.kwargs.get("dim", args[2] if len(args) > 2 else 0)
            return ff.split(args[0], self._split_sizes(args[0], args[1], axis), axis, name=name)
        if m == "mean":
            dims = [args[1]] if isinstance(args[1], int) else list(args[1])
            return ff.mean(args[0], dims, keepdims=node.kwargs.get("keepdim", False), name=name)
        if m in ("add", "sub", "mul", "div"):
            return self._bin_or_scalar(ff, m, args, name)
        raise NotImplementedError(f"unsupported method {m}")

    @staticmethod
    def _split_sizes(x, arg, axis):
        """torch.split's int arg is the chunk SIZE; ff.split's int arg is
        the number of chunks — convert to an explicit size list."""
        if not isinstance(arg, int):
            return list(arg)
        n = x.shape[axis]
        sizes = [arg] * (n // arg)
        if n % arg:
            sizes.append(n % arg)
        return sizes

    @staticmethod
    def _bin_or_scalar(ff, kind, args, name):
        bin_fn = {"add": ff.add, "sub": ff.subtract, "mul": ff.multiply, "div": ff.divide}[kind]
        scalar_fn = {"add": ff.scalar_add, "sub": ff.scalar_sub, "mul": ff.scalar_multiply, "div": ff.scalar_true_divide}[kind]
        a, b = args[0], args[1]
        if isinstance(b, (int, float)):
            return scalar_fn(a, float(b), name=name)
        if isinstance(a, (int, float)):
            # scalar on the left: add/mul commute; sub/div need rewriting
            if kind in ("add", "mul"):
                return scalar_fn(b, float(a), name=name)
            if kind == "sub":  # c - x = -x + c
                neg = ff.scalar_multiply(b, -1.0, inplace=False, name=f"{name}_neg")
                return ff.scalar_add(neg, float(a), name=name)
            # c / x = c * x^-1
            inv = ff.pow(b, -1.0, name=f"{name}_inv")
            return ff.scalar_multiply(inv, float(a), inplace=False, name=name)
        return bin_fn(a, b, name=name)

    @staticmethod
    def _transpose(ff, x, d0, d1, name):
        perm = list(range(x.ndim))
        perm[d0], perm[d1] = perm[d1], perm[d0]
        return ff.transpose(x, tuple(perm), name=name)

    # -- serialized form (reference's .ff file analog) ----------------
    def to_records(self) -> List[str]:
        recs = []
        for node in self.traced.graph.nodes:
            ins = ",".join(a.name for a in node.all_input_nodes)
            recs.append(f"{node.name};{ins};{node.op};{node.target}")
        return recs

    def export_ff(self, path: str, ffmodel_factory, input_shapes: Sequence[tuple]) -> None:
        """Serialize the traced model to a ``.ff`` file that replays into
        an FFModel WITHOUT torch (reference: the flat-file format written
        by python/flexflow/torch/model.py and replayed by
        PyTorchModel.apply). The file records the FF builder calls the
        import makes, so every supported module/function round-trips.

        ffmodel_factory() -> a fresh FFModel; input_shapes: one (shape,
        dtype-name?) per placeholder."""
        import json as _json

        ff = ffmodel_factory()
        rec = _FFRecorder(ff)
        inputs = [ff.create_tensor(tuple(s), name=f"input{i}") for i, s in enumerate(input_shapes)]
        for i, t in enumerate(inputs):
            rec.bind(t, f"$in{i}")
        outs = self.torch_to_ff(rec, inputs)
        payload = {
            "format": "flexflow_tpu.ff.v1",
            "inputs": [list(map(int, s)) for s in input_shapes],
            "records": rec.records,
            "outputs": [rec.ref_of(t) for t in outs],
        }
        with open(path, "w") as f:
            f.write(_json.dumps(payload, indent=1))


def replay_ff(path: str, ffmodel, input_tensors: Sequence) -> List:
    """Rebuild a model from a ``.ff`` file into ``ffmodel`` — no torch
    needed (reference: PyTorchModel.apply replaying the flat file)."""
    import json as _json

    with open(path) as f:
        payload = _json.loads(f.read())
    assert payload.get("format") == "flexflow_tpu.ff.v1", payload.get("format")
    env: Dict[str, object] = {f"$in{i}": t for i, t in enumerate(input_tensors)}

    def resolve(v):
        if isinstance(v, str) and v.startswith("$"):
            return env[v]
        if isinstance(v, list):
            return [resolve(x) for x in v]
        if isinstance(v, dict) and "__enum__" in v:
            return _decode_enum(v["__enum__"])
        if isinstance(v, dict) and "__tuple__" in v:
            return tuple(resolve(x) for x in v["__tuple__"])
        return v

    last = None
    for r in payload["records"]:
        fn = getattr(ffmodel, r["op"])
        args = [resolve(a) for a in r["args"]]
        kwargs = {k: resolve(v) for k, v in r["kwargs"].items()}
        out = fn(*args, **kwargs)
        outs = out if isinstance(out, (list, tuple)) else [out]
        for ref, t in zip(r["out"], outs):
            env[ref] = t
        last = out
    return [env[ref] for ref in payload["outputs"]]


def _decode_enum(s: str):
    from ...core import types as _types

    cls_name, member = s.split(".")
    return getattr(getattr(_types, cls_name), member)


class _FFRecorder:
    """Proxy over FFModel that records every builder call as pure data
    (the .ff serialization) while executing it for real."""

    def __init__(self, ff):
        self._ff = ff
        self.records: List[dict] = []
        self._refs: Dict[int, str] = {}
        self._count = 0

    def bind(self, tensor, ref: str):
        self._refs[id(tensor)] = ref

    def ref_of(self, tensor) -> str:
        return self._refs[id(tensor)]

    def _encode(self, v):
        import enum

        if id(v) in self._refs:
            return self._refs[id(v)]
        if isinstance(v, enum.Enum):
            return {"__enum__": f"{type(v).__name__}.{v.name}"}
        if isinstance(v, tuple):
            return {"__tuple__": [self._encode(x) for x in v]}
        if isinstance(v, list):
            return [self._encode(x) for x in v]
        if isinstance(v, (int, float, str, bool)) or v is None:
            return v
        if isinstance(v, np.integer):
            return int(v)
        raise TypeError(f"cannot serialize builder arg {v!r} to .ff")

    def __getattr__(self, name):
        target = getattr(self._ff, name)
        if not callable(target):
            return target

        def wrapper(*args, **kwargs):
            enc_args = [self._encode(a) for a in args]
            enc_kwargs = {k: self._encode(v) for k, v in kwargs.items()}
            out = target(*args, **kwargs)
            outs = out if isinstance(out, (list, tuple)) else [out]
            refs = []
            for t in outs:
                ref = f"$t{self._count}"
                self._count += 1
                self._refs[id(t)] = ref
                refs.append(ref)
            self.records.append(
                {"op": name, "args": enc_args, "kwargs": enc_kwargs, "out": refs}
            )
            return out

        return wrapper


def torch_to_flexflow(module, ffmodel, input_tensors, seq_length=None):
    """Reference: flexflow.torch.fx.torch_to_flexflow (README.md:10-17)."""
    m = PyTorchModel(module, seq_length=seq_length)
    return m.torch_to_ff(ffmodel, input_tensors), m


def copy_weights(torch_module, ffmodel, name_map: Dict[str, List[str]]) -> None:
    """Copy torch parameters into the compiled executor, in place and on
    the model's device.

    name_map: fx submodule target -> ff node names (PyTorchModel.name_map;
    one target maps to several nodes when the module is applied more than
    once: each FF instance receives the shared torch weights). The
    reference's align tests do this via ParallelTensor::set_tensor
    (parallel_tensor.h:165). Modules other than Linear, Conv2d, LayerNorm,
    BatchNorm2d and Embedding are skipped, as in the JAX package (so
    ``nn.MultiheadAttention`` keeps its initial weights)."""
    ex = ffmodel.executor
    assert ex is not None, "compile() the ffmodel first"
    by_name = {n.name: n for n in ffmodel.graph.nodes.values() if n.name}
    pairs = [
        (target, ff_name)
        for target, ff_names in name_map.items()
        for ff_name in (ff_names if isinstance(ff_names, list) else [ff_names])
    ]

    def put(group, name, value):
        group[name].copy_(value.detach().to(group[name].device, group[name].dtype))

    with torch.no_grad():
        for target, ff_name in pairs:
            mod = torch_module.get_submodule(target)
            node = by_name.get(ff_name)
            if node is None:
                continue
            key = node_key(node)
            if key not in ex.params:
                continue
            ws = ex.params[key]
            sd = mod.state_dict()
            if isinstance(mod, nn.Linear):
                put(ws, "kernel", sd["weight"].T)
                if "bias" in sd and "bias" in ws:
                    put(ws, "bias", sd["bias"])
            elif isinstance(mod, nn.Conv2d):
                put(ws, "kernel", sd["weight"])
                if "bias" in sd and "bias" in ws:
                    put(ws, "bias", sd["bias"])
            elif isinstance(mod, (nn.LayerNorm, nn.BatchNorm2d)):
                put(ws, "scale", sd["weight"])
                put(ws, "bias", sd["bias"])
                if "running_mean" in sd and key in ex.state:  # non-trainable -> state
                    put(ex.state[key], "running_mean", sd["running_mean"])
                    put(ex.state[key], "running_var", sd["running_var"])
            elif isinstance(mod, nn.Embedding):
                put(ws, "embedding", sd["weight"])
