"""FFModel: the model-building and training API (port of the builders
the BERT-style training graph uses, and of compile/fit/evaluate/predict,
from ``flexflow_tpu/model.py``).

Building a layer records a graph node; ``compile`` makes a single-GPU
:class:`~flexflow_tpu_torch.runtime.executor.Executor` and its weights;
``fit`` runs the training loop and prints the reference's ELAPSED TIME /
THROUGHPUT line. The model runs on the GPU unless ``device="cpu"`` is
passed.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .config import FFConfig
from .core.device import resolve_device
from .core.graph import Node, PCGraph
from .core.tensor import TensorSpec
from .core.types import ActiMode, CompMode, DataType, LossType, MetricsType, OpType
from .ops import get_op_def
from .ops.attention import MultiHeadAttentionParams
from .ops.elementwise import ElementBinaryParams
from .ops.io_ops import InputParams
from .ops.linear import LinearParams
from .ops.norm import LayerNormParams
from .parallel.propagation import infer_all_specs
from .runtime.convert import to_tensor
from .runtime.executor import Executor, node_key
from .runtime.metrics import PerfMetrics
from .runtime.optimizers import Optimizer, SGDOptimizer


class Tensor:
    """Frontend tensor handle: (graph node, output index) + logical spec."""

    def __init__(self, model: "FFModel", node: Node, idx: int, spec: TensorSpec):
        self._model = model
        self.node = node
        self.idx = idx
        self.spec = spec

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.spec.shape

    @property
    def dtype(self) -> DataType:
        return self.spec.dtype

    @property
    def ndim(self) -> int:
        return self.spec.ndim

    def __repr__(self):
        return f"Tensor(shape={self.shape}, dtype={self.dtype.value}, node={self.node.guid})"


class FFModel:
    """Model builder + trainer (reference: model.h:328).

    ``device`` None means CUDA, and raises where no GPU is present;
    ``device="cpu"`` runs the plain PyTorch path. ``seed`` (default
    ``config.seed``) seeds the weights."""

    def __init__(self, config: Optional[FFConfig] = None, seed: Optional[int] = None,
                 device=None):
        self.config = config or FFConfig()
        self.device = resolve_device(device)
        self.graph = PCGraph()
        self._num_inputs = 0
        self._seed = self.config.seed if seed is None else seed
        self.executor: Optional[Executor] = None
        self._outputs: List[Tensor] = []

    # ------------------------------------------------------------ helpers
    def _add(self, op_type: OpType, params, inputs: Sequence[Tensor], name: str = "") -> List[Tensor]:
        node = self.graph.new_node(op_type, params, name)
        for i, t in enumerate(inputs):
            self.graph.add_edge(t.node, node, t.idx, i)
        out_specs = get_op_def(op_type).infer_output_specs(params, [t.spec for t in inputs])
        return [Tensor(self, node, i, s) for i, s in enumerate(out_specs)]

    def _one(self, *args, **kw) -> Tensor:
        return self._add(*args, **kw)[0]

    @staticmethod
    def _acti(activation) -> ActiMode:
        """Accept ActiMode, its string value ("relu"), or None."""
        if activation is None:
            return ActiMode.NONE
        if isinstance(activation, ActiMode):
            return activation
        return ActiMode(activation)

    # ------------------------------------------------------------- layers
    def create_tensor(self, shape: Sequence[int], dtype: DataType = DataType.FLOAT, name: str = "") -> Tensor:
        """An input placeholder (reference: FFModel::create_tensor)."""
        params = InputParams(tuple(int(s) for s in shape), dtype, self._num_inputs)
        self._num_inputs += 1
        return self._one(OpType.INPUT, params, [], name=name or f"input{params.input_index}")

    def dense(
        self,
        input: Tensor,
        out_dim: int,
        activation: ActiMode = ActiMode.NONE,
        use_bias: bool = True,
        datatype: Optional[DataType] = None,
        kernel_initializer: str = "glorot_uniform",
        bias_initializer: str = "zeros",
        name: str = "",
    ) -> Tensor:
        p = LinearParams(
            out_dim, use_bias, self._acti(activation), datatype or input.dtype,
            kernel_initializer, bias_initializer,
        )
        return self._one(OpType.LINEAR, p, [input], name=name)

    def multihead_attention(
        self,
        query: Tensor,
        key: Tensor,
        value: Tensor,
        embed_dim: int,
        num_heads: int,
        kdim: int = 0,
        vdim: int = 0,
        dropout: float = 0.0,
        bias: bool = False,
        add_bias_kv: bool = False,
        add_zero_attn: bool = False,
        causal: bool = False,
        name: str = "",
    ) -> Tensor:
        if add_bias_kv or add_zero_attn:
            raise NotImplementedError("add_bias_kv / add_zero_attn are not supported")
        if dropout > 0.0:
            raise NotImplementedError("attention dropout is not ported; use dropout=0")
        p = MultiHeadAttentionParams(embed_dim, num_heads, kdim, vdim, dropout, bias, causal, query.dtype)
        return self._one(OpType.MULTIHEAD_ATTENTION, p, [query, key, value], name=name)

    def layer_norm(
        self,
        input: Tensor,
        axes: Optional[Sequence[int]] = None,
        elementwise_affine: bool = True,
        eps: float = 1e-5,
        name: str = "",
    ) -> Tensor:
        if axes is None:
            axes = [input.ndim - 1]
        p = LayerNormParams(tuple(axes), elementwise_affine, eps, input.dtype)
        return self._one(OpType.LAYERNORM, p, [input], name=name)

    def add(self, x: Tensor, y: Tensor, inplace_a: bool = False, name: str = "") -> Tensor:
        return self._one(OpType.EW_ADD, ElementBinaryParams(OpType.EW_ADD, inplace_a), [x, y], name=name)

    # -------------------------------------------------------------- compile
    def compile(
        self,
        optimizer: Optional[Optimizer] = None,
        loss_type: Optional[LossType] = None,
        metrics: Sequence[MetricsType] = (),
        comp_mode: CompMode = CompMode.TRAINING,
        outputs: Optional[Sequence[Tensor]] = None,
    ) -> "FFModel":
        """Build the single-GPU executor and its weights (reference:
        FFModel::compile, model.cc:2811)."""
        if optimizer is None:
            optimizer = SGDOptimizer(lr=self.config.learning_rate, weight_decay=self.config.weight_decay)
        self.optimizer = optimizer
        self.loss_type = loss_type
        self.metrics = list(metrics)
        self.comp_mode = comp_mode
        self._outputs = list(outputs) if outputs else [self._default_output()]
        self.executor = Executor(
            graph=self.graph,
            device=self.device,
            loss_type=loss_type,
            metric_types=tuple(metrics),
            optimizer=optimizer if comp_mode == CompMode.TRAINING else None,
            outputs=[(t.node.guid, t.idx) for t in self._outputs],
        )
        self.executor.initialize(torch.Generator().manual_seed(self._seed))
        return self

    def _default_output(self) -> Tensor:
        sinks = self.graph.sink_nodes()
        if len(sinks) != 1:
            raise ValueError(f"model has {len(sinks)} sink nodes; pass outputs= to compile()")
        specs = infer_all_specs(self.graph)
        n = sinks[0]
        return Tensor(self, n, 0, specs[n.guid][0])

    # ----------------------------------------------------------------- fit
    def _as_batches(self, x, y) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """The whole dataset on the model's device, once (loading counts
        as set-up, not as training time), each array in its own dtype
        (float32, bfloat16 or float16, numpy or torch)."""
        xs = [x] if isinstance(x, (np.ndarray, torch.Tensor)) else list(x)
        return [to_tensor(xx, self.device) for xx in xs], to_tensor(y, self.device)

    def fit(
        self,
        x: Union[np.ndarray, torch.Tensor, Sequence],
        y: Union[np.ndarray, torch.Tensor],
        epochs: Optional[int] = None,
        batch_size: Optional[int] = None,
        verbose: bool = True,
        trace_window: Optional[int] = None,
    ) -> PerfMetrics:
        """Training loop (reference: FFModel.fit flexflow_cffi.py:2044).

        Steps run one after another; their metrics are read back to the
        host once per window of ``trace_window`` steps (default
        ``FFConfig.trace_window``), so the host may queue a window's work
        ahead of the device. The arithmetic is the same for any window."""
        if self.executor is None:
            raise RuntimeError("call compile() first")
        xs, y = self._as_batches(x, y)
        epochs = epochs or self.config.epochs
        bs = batch_size or self.config.batch_size
        tw = max(1, trace_window or self.config.trace_window)
        steps = xs[0].shape[0] // bs
        perf = PerfMetrics()
        interval = max(1, self.config.printing_interval)
        self.step_losses: List[float] = []
        t0 = time.perf_counter()
        for epoch in range(epochs):
            for w0 in range(0, steps, tw):
                window = []
                for step in range(w0, min(steps, w0 + tw)):
                    lo = step * bs
                    window.append(self.executor.train_batch(
                        [xx[lo:lo + bs] for xx in xs], y[lo:lo + bs]))
                for i, mets in enumerate(window):  # one host sync per window
                    host = {k: float(v) for k, v in mets.items()}
                    perf.update({k: v for k, v in host.items() if k != "loss"})
                    self.step_losses.append(host["loss"])
                    if verbose and (w0 + i) % interval == 0:
                        print(f"epoch {epoch} step {w0 + i}/{steps} "
                              f"loss {host['loss']:.4f} acc {perf.accuracy:.4f}")
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        elapsed = time.perf_counter() - t0
        thru = epochs * steps * bs / max(1e-9, elapsed)
        if verbose:
            print(f"ELAPSED TIME = {elapsed:.4f}s THROUGHPUT = {thru:.2f} samples/s")
        self.last_elapsed = elapsed
        self.last_throughput = thru
        return perf

    def evaluate(self, x, y, batch_size: Optional[int] = None) -> PerfMetrics:
        if self.executor is None:
            raise RuntimeError("call compile() first")
        xs, y = self._as_batches(x, y)
        bs = batch_size or self.config.batch_size
        perf = PerfMetrics()
        for step in range(xs[0].shape[0] // bs):
            lo = step * bs
            mets = self.executor.eval_batch([xx[lo:lo + bs] for xx in xs], y[lo:lo + bs])
            perf.update({k: float(v) for k, v in mets.items() if k != "loss"})
        return perf

    def predict(self, x) -> torch.Tensor:
        if self.executor is None:
            raise RuntimeError("call compile() first")
        xs = [x] if isinstance(x, (np.ndarray, torch.Tensor)) else list(x)
        return self.executor.predict(xs)[0]

    # ------------------------------------------------------------- weights
    def _weight_group(self, layer: Union[Tensor, str]) -> Tuple[str, Dict[str, torch.Tensor]]:
        if self.executor is None:
            raise RuntimeError("call compile() first")
        key = node_key(layer.node) if isinstance(layer, Tensor) else self.executor.node_key(layer)
        return key, self.executor.params.get(key, {})

    def get_weight(self, layer: Union[Tensor, str], name: str) -> np.ndarray:
        """One weight as a host array; ``layer`` is the layer's output
        Tensor or its name (reference: ParallelTensorBase::get_tensor).
        numpy has no bfloat16: a bfloat16 weight comes back as float32,
        which holds every bfloat16 value exactly."""
        key, group = self._weight_group(layer)
        if name not in group:
            raise KeyError(f"no weight {name!r} on {key}; has {sorted(group)}")
        w = group[name].detach()
        if w.dtype == torch.bfloat16:
            w = w.float()
        return w.cpu().numpy().copy()  # never a view of the weight

    @torch.no_grad()
    def set_weight(self, layer: Union[Tensor, str], name: str, value) -> None:
        """Overwrite one weight in place from host data (reference:
        ParallelTensorBase::set_tensor); the weight keeps its dtype."""
        key, group = self._weight_group(layer)
        if name not in group:
            raise KeyError(f"no weight {name!r} on {key}")
        cur = group[name]
        src = to_tensor(value).to(cur.dtype)
        if tuple(src.shape) != tuple(cur.shape):
            raise ValueError(f"shape {tuple(src.shape)} != {tuple(cur.shape)} for {key}.{name}")
        cur.copy_(src)

    def set_weights(self, named: Dict[str, Dict[str, torch.Tensor]]) -> None:
        """Every weight from ``{layer_name: {weight_name: tensor}}``
        (``runtime/convert.py::params_from_numpy``); the named layers'
        weight sets must match the model's exactly."""
        if self.executor is None:
            raise RuntimeError("call compile() first")
        by_key = {self.executor.node_key(layer): (layer, ws) for layer, ws in named.items()}
        if set(by_key) != set(self.executor.params):
            raise ValueError("the named layers do not cover the model's weights exactly")
        for key, (layer, ws) in by_key.items():
            if set(ws) != set(self.executor.params[key]):
                raise ValueError(f"layer {layer!r} has weights {sorted(ws)}, "
                                 f"expected {sorted(self.executor.params[key])}")
            for name, value in ws.items():
                self.set_weight(layer, name, value)
