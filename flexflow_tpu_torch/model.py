"""FFModel: the model-building and training API (port of the layer
methods the BERT graphs with their heads, the seq2seq transformer, the
vision models, NMT, the recommenders and the mixture of experts use, of
the graph's weight, reduction, batch-matmul and recurrent layers, of
compile/fit/evaluate/predict, of the checkpoint and data-loader entry
points, and of ``profile``, ``recompile_on_condition``, ``get_output``,
``num_layers``, ``parallel_tensor`` and ``parallel_weight``, from
``flexflow_tpu/model.py``).

Building a layer records a graph node; ``compile`` picks the strategy
(data parallelism, a strategy file, or the Unity search) and makes the
:class:`~flexflow_tpu_torch.runtime.executor.Executor` of one device and
its weights, or, for a ``"data"`` axis of N > 1 devices, a
:class:`~flexflow_tpu_torch.runtime.data_parallel.DataParallelExecutor`
on each of N ranks, or, with a ``"model"`` axis (alone or with
``"data"``), a
:class:`~flexflow_tpu_torch.runtime.tensor_parallel.TensorParallelExecutor`
on each rank of the mesh; ``fit`` runs the training loop and prints the
reference's ELAPSED TIME / THROUGHPUT line. :meth:`FFModel.from_graph`
wraps a graph read back from JSON (the model repository's). The model
runs on the GPU unless ``device="cpu"`` is passed; ``mesh=`` (a
``parallel/mesh.py::Mesh``, e.g. ``data_parallel_mesh(2, ["cpu", "cpu"])``)
names the ranks' devices and transport instead, and the model's
:meth:`FFModel.close` releases them.

``fit`` draws the JAX package's step keys: the chain starts at
``key(seed + 1)`` and each window of steps (``trace_window``; the tail
steps one at a time) splits it once, ``rng, sub = split(rng)``; a
one-step window trains with ``sub``, a window of k steps with
``split(sub, k)``, as the JAX package's traced windows do. So a model
with dropout trains on the JAX package's masks at any ``trace_window``.
A full window runs through ``Executor.train_window`` (on the card, a
captured CUDA graph of the step replayed once a step), a tail step
through ``train_batch``; ``evaluate`` windows the same way.
"""
from __future__ import annotations

import contextlib
import time
import weakref
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .config import FFConfig
from .core.device import resolve_device
from .core.graph import Node, PCGraph
from .core.tensor import TensorSpec
from .core.types import (
    ActiMode,
    AggrMode,
    CompMode,
    DataType,
    LossType,
    MetricsType,
    OpType,
    PoolType,
)
from .ops import get_op_def
from .ops.attention import MultiHeadAttentionParams
from .ops.batch_matmul import BatchMatmulParams
from .ops.conv import Conv2DParams, Pool2DParams
from .ops.elementwise import ElementBinaryParams, ElementUnaryParams
from .ops.embedding import EmbeddingParams
from .ops.io_ops import InputParams, WeightParams
from .ops.linear import LinearParams
from .ops.moe_ops import (
    AggregateParams,
    AggregateSpecParams,
    CacheParams,
    ExpertsParams,
    GroupByParams,
    TopKParams,
)
from .ops.norm import BatchNormParams, LayerNormParams
from .ops.recurrent import RecurrentParams
from .ops.reduction_ops import GatherParams, MeanParams, ReduceSumParams
from .ops.shape_ops import (
    CastParams,
    ConcatParams,
    FlatParams,
    ReshapeParams,
    ReverseParams,
    SplitParams,
    TransposeParams,
)
from .ops.softmax import DropoutParams, SoftmaxParams
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
    ``config.seed``) seeds the weights and starts ``fit``'s key chain at
    ``key(seed + 1)``, as the JAX package's ``FFModel(seed=...)``.
    ``mesh`` (``parallel/mesh.py``: ``data_parallel_mesh``,
    ``build_mesh``) gives the devices of the ranks, one each, and their
    transport: the model's device is rank 0's. Without it a model on the
    default device spans the GPUs of this process (``FFConfig.
    num_devices``), and one given a ``device`` that device alone."""

    def __init__(self, config: Optional[FFConfig] = None, seed: Optional[int] = None,
                 device=None, mesh=None):
        self.config = config or FFConfig()
        if mesh is not None:
            if device is not None and torch.device(device) != mesh.devices[0]:
                raise ValueError(f"device {device} is not the mesh's rank 0 ({mesh.devices[0]})")
            device = mesh.devices[0]
        self.device = resolve_device(device)
        self._mesh_arg = mesh
        self._device_arg = device
        self.mesh = None
        self._mesh_finalizer = None
        self.graph = PCGraph()
        self._num_inputs = 0
        self._seed = self.config.seed if seed is None else seed
        self.executor: Optional[Executor] = None
        # the compiled ParallelStrategy, and the search's result when
        # compile ran the Unity search
        self.strategy = None
        self._search_result = None
        self._outputs: List[Tensor] = []

    @classmethod
    def from_graph(cls, graph: PCGraph, config: Optional[FFConfig] = None,
                   seed: Optional[int] = None, device=None, mesh=None) -> "FFModel":
        """A model over an existing graph (``PCGraph.from_json``: the model
        repository's ``graph.json``, or a graph the JAX package wrote),
        guids kept; ``compile(outputs=model.output_tensors(...))`` picks
        its outputs."""
        model = cls(config, seed=seed, device=device, mesh=mesh)
        model.graph = graph
        model._num_inputs = sum(1 for n in graph.nodes.values() if n.op_type == OpType.INPUT)
        return model

    def output_tensors(self, outputs: Sequence[Tuple[int, int]]) -> List["Tensor"]:
        """Tensor handles of ``(node guid, output index)`` pairs."""
        specs = infer_all_specs(self.graph)
        return [Tensor(self, self.graph.nodes[g], i, specs[g][i]) for g, i in outputs]

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

    def create_weight(self, shape: Sequence[int], dtype: DataType = DataType.FLOAT,
                      initializer: str = "glorot_uniform", name: str = "") -> Tensor:
        """A learnable tensor rooted in the graph (a WEIGHT node)."""
        params = WeightParams(tuple(int(s) for s in shape), dtype, initializer)
        return self._one(OpType.WEIGHT, params, [], name=name)

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

    def embedding(
        self,
        input: Tensor,
        num_entries: int,
        out_dim: int,
        aggr: AggrMode = AggrMode.NONE,
        datatype: DataType = DataType.FLOAT,
        kernel_initializer: str = "glorot_uniform",
        name: str = "",
    ) -> Tensor:
        p = EmbeddingParams(num_entries, out_dim, aggr, datatype, kernel_initializer)
        return self._one(OpType.EMBEDDING, p, [input], name=name)

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
        p = MultiHeadAttentionParams(embed_dim, num_heads, kdim, vdim, dropout, bias, causal, query.dtype)
        return self._one(OpType.MULTIHEAD_ATTENTION, p, [query, key, value], name=name)

    def rnn(
        self,
        input: Tensor,
        hidden_size: int,
        initial_state: Optional[Tensor] = None,
        activation: ActiMode = ActiMode.TANH,
        name: str = "",
    ) -> Tuple[Tensor, Tensor]:
        """Elman RNN over [B, T, D] -> (sequence [B, T, H], final_h [B, H]).
        Reference: nmt/ RNN mode."""
        p = RecurrentParams(hidden_size, input.dtype, self._acti(activation))
        ins = [input] + ([initial_state] if initial_state is not None else [])
        outs = self._add(OpType.RNN, p, ins, name=name)
        return outs[0], outs[1]

    def lstm(
        self,
        input: Tensor,
        hidden_size: int,
        initial_h: Optional[Tensor] = None,
        initial_c: Optional[Tensor] = None,
        name: str = "",
    ) -> Tuple[Tensor, Tensor, Tensor]:
        """LSTM over [B, T, D] -> (sequence, final_h, final_c).
        Reference: nmt/lstm.cc (cudnnRNN LSTM mode)."""
        p = RecurrentParams(hidden_size, input.dtype)
        if initial_c is not None and initial_h is None:
            raise ValueError("lstm: initial_c requires initial_h (pass zeros for h explicitly)")
        ins = [input]
        if initial_h is not None:
            ins.append(initial_h)
            if initial_c is not None:
                ins.append(initial_c)
        outs = self._add(OpType.LSTM, p, ins, name=name)
        return outs[0], outs[1], outs[2]

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

    def conv2d(
        self,
        input: Tensor,
        out_channels: int,
        kernel_h: int,
        kernel_w: int,
        stride_h: int,
        stride_w: int,
        padding_h: int,
        padding_w: int,
        activation: ActiMode = ActiMode.NONE,
        groups: int = 1,
        use_bias: bool = True,
        name: str = "",
    ) -> Tensor:
        p = Conv2DParams(
            out_channels, (kernel_h, kernel_w), (stride_h, stride_w), (padding_h, padding_w),
            groups, use_bias, self._acti(activation), input.dtype,
        )
        return self._one(OpType.CONV2D, p, [input], name=name)

    def pool2d(
        self,
        input: Tensor,
        kernel_h: int,
        kernel_w: int,
        stride_h: int,
        stride_w: int,
        padding_h: int,
        padding_w: int,
        pool_type: PoolType = PoolType.MAX,
        activation: ActiMode = ActiMode.NONE,
        name: str = "",
    ) -> Tensor:
        p = Pool2DParams((kernel_h, kernel_w), (stride_h, stride_w), (padding_h, padding_w),
                         pool_type, self._acti(activation))
        return self._one(OpType.POOL2D, p, [input], name=name)

    def batch_norm(self, input: Tensor, relu: bool = True, eps: float = 1e-5,
                   name: str = "") -> Tensor:
        p = BatchNormParams(relu=relu, eps=eps, dtype=input.dtype)
        return self._one(OpType.BATCHNORM, p, [input], name=name)

    def batch_matmul(
        self,
        A: Tensor,
        B: Tensor,
        a_seq_length_dim: int = -1,
        b_seq_length_dim: int = -1,
        name: str = "",
    ) -> Tensor:
        p = BatchMatmulParams(a_seq_length_dim, b_seq_length_dim)
        return self._one(OpType.BATCH_MATMUL, p, [A, B], name=name)

    # --------------------------------------------------------- elementwise
    def _binary(self, op: OpType, x: Tensor, y: Tensor, inplace_a: bool = False,
                name: str = "") -> Tensor:
        return self._one(op, ElementBinaryParams(op, inplace_a), [x, y], name=name)

    def add(self, x: Tensor, y: Tensor, inplace_a: bool = False, name: str = "") -> Tensor:
        return self._binary(OpType.EW_ADD, x, y, inplace_a, name)

    def subtract(self, x, y, inplace_a=False, name=""):
        return self._binary(OpType.EW_SUB, x, y, inplace_a, name)

    def multiply(self, x, y, inplace_a=False, name=""):
        return self._binary(OpType.EW_MUL, x, y, inplace_a, name)

    def divide(self, x, y, inplace_a=False, name=""):
        return self._binary(OpType.EW_DIV, x, y, inplace_a, name)

    def max(self, x, y, inplace_a=False, name=""):
        return self._binary(OpType.EW_MAX, x, y, inplace_a, name)

    def min(self, x, y, inplace_a=False, name=""):
        return self._binary(OpType.EW_MIN, x, y, inplace_a, name)

    def _unary(self, op: OpType, x: Tensor, scalar: float = 0.0, inplace: bool = False,
               name: str = "") -> Tensor:
        return self._one(op, ElementUnaryParams(op, scalar, inplace), [x], name=name)

    def relu(self, x, inplace=True, name=""):
        return self._unary(OpType.RELU, x, inplace=inplace, name=name)

    def sigmoid(self, x, name=""):
        return self._unary(OpType.SIGMOID, x, name=name)

    def tanh(self, x, name=""):
        return self._unary(OpType.TANH, x, name=name)

    def elu(self, x, inplace=True, name=""):
        return self._unary(OpType.ELU, x, inplace=inplace, name=name)

    def gelu(self, x, name=""):
        return self._unary(OpType.GELU, x, name=name)

    def identity(self, x, name=""):
        return self._unary(OpType.IDENTITY, x, name=name)

    def exp(self, x, name=""):
        return self._unary(OpType.EXP, x, name=name)

    def sin(self, x, name=""):
        return self._unary(OpType.SIN, x, name=name)

    def cos(self, x, name=""):
        return self._unary(OpType.COS, x, name=name)

    def rsqrt(self, x, name=""):
        return self._unary(OpType.RSQRT, x, name=name)

    def pow(self, x, exponent: float, name=""):
        return self._unary(OpType.POW, x, scalar=exponent, name=name)

    def scalar_add(self, x, scalar: float, inplace=True, name=""):
        return self._unary(OpType.SCALAR_ADD, x, scalar=scalar, inplace=inplace, name=name)

    def scalar_sub(self, x, scalar: float, inplace=True, name=""):
        return self._unary(OpType.SCALAR_SUB, x, scalar=scalar, inplace=inplace, name=name)

    def scalar_multiply(self, x, scalar: float, inplace=True, name=""):
        return self._unary(OpType.SCALAR_MUL, x, scalar=scalar, inplace=inplace, name=name)

    def scalar_true_divide(self, x, scalar: float, inplace=True, name=""):
        return self._unary(OpType.SCALAR_TRUE_DIV, x, scalar=scalar, inplace=inplace, name=name)

    # ----------------------------------------------------------- shape ops
    def reshape(self, input: Tensor, shape: Sequence[int], name: str = "") -> Tensor:
        return self._one(OpType.RESHAPE, ReshapeParams(tuple(shape)), [input], name=name)

    def transpose(self, input: Tensor, perm: Sequence[int], name: str = "") -> Tensor:
        return self._one(OpType.TRANSPOSE, TransposeParams(tuple(perm)), [input], name=name)

    def reverse(self, input: Tensor, axis: int, name: str = "") -> Tensor:
        return self._one(OpType.REVERSE, ReverseParams(axis), [input], name=name)

    def flat(self, input: Tensor, name: str = "") -> Tensor:
        return self._one(OpType.FLAT, FlatParams(), [input], name=name)

    def concat(self, tensors: Sequence[Tensor], axis: int, name: str = "") -> Tensor:
        return self._one(OpType.CONCAT, ConcatParams(axis, len(tensors)), list(tensors), name=name)

    def split(self, input: Tensor, sizes: Union[int, Sequence[int]], axis: int,
              name: str = "") -> List[Tensor]:
        if isinstance(sizes, int):
            total = input.shape[axis]
            if total % sizes != 0:
                raise ValueError(f"split: dim {axis} of size {total} not divisible into {sizes} chunks")
            sizes = [total // sizes] * sizes
        if sum(sizes) != input.shape[axis]:
            raise ValueError(f"split sizes {sizes} do not sum to dim size {input.shape[axis]}")
        return self._add(OpType.SPLIT, SplitParams(tuple(sizes), axis), [input], name=name)

    def cast(self, input: Tensor, dtype: DataType, name: str = "") -> Tensor:
        return self._one(OpType.CAST, CastParams(dtype), [input], name=name)

    def softmax(self, input: Tensor, axis: int = -1, name: str = "") -> Tensor:
        return self._one(OpType.SOFTMAX, SoftmaxParams(axis), [input], name=name)

    def dropout(self, input: Tensor, rate: float, seed: int = 0, name: str = "") -> Tensor:
        return self._one(OpType.DROPOUT, DropoutParams(rate, seed), [input], name=name)

    def gather(self, input: Tensor, index: Tensor, axis: int, name: str = "") -> Tensor:
        return self._one(OpType.GATHER, GatherParams(axis), [input, index], name=name)

    def reduce_sum(self, input: Tensor, axes: Sequence[int], keepdims: bool = False,
                   name: str = "") -> Tensor:
        return self._one(OpType.REDUCE_SUM, ReduceSumParams(tuple(axes), keepdims), [input],
                         name=name)

    def mean(self, input: Tensor, dims: Sequence[int], keepdims: bool = False,
             name: str = "") -> Tensor:
        return self._one(OpType.MEAN, MeanParams(tuple(dims), keepdims), [input], name=name)

    def residual(self, x: Tensor, fx: Tensor, name: str = "") -> Tensor:
        return self.add(x, fx, name=name)

    # ----------------------------------------------------------- MoE layers
    def top_k(self, input: Tensor, k: int, sorted: bool = True, name: str = "") -> Tuple[Tensor, Tensor]:
        outs = self._add(OpType.TOPK, TopKParams(k, sorted), [input], name=name)
        return outs[0], outs[1]

    def group_by(self, input: Tensor, assign: Tensor, n: int, alpha: float, stacked: bool = False,
                 name: str = "") -> Union[List[Tensor], Tensor]:
        outs = self._add(OpType.GROUP_BY, GroupByParams(n, alpha, stacked), [input, assign],
                         name=name)
        return outs[0] if stacked else outs

    def experts(self, grouped: Tensor, num_exp: int, hidden_size: int, out_dim: int,
                activation: ActiMode = ActiMode.RELU, name: str = "") -> Tensor:
        """Batched expert FFN over stacked [n, cap, D]."""
        p = ExpertsParams(num_exp, hidden_size, out_dim, activation, grouped.dtype)
        return self._one(OpType.EXPERTS, p, [grouped], name=name)

    def aggregate(self, gate_preds: Tensor, gate_assign: Tensor, exp_preds: Sequence[Tensor],
                  n: int, lambda_bal: float, name: str = "") -> Tensor:
        p = AggregateParams(n, lambda_bal)
        return self._one(OpType.AGGREGATE, p, [gate_preds, gate_assign] + list(exp_preds),
                         name=name)

    def aggregate_spec(self, gate_preds: Tensor, gate_assign: Tensor,
                       exp_preds: Sequence[Tensor], n: int, lambda_bal: float,
                       name: str = "") -> Tensor:
        p = AggregateSpecParams(n, lambda_bal)
        return self._one(OpType.AGGREGATE_SPEC, p, [gate_preds, gate_assign] + list(exp_preds),
                         name=name)

    def cache(self, input: Tensor, num_batches: int = 1, trigger_threshold: float = 0.0,
              name: str = "") -> Tensor:
        return self._one(OpType.CACHE, CacheParams(num_batches, trigger_threshold), [input],
                         name=name)

    def moe(self, input: Tensor, num_exp: int, num_select: int, expert_hidden_size: int,
            alpha: float = 2.0, lambda_bal: float = 0.04, batched: bool = True,
            name: str = "") -> Tensor:
        """Composite MoE layer (reference: FFModel::moe, src/ops/moe.cc:20):
        dense gate -> softmax -> top-k -> group_by -> experts -> aggregate.
        ``batched=True``: one stacked dispatch and one batched Experts op;
        ``batched=False``: the reference's n separate per-expert Dense
        pairs. Node names as the JAX package's (weights cross by name)."""
        gate = self.dense(input, num_exp, ActiMode.NONE, name=f"{name}_gate")
        gate = self.softmax(gate, name=f"{name}_gate_sm")
        topk_vals, topk_idx = self.top_k(gate, num_select, name=f"{name}_topk")
        if batched:
            grouped = self.group_by(input, topk_idx, num_exp, alpha, stacked=True,
                                    name=f"{name}_groupby")
            expert_out = self.experts(grouped, num_exp, expert_hidden_size, input.shape[-1],
                                      name=f"{name}_experts")
            return self.aggregate(topk_vals, topk_idx, [expert_out], num_exp, lambda_bal,
                                  name=f"{name}_agg")
        grouped = self.group_by(input, topk_idx, num_exp, alpha, name=f"{name}_groupby")
        expert_outs = []
        for e, g in enumerate(grouped):
            h = self.dense(g, expert_hidden_size, ActiMode.RELU, name=f"{name}_exp{e}")
            h = self.dense(h, input.shape[-1], ActiMode.NONE, name=f"{name}_exp{e}_out")
            expert_outs.append(h)
        return self.aggregate(topk_vals, topk_idx, expert_outs, num_exp, lambda_bal,
                              name=f"{name}_agg")

    # -------------------------------------------------------------- compile
    def compile(
        self,
        optimizer: Optional[Optimizer] = None,
        loss_type: Optional[LossType] = None,
        metrics: Sequence[MetricsType] = (),
        comp_mode: CompMode = CompMode.TRAINING,
        outputs: Optional[Sequence[Tensor]] = None,
        strategy=None,
    ) -> "FFModel":
        """Pick the parallelization strategy as the JAX package's compile
        does, then build the executor (one device, or one a rank) and its
        weights (reference: FFModel::compile, model.cc:2811).

        The strategy is, in this order: ``strategy``; the file
        ``config.import_strategy_file``; data parallelism when
        ``only_data_parallel`` or ``search_budget <= 0``; else the Unity
        search (``search/unity.py::unity_optimize``), whose rewritten
        graph the model adopts. It is remapped onto this graph by layer
        name (a strategy of another graph raises), exported when asked
        (``export_strategy_file``,
        ``export_strategy_computation_graph_file``), and then its mesh
        must fit the model's devices (``mesh=``'s, else the given
        ``device``, else the GPUs of this process): a strategy that needs
        more raises ``mesh needs N devices, have M`` (the JAX package's
        ``build_mesh``), after the files are written. Only then does a
        strategy with a ``"seq"``, ``"expert"`` or ``"pipe"`` axis above
        1 raise (ROADMAP queue 1 items 5b–5d). A ``"data"`` axis of N > 1
        starts the mesh's ranks (``runtime/data_parallel.py``), a
        ``"model"`` axis, alone or with ``"data"``, its tensor-parallel
        ranks (``runtime/tensor_parallel.py``: each rank holds its shards
        of the weights the strategy shards on ``"model"``); on one device
        every axis is 1 and the searched graph's parallel ops are
        identities."""
        from .parallel.strategy import ParallelStrategy, data_parallel_strategy

        if optimizer is None:
            optimizer = SGDOptimizer(lr=self.config.learning_rate, weight_decay=self.config.weight_decay)
        self.optimizer = optimizer
        self.loss_type = loss_type
        self.metrics = list(metrics)
        self.comp_mode = comp_mode
        self._outputs = list(outputs) if outputs else [self._default_output()]
        self._release()
        num_devices = self._num_devices()
        if strategy is not None:
            self.strategy = strategy
        elif self.config.import_strategy_file:
            with open(self.config.import_strategy_file) as f:
                self.strategy = ParallelStrategy.from_json(f.read())
        elif self.config.only_data_parallel or self.config.search_budget <= 0:
            self.strategy = data_parallel_strategy(self.graph, num_devices)
        else:
            from .search.unity import unity_optimize

            self.strategy, self._search_result = unity_optimize(self.graph, self.config)
            # adopt the rewritten PCG (reference: convert_graph_to_operators
            # model.cc:2856-2858); compute-node guids survive rewrites
            if self._search_result.graph is not None:
                self.graph = self._search_result.graph
        remapped = self.strategy.remap_to(self.graph)
        if remapped is None:
            raise ValueError(
                "strategy was built for a different graph: its node guids "
                "match nothing here and name-based remapping failed "
                "(missing or ambiguous layer names); rebuild or re-export "
                "the strategy against THIS model's graph")
        self.strategy = remapped
        if self.config.export_strategy_file:
            with open(self.config.export_strategy_file, "w") as f:
                f.write(self.strategy.to_json())
        if self.config.export_strategy_computation_graph_file:
            with open(self.config.export_strategy_computation_graph_file, "w") as f:
                f.write(self.graph.to_dot())
        mesh = self._mesh_for(self.strategy.axis_sizes)
        kw = dict(
            graph=self.graph,
            device=self.device,
            loss_type=loss_type,
            metric_types=tuple(metrics),
            optimizer=optimizer if comp_mode == CompMode.TRAINING else None,
            outputs=[(t.node.guid, t.idx) for t in self._outputs],
            remat_blocks=self.config.remat_blocks,
            grad_accum_steps=self.config.grad_accum_steps,
            strategy=self.strategy,
        )
        gen = torch.Generator().manual_seed(self._seed)
        if mesh.size == 1:
            self.mesh = mesh
            self.executor = Executor(**kw).initialize(gen)
            return self
        from .ops.moe_ops import refuse_data_parallel
        from .parallel.mesh import DATA_AXIS, MODEL_AXIS
        from .runtime.data_parallel import DataParallelExecutor, graph_batch, rank_plan
        from .runtime.tensor_parallel import TensorParallelExecutor, layout_plan

        # refusals before any rank starts
        refuse_data_parallel(self.graph, mesh.size)
        rank_plan(self.graph, graph_batch(self.graph), mesh.shape.get(DATA_AXIS, 1))
        tp = mesh.shape.get(MODEL_AXIS, 1)
        if tp > 1:
            layout_plan(self.graph, self.strategy, tp)
        if self._mesh_arg is not None and self._mesh_arg == mesh \
                and self._mesh_arg.timeout_s == mesh.timeout_s:
            mesh = self._mesh_arg  # the caller's mesh: its ranks serve every model on it
        else:
            # a mesh of this model's own, stopped with it
            self._mesh_finalizer = weakref.finalize(self, mesh.close)
        self.mesh = mesh
        if tp > 1:
            ex = TensorParallelExecutor(**kw, group=mesh.group(), zero=self.config.zero_optimizer,
                                        mesh_shape=mesh.shape, init_seed=self._seed)
        else:
            ex = DataParallelExecutor(**kw, group=mesh.group(), zero=self.config.zero_optimizer,
                                      init_seed=self._seed)
        self.executor = ex.initialize(gen)
        ex.start_ranks()
        return self

    def _num_devices(self) -> int:
        """The devices the default strategy spans: ``workers_per_node``,
        else the mesh's ranks, else the one ``device`` given, else the
        GPUs of this process (``FFConfig.num_devices``)."""
        if self._mesh_arg is not None:
            return self.config.workers_per_node or self._mesh_arg.size
        if self._device_arg is not None:
            return self.config.workers_per_node or 1
        return self.config.num_devices

    def _mesh_for(self, axis_sizes):
        """The strategy's mesh over the model's devices, checked: the
        device count first (the JAX package's error), then the axes the
        port trains (``"data"`` and ``"model"``)."""
        from .parallel.mesh import DATA_AXIS, MODEL_AXIS, build_mesh, gpus

        m = self._mesh_arg
        if m is not None:
            mesh = build_mesh(axis_sizes, m.devices, m.backend, m.timeout_s)
        elif self._device_arg is not None:
            mesh = build_mesh(axis_sizes, [self.device])
        else:
            mesh = build_mesh(axis_sizes, gpus() or [self.device])
        later = {
            "seq": "the 'seq' axis (ring and Ulysses attention, ROADMAP queue 1 item 5b)",
            "expert": "the 'expert' axis (expert parallelism, ROADMAP queue 1 item 5c)",
            "pipe": "the 'pipe' axis (GPipe with models/pipeline_transformer.py, ROADMAP "
                    "queue 1 item 5d)",
        }
        for axis, size in mesh.shape.items():
            if axis not in (DATA_AXIS, MODEL_AXIS) and size > 1:
                raise NotImplementedError(
                    f"{later.get(axis, repr(axis))} of size {size} is not ported for training; "
                    "the port trains the 'data' and 'model' axes")
        return mesh

    def _release(self) -> None:
        """Drop a data-parallel executor from the ranks and stop a mesh
        of this model's own."""
        from .runtime.data_parallel import DataParallelExecutor

        ex = self.executor
        if isinstance(ex, DataParallelExecutor):
            with contextlib.suppress(Exception):
                ex.close()
        if self._mesh_finalizer is not None:
            self._mesh_finalizer()
            self._mesh_finalizer = None

    def close(self) -> None:
        """Release the model's ranks (nothing on one device): its executor
        leaves the mesh's workers, and a mesh the model made for itself
        stops (a finalizer does that for a model never closed);
        idempotent."""
        self._release()
        self.executor = None

    # ------------------------------------------------------- introspection
    def parallel_tensor(self, tensor: Tensor):
        """How ``tensor`` is sharded under the compiled strategy
        (reference: ParallelTensorBase's per-dim degree / replica dims,
        parallel_tensor.h:36-71)."""
        from .core.parallel_tensor import view_from_spec

        assert self.strategy is not None, "compile() first"
        sh = self.strategy.node_shardings.get(tensor.node.guid)
        return view_from_spec(tensor.spec, self.strategy.output_spec(tensor.node.guid, tensor.idx),
                              self.strategy.axis_sizes,
                              machine_view_hash=sh.machine_view_hash if sh else 0)

    def parallel_weight(self, tensor: Tensor, name: str):
        """Sharding view of one of ``tensor``'s op's weights."""
        from .core.parallel_tensor import view_from_spec

        assert self.strategy is not None, "compile() first"
        node = tensor.node
        specs = infer_all_specs(self.graph)
        in_specs = [specs[e.src][e.src_idx] for e in self.graph.in_edges(node)]
        wspecs = {w.name: w for w in get_op_def(node.op_type).weight_specs(node.params, in_specs)}
        if name not in wspecs:
            raise KeyError(f"op {node} has no weight {name!r}; has {sorted(wspecs)}")
        sh = self.strategy.node_shardings.get(node.guid)
        return view_from_spec(wspecs[name].spec, self.strategy.weight_spec(node.guid, name),
                              self.strategy.axis_sizes,
                              machine_view_hash=sh.machine_view_hash if sh else 0)

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

    def _step_words(self, epochs: int, steps: int, tw: int) -> Optional[torch.Tensor]:
        """Every step's threefry key of a ``fit`` as words, [epochs *
        steps, 2] int64 on the host: the JAX package's chain (module
        docstring), derived on the host; ``fit`` moves it in one copy, so
        the steps themselves never sync the host."""
        from .generation import prng  # the generation package imports the model's ops

        rng, keys = prng.key(self._seed + 1), []
        for _ in range(epochs):
            step = 0
            while step < steps:
                k = tw if steps - step >= tw else 1
                rng, sub = prng.split(rng)
                keys.extend([sub] if k == 1 else prng.split(sub, k))
                step += k
        return torch.stack([torch.stack(kk) for kk in keys]) if keys else None

    @staticmethod
    def _windows(steps: int, tw: int):
        """(first step, steps) of each window: full ``tw``-step windows,
        then the tail one step at a time (the JAX package's
        ``_iter_windows``)."""
        step = 0
        while step < steps:
            k = tw if steps - step >= tw else 1
            yield step, k
            step += k

    @staticmethod
    def _stacked(xs, y, lo: int, k: int, bs: int):
        """Rows ``lo : lo + k * bs`` as ``[k, bs, ...]`` views."""
        hi = lo + k * bs
        return ([xx[lo:hi].reshape((k, bs) + tuple(xx.shape[1:])) for xx in xs],
                y[lo:hi].reshape((k, bs) + tuple(y.shape[1:])))

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

        ``trace_window`` > 1 (default ``FFConfig.trace_window``) is the
        analog of the reference's Legion iteration tracing
        (begin_trace/end_trace, flexflow_cffi.py:2079-2086), as in the
        JAX package: each full window of that many steps runs through
        ``executor.train_window`` on stacked ``[k, bs, ...]`` views (on
        the card one captured CUDA graph of the step, replayed once a
        step), the tail steps that fill no whole window one at a time
        through ``train_batch``. Metrics come back to the host once per
        window. The step keys follow the JAX package's windows (module
        docstring). Data-parallel, each rank gets its rows of the
        dataset once (``DataParallelExecutor.load_rows``) and each window
        runs its steps eagerly on every rank (``fit_window``)."""
        if self.executor is None:
            raise RuntimeError("call compile() first")
        xs, y = self._as_batches(x, y)
        epochs = epochs or self.config.epochs
        bs = batch_size or self.config.batch_size
        tw = max(1, trace_window or self.config.trace_window)
        steps = xs[0].shape[0] // bs
        words = self._step_words(epochs, steps, tw)
        ex = self.executor
        from .runtime.data_parallel import DataParallelExecutor

        dp = isinstance(ex, DataParallelExecutor)
        if dp:
            ex.load_rows(xs, y, bs, steps)
        elif words is not None:
            words = words.to(self.device)
        perf = PerfMetrics()
        if self.config.profiling:  # reference: --profiling per-op timings
            self.profile(x=[xx[:bs] for xx in xs])
        interval = max(1, self.config.printing_interval)
        self.step_losses: List[float] = []
        # physical wall time: the reference's ELAPSED TIME / THROUGHPUT line
        t0 = time.perf_counter()  # flexlint: disable=clock-discipline
        for epoch in range(epochs):
            for w0, n in self._windows(steps, tw):
                s0 = epoch * steps + w0
                if dp:
                    mets = ex.fit_window(w0, n, words[s0:s0 + n], bs)
                elif n > 1:
                    wx, wy = self._stacked(xs, y, w0 * bs, n, bs)
                    mets = ex._train_window(wx, wy, words[s0:s0 + n])
                else:
                    lo = w0 * bs
                    mets = ex.train_batch([xx[lo:lo + bs] for xx in xs], y[lo:lo + bs],
                                          rng=(words[s0, 0], words[s0, 1]))
                # one host sync per window
                host = {k: v.reshape(n).tolist() for k, v in mets.items()}
                for i in range(n):
                    perf.update({k: v[i] for k, v in host.items() if k != "loss"})
                    self.step_losses.append(host["loss"][i])
                    if verbose and (w0 + i) % interval == 0:
                        print(f"epoch {epoch} step {w0 + i}/{steps} "
                              f"loss {host['loss'][i]:.4f} acc {perf.accuracy:.4f}")
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        elapsed = time.perf_counter() - t0  # flexlint: disable=clock-discipline
        thru = epochs * steps * bs / max(1e-9, elapsed)
        if verbose:
            print(f"ELAPSED TIME = {elapsed:.4f}s THROUGHPUT = {thru:.2f} samples/s")
        self.last_elapsed = elapsed
        self.last_throughput = thru
        return perf

    def evaluate(self, x, y, batch_size: Optional[int] = None,
                 trace_window: Optional[int] = None) -> PerfMetrics:
        """Inference-mode metrics over the batches; full windows of
        ``trace_window`` steps (default ``FFConfig.trace_window``) run
        through ``executor.eval_window``, the tail through ``eval_batch``,
        as the JAX package's ``evaluate``."""
        if self.executor is None:
            raise RuntimeError("call compile() first")
        xs, y = self._as_batches(x, y)
        bs = batch_size or self.config.batch_size
        tw = max(1, trace_window or self.config.trace_window)
        perf = PerfMetrics()
        for w0, n in self._windows(xs[0].shape[0] // bs, tw):
            if n > 1:
                mets = self.executor.eval_window(*self._stacked(xs, y, w0 * bs, n, bs))
            else:
                lo = w0 * bs
                mets = self.executor.eval_batch([xx[lo:lo + bs] for xx in xs], y[lo:lo + bs])
            host = {k: v.reshape(n).tolist() for k, v in mets.items() if k != "loss"}
            for i in range(n):
                perf.update({k: v[i] for k, v in host.items()})
        return perf

    def predict(self, x) -> torch.Tensor:
        if self.executor is None:
            raise RuntimeError("call compile() first")
        xs = [x] if isinstance(x, (np.ndarray, torch.Tensor)) else list(x)
        return self.executor.predict(xs)[0]

    def profile(self, x=None, verbose: bool = True):
        """Per-op forward timing table (reference: --profiling cudaEvent
        brackets in every kernel, e.g. linear_kernels.cu:95-118); without
        ``x``, inputs drawn as the JAX package draws them
        (``RandomState(0)``: 0/1 integers, else standard normals)."""
        from .runtime.profiling import format_profiles, profile_step

        if self.executor is None:
            raise RuntimeError("call compile() first")
        if x is None:
            specs = infer_all_specs(self.graph)
            ins = sorted((n for n in self.graph.nodes.values() if n.op_type == OpType.INPUT),
                         key=lambda n: n.params.input_index)
            rs = np.random.RandomState(0)
            x = []
            for n in ins:
                s = specs[n.guid][0]
                if s.dtype in (DataType.INT32, DataType.INT64):
                    x.append(rs.randint(0, 2, s.shape).astype(np.int32))
                else:
                    x.append(rs.randn(*s.shape).astype(np.float32))
        profiles = profile_step(self.executor, x)
        if verbose:
            print(format_profiles(profiles))
        return profiles

    def recompile_on_condition(self, trigger, alter):
        """Reference: FFModel::recompile_on_condition (model.cc:2430)."""
        from .runtime.recompile import RecompileState

        if self.executor is None:
            raise RuntimeError("call compile() first")
        return RecompileState(trigger, alter, self)

    def get_output(self) -> Tensor:
        return self._outputs[0] if self._outputs else self._default_output()

    def num_layers(self) -> int:
        return sum(1 for n in self.graph.nodes.values() if n.op_type != OpType.INPUT)

    # --------------------------------------------- checkpoint / dataloader
    def save_checkpoint(self, path: str, step: int = 0) -> None:
        """Save weights, state and optimizer state (``runtime/checkpoint.py``)."""
        from .runtime.checkpoint import save_checkpoint

        if self.executor is None:
            raise RuntimeError("call compile() first")
        save_checkpoint(path, self.executor, step=step)

    def load_checkpoint(self, path: str) -> int:
        """Restore a checkpoint into the compiled model; returns its step."""
        from .runtime.checkpoint import restore_checkpoint

        if self.executor is None:
            raise RuntimeError("call compile() first")
        return restore_checkpoint(path, self.executor)

    def create_data_loader(self, x, y, batch_size: Optional[int] = None, shuffle: bool = True,
                           seed: int = 0):
        """Reference: FFModel.create_data_loader (flexflow_cffi.py:2178);
        batches land on the model's device."""
        from .runtime.dataloader import DataLoader

        xs = [x] if isinstance(x, (np.ndarray, torch.Tensor)) else list(x)
        return DataLoader(xs, y, batch_size or self.config.batch_size, shuffle=shuffle,
                          seed=seed, device=self.device)

    # ------------------------------------------------------------- weights
    def _leaf(self, layer: Union[Tensor, str], name: str) -> Tuple[str, str]:
        """(node key, part) of one weight or state entry of a layer."""
        if self.executor is None:
            raise RuntimeError("call compile() first")
        key = node_key(layer.node) if isinstance(layer, Tensor) else self.executor.node_key(layer)
        specs = self.executor.whole_specs()
        for part in ("params", "state"):
            if name in specs[part].get(key, {}):
                return key, part
        have = sorted({**specs["params"].get(key, {}), **specs["state"].get(key, {})})
        raise KeyError(f"no weight {name!r} on {key}; has {have}")

    def get_weight(self, layer: Union[Tensor, str], name: str) -> np.ndarray:
        """One weight (or state entry, as BatchNorm's running mean) as a
        host array, whole (a tensor-parallel model gathers its shards);
        ``layer`` is the layer's output Tensor or its name (reference:
        ParallelTensorBase::get_tensor). numpy has no bfloat16: a bfloat16
        weight comes back as float32, which holds every bfloat16 value
        exactly."""
        key, _ = self._leaf(layer, name)
        w = self.executor.whole_weight(key, name).detach()
        if w.dtype == torch.bfloat16:
            w = w.float()
        return w.cpu().numpy().copy()  # never a view of the weight

    @torch.no_grad()
    def set_weight(self, layer: Union[Tensor, str], name: str, value) -> None:
        """Overwrite one weight from whole host data (reference:
        ParallelTensorBase::set_tensor); the weight keeps its dtype, and
        every rank takes its part."""
        key, part = self._leaf(layer, name)
        shape, dtype = self.executor.whole_specs()[part][key][name]
        self.executor.load_whole(**{part: {key: {name: _whole(value, shape, dtype,
                                                                f"{key}.{name}")}}})

    @torch.no_grad()
    def set_weights(self, named: Dict[str, Dict[str, torch.Tensor]],
                    state: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
                    opt_state: Optional[Dict] = None) -> None:
        """Every weight from ``{layer_name: {weight_name: tensor}}``
        (``runtime/convert.py::params_from_numpy``); the named layers'
        weight sets must match the model's exactly. ``state`` carries the
        non-trainable state the same way (BatchNorm's running statistics)
        and ``opt_state`` the optimizer's (``runtime/convert.py::
        opt_state_from_numpy``: the moments by layer name, the step and
        the learning rate). Every value is whole; each rank takes its
        part."""
        if self.executor is None:
            raise RuntimeError("call compile() first")
        ex = self.executor
        specs = ex.whole_specs()
        params = self._checked(named, specs["params"], "weights")
        st = None if state is None else self._checked(state, specs["state"], "state")
        opt = None
        if opt_state is not None:
            if ex.opt_state is None:
                raise ValueError("the model holds no optimizer state (compiled for inference)")
            opt = {"step": int(opt_state["step"]), "lr": float(opt_state["lr"])}
            for field in ("m", "v"):
                have, given = ex.opt_state.get(field), opt_state.get(field)
                if (have is None) != (given is None):
                    raise ValueError(f"optimizer state {field!r}: the model "
                                     f"{'has' if have is not None else 'lacks'} it")
                if have is not None:
                    mspecs = {k: {n: (shape, have[k][n].dtype)
                                  for n, (shape, _) in g.items()}
                              for k, g in specs["params"].items()}
                    opt[field] = self._checked(given, mspecs, f"opt_state[{field!r}]")
        ex.load_whole(params, st, opt)

    def _checked(self, named, specs, what: str) -> Dict[str, Dict[str, torch.Tensor]]:
        """``named`` ({layer name: {weight: value}}) re-keyed by node key,
        checked to cover ``specs`` ({node key: {name: (shape, dtype)}})
        exactly, each value a whole tensor of its leaf's shape and dtype."""
        by_key = {self.executor.node_key(layer): ws for layer, ws in named.items()}
        if set(by_key) != set(specs):
            raise ValueError(f"the named layers do not cover the model's {what} exactly")
        out = {}
        for key, ws in by_key.items():
            if set(ws) != set(specs[key]):
                raise ValueError(f"{what} of {key}: {sorted(ws)}, expected {sorted(specs[key])}")
            out[key] = {n: _whole(v, *specs[key][n], f"{key}.{n}") for n, v in ws.items()}
        return out


def _whole(value, shape, dtype: torch.dtype, what: str) -> torch.Tensor:
    """``value`` as a tensor of ``dtype``, checked to have ``shape``."""
    src = to_tensor(value).to(dtype)
    if tuple(src.shape) != tuple(shape):
        raise ValueError(f"shape {tuple(src.shape)} != {tuple(shape)} for {what}")
    return src
