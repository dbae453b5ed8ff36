"""Single-GPU executor (port of the interpreter core of
``flexflow_tpu/runtime/executor.py``).

The JAX executor traces the graph into jitted, mesh-sharded programs.
Here PyTorch runs eagerly: :meth:`Executor._forward_impl` interprets the
graph in topological order, op by op, and autograd records the backward
(the flash attention backward included). A train step is forward, loss,
``backward()`` and the optimizer's in-place update.

Weights are keyed ``"{op_type}_{guid}"`` as in the JAX executor, and
reachable by layer name through :meth:`Executor.node_key`. There is no
GSPMD sharding, pipeline, rematerialization, ZeRO, gradient
accumulation or traced multi-step window: those wait for the multi-GPU
slices.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..core.graph import Node, PCGraph
from ..core.types import LossType, MetricsType, OpType
from ..ops.base import LowerCtx, get_op_def
from ..parallel.propagation import infer_all_specs
from . import initializers, losses, metrics as metrics_mod
from .optimizers import Optimizer, Params


def node_key(node: Node) -> str:
    return f"{node.op_type.value}_{node.guid}"


@dataclasses.dataclass
class Executor:
    """A training/inference program for one graph on one device."""

    graph: PCGraph
    device: torch.device
    loss_type: Optional[LossType]
    metric_types: Tuple[MetricsType, ...]
    optimizer: Optional[Optimizer]
    outputs: List[Tuple[int, int]]  # (node guid, output idx), order = user's outputs
    # "auto": the CUDA kernels on a GPU; "plain": the plain PyTorch
    # versions on any device (the check the kernels are held against)
    backend: str = "auto"

    params: Optional[Params] = None
    opt_state: Optional[dict] = None
    _by_name: Optional[Dict[str, str]] = None

    def initialize(self, generator: torch.Generator) -> "Executor":
        """Materialise every weight on the device: drawn on the CPU from
        ``generator`` in topological order, then moved."""
        specs = infer_all_specs(self.graph)
        params: Params = {}
        self._by_name = {}
        for node in self.graph.topo_order():
            in_specs = [specs[e.src][e.src_idx] for e in self.graph.in_edges(node)]
            wspecs = get_op_def(node.op_type).weight_specs(node.params, in_specs)
            if node.name:
                self._by_name[node.name] = node_key(node)
            for w in wspecs:
                if not w.trainable:
                    raise NotImplementedError(f"non-trainable weight {w.name} of {node}")
                arr = initializers.get_initializer(w.initializer)(generator, w.spec)
                params.setdefault(node_key(node), {})[w.name] = (
                    arr.to(self.device).requires_grad_(True)
                )
        self.params = params
        if self.optimizer is not None:
            self.opt_state = self.optimizer.init_state(params)
        return self

    def node_key(self, name: str) -> str:
        """The weight key of the layer called ``name``."""
        if name not in self._by_name:
            raise KeyError(f"no layer named {name!r}")
        return self._by_name[name]

    # ----------------------------------------------------------- forward
    def _forward_impl(self, params: Params, inputs: Sequence[torch.Tensor], training: bool):
        """Interpret the graph in topological order (the reference's
        FFModel::forward op loop, model.cc:2423)."""
        values: Dict[Tuple[int, int], torch.Tensor] = {}
        ctx = LowerCtx(training=training, backend=self.backend)
        for node in self.graph.topo_order():
            if node.op_type == OpType.INPUT:
                values[(node.guid, 0)] = inputs[node.params.input_index]
                continue
            node_inputs = [values[(e.src, e.src_idx)] for e in self.graph.in_edges(node)]
            outs = get_op_def(node.op_type).lower(
                node.params, node_inputs, params.get(node_key(node), {}), ctx
            )
            for i, o in enumerate(outs):
                values[(node.guid, i)] = o
        return [values[(g, i)] for g, i in self.outputs]

    def _as_inputs(self, inputs: Sequence) -> List[torch.Tensor]:
        return [torch.as_tensor(x, device=self.device) for x in inputs]

    # ---------------------------------------------------------------- API
    def train_batch(self, inputs: Sequence, label) -> Dict[str, torch.Tensor]:
        """Forward, loss, backward, optimizer update (in place). Returns
        the batch's metrics and loss as device tensors (no host sync)."""
        if self.optimizer is None or self.loss_type is None:
            raise RuntimeError("compile() with an optimizer and a loss to train")
        inputs = self._as_inputs(inputs)
        label = torch.as_tensor(label, device=self.device)
        leaves = [p for g in self.params.values() for p in g.values()]
        for p in leaves:
            p.grad = None
        with torch.enable_grad():
            final = self._forward_impl(self.params, inputs, training=True)[-1]
            loss = losses.get_loss_fn(self.loss_type)(final, label)
            loss.backward()
        # a weight the loss does not reach has a zero gradient, as in JAX
        grads = {
            k: {n: p.grad if p.grad is not None else torch.zeros_like(p) for n, p in g.items()}
            for k, g in self.params.items()
        }
        self.optimizer.apply(self.params, grads, self.opt_state)
        for p in leaves:
            p.grad = None
        mets = metrics_mod.compute_metrics(self.metric_types, final.detach(), label)
        mets["loss"] = loss.detach()
        return mets

    @torch.no_grad()
    def eval_batch(self, inputs: Sequence, label) -> Dict[str, torch.Tensor]:
        inputs = self._as_inputs(inputs)
        label = torch.as_tensor(label, device=self.device)
        final = self._forward_impl(self.params, inputs, training=False)[-1]
        mets = metrics_mod.compute_metrics(self.metric_types, final, label)
        if self.loss_type is not None:
            mets["loss"] = losses.get_loss_fn(self.loss_type)(final, label)
        return mets

    @torch.no_grad()
    def predict(self, inputs: Sequence) -> List[torch.Tensor]:
        return self._forward_impl(self.params, self._as_inputs(inputs), training=False)
