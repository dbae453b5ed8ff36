"""Single-GPU executor (port of the interpreter core of
``flexflow_tpu/runtime/executor.py``).

The JAX executor traces the graph into jitted, mesh-sharded programs.
Here PyTorch runs eagerly: :meth:`Executor._forward_impl` interprets the
graph in topological order, op by op, and autograd records the backward
(the flash attention backward included). A train step is forward, loss,
``backward()`` and the optimizer's in-place update.

Each node lowers with its guid in ``LowerCtx.node_guid`` and the step's
threefry key in ``LowerCtx.rng`` (``train_batch(..., rng=key)``), so a
dropout node draws the JAX package's mask. Compiled for inference
(``optimizer=None``) the executor holds no optimizer state; ``predict``
runs under ``torch.no_grad()`` through the ``executor.predict`` fault
site.

Weights are keyed ``"{op_type}_{guid}"`` as in the JAX executor, and
reachable by layer name through :meth:`Executor.node_key`. Trainable
weights live in ``params``; non-trainable ones (BatchNorm's running
statistics) in ``state``, which the optimizer never sees: an op writes
its new state into ``LowerCtx.state_updates`` as values, and the step
applies them once, after its forward (``_apply_state_updates``), as the
JAX executor's functional state.

``remat_blocks`` wraps each block of the graph's repeated stack
(``parallel/pipeline.py::detect_repeats``, at least two blocks) in
``torch.utils.checkpoint`` (non-reentrant): the backward recomputes the
block's activations instead of keeping them. The recomputation draws
the same dropout masks, since each derives from (step key, node guid),
and does not apply the block's state a second time, since the state
updates leave the block as outputs of its first run.

``grad_accum_steps`` splits each batch into that many strided
microbatches (rows ``i, i + accum, ...``, as the JAX executor's), each
with the key ``split(rng, accum)[i]`` and the state the previous one
left; their gradients are summed into ``.grad`` in order, divided by
``accum`` and applied in one optimizer update.

Float32 stays float32: cuDNN runs float32 convolutions in TF32 unless
told otherwise (``torch.backends.cudnn.allow_tf32`` is True by default),
so each step, forward and backward, runs with TF32 off for cuDNN and
cuBLAS (:func:`_full_fp32`), and the flags are put back after it.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..core.graph import Node, PCGraph
from ..core.types import LossType, MetricsType, OpType
from ..ops.base import LowerCtx, get_op_def
from ..parallel.propagation import infer_all_specs
from . import faults, initializers, losses, metrics as metrics_mod
from .convert import to_tensor
from .optimizers import Optimizer, Params


def node_key(node: Node) -> str:
    return f"{node.op_type.value}_{node.guid}"


@contextlib.contextmanager
def _full_fp32():
    """TF32 off for cuDNN's convolutions and cuBLAS's products while the
    block runs (the backward included, when it runs inside)."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    prev = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = prev


@dataclasses.dataclass
class _RematBlock:
    nodes: List[Node]
    ext_in: List[Tuple[int, int]]  # values read from outside the block
    ext_out: List[Tuple[int, int]]  # values read after it (or asked for)


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
    remat_blocks: bool = False
    grad_accum_steps: int = 1

    params: Optional[Params] = None
    state: Optional[Params] = None  # non-trainable (BatchNorm's running stats)
    opt_state: Optional[dict] = None
    _by_name: Optional[Dict[str, str]] = None
    # (pre nodes, repeated blocks, post nodes) when remat_blocks engaged
    _remat_plan: Optional[tuple] = None

    def initialize(self, generator: torch.Generator) -> "Executor":
        """Materialise every weight on the device: drawn on the CPU from
        ``generator`` in topological order, then moved."""
        if int(self.grad_accum_steps) < 1:
            raise ValueError(f"grad_accum_steps must be >= 1, got {self.grad_accum_steps}")
        self._remat_plan = self._build_remat_plan() if self.remat_blocks else None
        specs = infer_all_specs(self.graph)
        params: Params = {}
        state: Params = {}
        self._by_name = {}
        for node in self.graph.topo_order():
            in_specs = [specs[e.src][e.src_idx] for e in self.graph.in_edges(node)]
            wspecs = get_op_def(node.op_type).weight_specs(node.params, in_specs)
            if node.name:
                self._by_name[node.name] = node_key(node)
            for w in wspecs:
                arr = initializers.get_initializer(w.initializer)(generator, w.spec).to(self.device)
                if w.trainable:
                    params.setdefault(node_key(node), {})[w.name] = arr.requires_grad_(True)
                else:
                    state.setdefault(node_key(node), {})[w.name] = arr
        self.params = params
        self.state = state
        if self.optimizer is not None:
            self.opt_state = self.optimizer.init_state(params)
        return self

    def _build_remat_plan(self):
        """The repeated blocks with their boundary values; None below two
        blocks (nothing to win), as in the JAX executor."""
        from ..parallel.pipeline import detect_repeats

        pre, repeats, post = detect_repeats(self.graph)
        if len(repeats) < 2:
            return None
        wanted = set(self.outputs)
        blocks = []
        for rep in repeats:
            guids = {n.guid for n in rep}
            ext_in = sorted({(e.src, e.src_idx) for n in rep for e in self.graph.in_edges(n)
                             if e.src not in guids})
            ext_out = sorted({(e.src, e.src_idx) for n in rep for e in self.graph.out_edges(n)
                              if e.dst not in guids}
                             | {(g, i) for (g, i) in wanted if g in guids})
            blocks.append(_RematBlock(rep, ext_in, ext_out))
        return pre, blocks, post

    def node_key(self, name: str) -> str:
        """The weight key of the layer called ``name``."""
        if name not in self._by_name:
            raise KeyError(f"no layer named {name!r}")
        return self._by_name[name]

    # ----------------------------------------------------------- forward
    def _interpret_nodes(self, nodes, values, params, state, rng, training) -> LowerCtx:
        """Lower ``nodes`` in order into ``values`` (seeded with their
        inputs); returns the context with the state updates and aux
        losses they wrote."""
        ctx = LowerCtx(training=training, rng=rng, backend=self.backend)
        for node in nodes:
            key = node_key(node)
            node_inputs = [values[(e.src, e.src_idx)] for e in self.graph.in_edges(node)]
            weights = {**params.get(key, {}), **state.get(key, {})}
            ctx.node_guid = node.guid
            outs = get_op_def(node.op_type).lower(node.params, node_inputs, weights, ctx)
            for i, o in enumerate(outs):
                values[(node.guid, i)] = o
        return ctx

    def _seed_inputs(self, nodes, inputs) -> Dict[Tuple[int, int], torch.Tensor]:
        return {(n.guid, 0): inputs[n.params.input_index]
                for n in nodes if n.op_type == OpType.INPUT}

    def _forward_impl(self, params: Params, state: Params, inputs: Sequence[torch.Tensor],
                      training: bool, rng=None):
        """Interpret the graph in topological order (the reference's
        FFModel::forward op loop, model.cc:2423). Returns (outputs, new
        state, aux losses) as the JAX executor's."""
        if self._remat_plan is not None and training:
            return self._forward_remat(params, state, inputs, rng)
        order = self.graph.topo_order()
        values = self._seed_inputs(order, inputs)
        ctx = self._interpret_nodes([n for n in order if n.op_type != OpType.INPUT], values,
                                    params, state, rng, training)
        new_state = _apply_state_updates(state, ctx.state_updates, self.graph)
        return [values[(g, i)] for g, i in self.outputs], new_state, ctx.aux_losses

    def _forward_remat(self, params, state, inputs, rng):
        """The plain interpretation with each repeated block under
        ``torch.utils.checkpoint``: the backward recomputes its
        activations (the JAX executor's ``jax.checkpoint`` per block)."""
        from torch.utils.checkpoint import checkpoint

        pre, blocks, post = self._remat_plan
        values = self._seed_inputs(pre, inputs)
        pre_ctx = self._interpret_nodes([n for n in pre if n.op_type != OpType.INPUT], values,
                                        params, state, rng, True)
        aux = list(pre_ctx.aux_losses)
        updates = dict(pre_ctx.state_updates)
        for blk in blocks:
            def block_fn(*ext_vals, _blk=blk):
                local = dict(zip(_blk.ext_in, ext_vals))
                ctx = self._interpret_nodes(_blk.nodes, local, params, state, rng, True)
                return tuple(local[k] for k in _blk.ext_out), tuple(ctx.aux_losses), \
                    dict(ctx.state_updates)

            # the masks derive from (step key, guid): no torch RNG state to keep
            outs, aux_j, upd_j = checkpoint(block_fn, *[values[k] for k in blk.ext_in],
                                            use_reentrant=False, preserve_rng_state=False)
            values.update(zip(blk.ext_out, outs))
            aux.extend(aux_j)
            updates.update(upd_j)
        post_ctx = self._interpret_nodes(post, values, params, state, rng, True)
        aux.extend(post_ctx.aux_losses)
        updates.update(post_ctx.state_updates)
        new_state = _apply_state_updates(state, updates, self.graph)
        return [values[(g, i)] for g, i in self.outputs], new_state, aux

    def _as_inputs(self, inputs: Sequence) -> List[torch.Tensor]:
        """Inputs on the device in their own dtypes (no cast: a bfloat16
        model fed float32 inputs promotes where the JAX package's does)."""
        return [to_tensor(x, self.device) for x in inputs]

    # ---------------------------------------------------------------- API
    def _step_key(self, rng):
        """A threefry key (``generation/prng.py``) on the device; ``key(0)``
        (the JAX executor's default outside training) when ``rng`` is
        None."""
        from ..generation import prng  # the generation package imports the runtime

        k1, k2 = prng.key(0) if rng is None else rng
        return k1.to(self.device), k2.to(self.device)

    def _backward(self, inputs, label, rng, state):
        """Forward, loss and ``backward()`` of one (micro)batch: the
        gradients add into ``.grad``. Returns (metrics, new state)."""
        with torch.enable_grad(), _full_fp32():
            outs, new_state, aux = self._forward_impl(self.params, state, inputs,
                                                      training=True, rng=rng)
            final = outs[-1]
            loss = losses.get_loss_fn(self.loss_type)(final, label)
            for a in aux:
                loss = loss + a
            loss.backward()
        mets = metrics_mod.compute_metrics(self.metric_types, final.detach(), label)
        mets["loss"] = loss.detach()
        return mets, new_state

    def train_batch(self, inputs: Sequence, label, rng=None) -> Dict[str, torch.Tensor]:
        """Forward, loss, backward, optimizer update (in place). ``rng``
        is the step's threefry key (dropout masks). Returns the batch's
        metrics and loss as device tensors (no host sync)."""
        if self.optimizer is None or self.loss_type is None:
            raise RuntimeError("compile() with an optimizer and a loss to train")
        inputs = self._as_inputs(faults.inject(faults.EXECUTOR_TRAIN_BATCH, inputs))
        label = to_tensor(label, self.device)
        key = self._step_key(rng)
        leaves = [p for g in self.params.values() for p in g.values()]
        for p in leaves:
            p.grad = None
        accum = int(self.grad_accum_steps)
        if accum == 1:
            mets, new_state = self._backward(inputs, label, key, self.state)
        else:
            b = inputs[0].shape[0]
            if b % accum:
                raise ValueError(f"batch {b} not divisible by grad_accum_steps={accum}")
            from ..generation import prng  # the generation package imports the runtime

            # microbatch i = rows {i, i + accum, ...}, its key split(rng)[i],
            # the state chained through the microbatches in order
            new_state, mets_all = self.state, []
            for i, k in enumerate(prng.split(key, accum)):
                m, new_state = self._backward([x[i::accum] for x in inputs], label[i::accum],
                                              k, new_state)
                mets_all.append(m)
            with torch.no_grad():
                for p in leaves:
                    if p.grad is not None:
                        p.grad.div_(accum)
            mets = _merge_microbatch_metrics(mets_all, b)
        # a weight the loss does not reach has a zero gradient, as in JAX
        grads = {
            k: {n: p.grad if p.grad is not None else torch.zeros_like(p) for n, p in g.items()}
            for k, g in self.params.items()
        }
        self.optimizer.apply(self.params, grads, self.opt_state)
        self.state = new_state
        for p in leaves:
            p.grad = None
        return mets

    @torch.no_grad()
    def eval_batch(self, inputs: Sequence, label) -> Dict[str, torch.Tensor]:
        inputs = self._as_inputs(inputs)
        label = to_tensor(label, self.device)
        with _full_fp32():
            final = self._forward_impl(self.params, self.state, inputs, training=False)[0][-1]
        mets = metrics_mod.compute_metrics(self.metric_types, final, label)
        if self.loss_type is not None:
            mets["loss"] = losses.get_loss_fn(self.loss_type)(final, label)
        return mets

    @torch.no_grad()
    def predict(self, inputs: Sequence) -> List[torch.Tensor]:
        with _full_fp32():
            outs = self._forward_impl(self.params, self.state, self._as_inputs(inputs),
                                      training=False)[0]
        # chaos hook: error / stall / NaN-poisoned outputs
        return faults.inject(faults.EXECUTOR_PREDICT, outs)


def _merge_microbatch_metrics(mets_all: List[Dict[str, torch.Tensor]], batch: int):
    """The JAX executor's merge of the microbatches' metrics: the loss is
    their mean; ``rmse_loss`` (a square root of a mean, times the rows)
    goes back to each microbatch's mean square, is averaged and
    re-applied; every other key is a per-batch sum."""
    mb = batch // len(mets_all)
    out = {}
    for k in mets_all[0]:
        v = torch.stack([m[k] for m in mets_all])
        if k == "loss":
            out[k] = v.mean()
        elif k == "rmse_loss":
            out[k] = (v / mb).square().mean().sqrt() * batch
        else:
            out[k] = v.sum()
    return out


def _apply_state_updates(state: Params, updates: Dict, graph: PCGraph) -> Params:
    """A new state with ``updates`` ({(guid, name): value}) applied; the
    values leave the autograd graph."""
    if not updates:
        return state
    new_state = {k: dict(v) for k, v in state.items()}
    for (guid, name), val in updates.items():
        new_state[node_key(graph.nodes[guid])][name] = val.detach()
    return new_state
