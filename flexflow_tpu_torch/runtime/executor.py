"""The executor of one device (port of the interpreter core of
``flexflow_tpu/runtime/executor.py``); ``runtime/data_parallel.py``
runs one on each rank of a data-parallel group.

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

The window path (the JAX executor's ``train_window``, ``train_batch_
repeated`` and ``eval_window``, which run ``k`` steps as one XLA
program): on a CUDA device each step kind is captured once per geometry
as a CUDA graph (``runtime/step_graph.py``) and replayed once a step;
the window's first step is the capture's eager warm-up. On the CPU the
same methods run the eager step ``k`` times. Keys as JAX's:
``train_window`` and ``eval_window`` give step ``i`` the key
``split(rng, k)[i]``, ``train_batch_repeated`` ``fold_in(rng, i)`` (the
same key). The window methods fire no fault site, as JAX's fire none. A
step writes the new non-trainable state into the state tensors in place
and the optimizer updates in place, so a graph, which reads the tensors
it was captured with, stays valid; replacing a tensor of ``params``,
``state`` or ``opt_state`` (``initialize``, or a caller's own rebinding)
drops the graphs and the next window captures again.

Each executor registers its programs in the process-wide
:data:`~flexflow_tpu_torch.obs.capacity.GLOBAL_PROGRAMS` under its own
namespace ``executor[n]``, with the JAX executor's names: ``.forward``
(``predict``), ``.eval_step``, ``.train_step``, ``.train_window[w]``,
``.train_repeat[w]`` and ``.eval_window[w]``. Where XLA traces a jitted
program, the port "traces" where the executor first meets a step
signature (a program at a new input geometry), and on a CUDA device the
window path's graph capture too (:meth:`Executor._program_call`): the
trace counts and the retrace blame follow JAX's. Compiled with an
optimizer, the executor registers the strategy simulator's whole-step
prediction in :data:`~flexflow_tpu_torch.obs.truth.GLOBAL_LEDGER` under
``executor[n].train_step`` (:meth:`Executor._register_step_prediction`),
and sampled train calls measure beside it (:meth:`Executor._truth_sample`):
the first four calls of a program, then every eighth, each timed between
two device syncs, a call that traced never. A collected executor takes
its namespace out of both.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import time
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..core.graph import Node, PCGraph
from ..core.types import LossType, MetricsType, OpType
from ..obs.capacity import GLOBAL_PROGRAMS
from ..obs.truth import GLOBAL_LEDGER
from ..ops.base import LowerCtx, get_op_def
from ..parallel.propagation import infer_all_specs
from . import faults, initializers, losses, metrics as metrics_mod
from .convert import to_tensor
from .optimizers import Optimizer, Params


def node_key(node: Node) -> str:
    return f"{node.op_type.value}_{node.guid}"


# Per-executor program namespace in GLOBAL_PROGRAMS ("executor[N].forward"):
# distinct executors run distinct programs, which must not read as
# retraces of one another in /v2/debug/programs.
_EXECUTOR_IDS = itertools.count()


def _device_count(device: torch.device) -> int:
    """Devices the step prediction's machine holds on one device: the one
    device the executor runs on (a data-parallel executor's machine holds
    its group's ranks instead)."""
    return 1


class _KeySig:
    """A step key as the JAX package's signature spells it (``key<fry>[]``):
    the port's keys are two int64 words, JAX's a typed key array."""

    shape = ()
    dtype = "key<fry>"


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
    # iteration-level sequence truncation (FFIterationConfig.seq_length),
    # carried into LowerCtx.seq_length; None = off
    seq_length: Optional[int] = None

    params: Optional[Params] = None
    state: Optional[Params] = None  # non-trainable (BatchNorm's running stats)
    opt_state: Optional[dict] = None
    _by_name: Optional[Dict[str, str]] = None
    # (pre nodes, repeated blocks, post nodes) when remat_blocks engaged
    _remat_plan: Optional[tuple] = None
    # the window path's step graphs by geometry, the leaf identities they
    # were captured with, and the number of captures made
    _graphs: Dict = dataclasses.field(default_factory=dict)
    _graph_leaves: Optional[tuple] = None
    graph_captures: int = 0
    # the compiled strategy (the step prediction walks it)
    strategy: Optional[object] = None
    # program -> the input geometries it has met (a new one is a trace)
    _seen: Dict = dataclasses.field(default_factory=dict)
    # program -> window calls (truth-ledger sampling)
    _truth_counts: Dict = dataclasses.field(default_factory=dict)
    # data parallelism (runtime/data_parallel.py): the rank's group, and
    # the rank plan of the step being run (its re-batched nodes, which
    # nodes hold the rank's rows); None on one device
    group: Optional[object] = None
    _plan: Optional[object] = None
    # dropout_masks' list while it runs
    _mask_sink: Optional[list] = None

    def __post_init__(self):
        self._prog_ns = f"executor[{next(_EXECUTOR_IDS)}]"
        # evict this executor's namespace when it is collected: rebuilding
        # executors in a loop must not grow GLOBAL_PROGRAMS or the ledger
        weakref.finalize(self, GLOBAL_PROGRAMS.remove_namespace, self._prog_ns)
        weakref.finalize(self, GLOBAL_LEDGER.remove_namespace, self._prog_ns)

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
                arr = initializers.get_initializer(w.initializer)(generator, w.spec)
                arr = self._local_weight(node_key(node), w.name, arr).to(self.device)
                if w.trainable:
                    params.setdefault(node_key(node), {})[w.name] = arr.requires_grad_(True)
                else:
                    state.setdefault(node_key(node), {})[w.name] = arr
        self.params = params
        self.state = state
        if self.optimizer is not None:
            self.opt_state = self.optimizer.init_state(params)
            # predict side of the truth ledger: the strategy simulator's
            # whole-step estimate, keyed so the measured train calls join it
            self._register_step_prediction()
        self._graphs, self._graph_leaves = {}, None
        return self

    def _local_weight(self, key: str, name: str, whole: torch.Tensor) -> torch.Tensor:
        """The part of weight ``name`` of node ``key`` this executor holds,
        from the whole one (drawn at initialization, or loaded): all of it
        on one device (a tensor-parallel rank keeps its shard)."""
        return whole

    # ------------------------------------------------ programs and truth
    def _register_step_prediction(self) -> None:
        """Register the strategy simulator's step time for this
        executor's train program in the truth ledger, from the calibration
        table ``load_or_calibrate`` finds (the user cache, the factory
        table, else the analytic default: it never measures). Telemetry
        only, as in the JAX package: a graph the predictor cannot walk
        never breaks compile."""
        try:
            from ..parallel.machine import MachineSpec
            from ..search.calibration import (
                CPU_FITTED_CONTENTION,
                chip_spec_for,
                detected_device_kind,
                load_or_calibrate,
            )
            from ..search.simulator import predict_strategy_time

            n = max(1, _device_count(self.device)) if self.group is None else self.group.size
            if self.device.type == "cpu":
                # the JAX package's CPU convention: N devices share one
                # host, so the peaks divide by N x the fitted contention
                chip = chip_spec_for("cpu")
                scale = n * CPU_FITTED_CONTENTION
                chip = dataclasses.replace(
                    chip,
                    bf16_flops=chip.bf16_flops / scale,
                    f32_flops=chip.f32_flops / scale,
                    hbm_bandwidth=chip.hbm_bandwidth / scale,
                )
            else:
                chip = chip_spec_for(detected_device_kind("cpu"))
            machine = MachineSpec(num_nodes=1, devices_per_node=n, chip=chip)
            predict_strategy_time(
                self.graph,
                self.strategy,
                machine=machine,
                calibration=load_or_calibrate(machine),
                ledger_key=f"{self._prog_ns}.train_step",
            )
        except Exception:
            pass

    def _signature(self, kind: str, inputs, label) -> Dict[str, object]:
        """The JAX program's arguments, by position, for the registry:
        (params, opt_state, state, inputs, label, key) for a train program,
        (params, state, inputs, label, key) for an eval one, (params,
        state, inputs, key) for ``forward``. Window programs stack their
        inputs ``[w, ...]``."""
        ins = tuple(inputs)
        if kind == "forward":
            args = (self.params, self.state, ins, _KeySig())
        elif kind == "eval":
            args = (self.params, self.state, ins, label, _KeySig())
        else:
            args = (self.params, self.opt_state, self.state, ins, label, _KeySig())
        return {f"arg{i}": a for i, a in enumerate(args)}

    @contextlib.contextmanager
    def _program_call(self, program: str, kind: str, inputs, label, steps: int = 1,
                      measure_train: bool = False):
        """Run one call of ``program`` (the body runs inside): register a
        trace when the call meets a new input geometry or captures a step
        graph (``self.graph_captures`` grows), stamp a trace's wall time
        as its compile time, and, for a sampled train call that did not
        trace, measure its seconds a step into the truth ledger. Only a
        traced or a sampled call syncs the device."""
        geom = (tuple((tuple(x.shape), x.dtype) for x in inputs),
                None if label is None else (tuple(label.shape), label.dtype))
        seen = self._seen.setdefault(program, set())
        traces_before = GLOBAL_PROGRAMS.trace_count(program)
        new = geom not in seen
        if new:
            seen.add(geom)
            GLOBAL_PROGRAMS.note_trace(program, self._signature(kind, inputs, label))
        measure = measure_train and self._truth_sample(program)
        captures = self.graph_captures
        if measure or new:
            # drain the backlog first: unsampled calls never sync, so the
            # device may still run earlier steps
            self._sync()
        t0 = time.perf_counter()  # flexlint: disable=clock-discipline
        yield
        if not new and self.graph_captures > captures:
            # a capture of a geometry met before (the graphs were dropped)
            GLOBAL_PROGRAMS.note_trace(program, self._signature(kind, inputs, label))
        traced = GLOBAL_PROGRAMS.trace_count(program) > traces_before
        if traced or measure:
            self._sync()
            elapsed = time.perf_counter() - t0  # flexlint: disable=clock-discipline
            if traced:
                GLOBAL_PROGRAMS.set_compile_time(program, elapsed)
            if measure:
                self._measure_window_step(program, traces_before, elapsed, steps)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _truth_sample(self, program: str) -> bool:
        """Whether to measure THIS call for the truth ledger. Measuring
        syncs the device, which serializes the host/device overlap a
        training loop otherwise has, so sample: the first four calls of a
        program, then every eighth."""
        n = self._truth_counts.get(program, 0)
        self._truth_counts[program] = n + 1
        return n < 4 or n % 8 == 0

    def _measure_window_step(self, program: str, traces_before: int,
                             elapsed: float, num_steps: int) -> None:
        """Measure side of the truth ledger: seconds per optimizer step of
        one call. A call that traced its program is left out: its time is
        the capture's, not a step's."""
        if GLOBAL_PROGRAMS.trace_count(program) > traces_before:
            return
        GLOBAL_LEDGER.measure(f"{self._prog_ns}.train_step", elapsed / max(1, num_steps))

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
        ctx = self._lower_ctx(training, rng)
        plan = self._plan
        for node in nodes:
            if plan is not None:
                # the rank's node (its batch literals re-batched), same guid
                node = plan.nodes.get(node.guid, node)
                ctx.split = plan.rows[node.guid]
            key = node_key(node)
            ctx.node_guid = node.guid
            node_inputs = self._node_inputs(node, values, ctx)
            weights = {**params.get(key, {}), **state.get(key, {})}
            outs = get_op_def(node.op_type).lower(node.params, node_inputs, weights, ctx)
            self._store_outputs(node, outs, values)
        return ctx

    def _lower_ctx(self, training: bool, rng) -> LowerCtx:
        return LowerCtx(training=training, rng=rng, backend=self.backend,
                        seq_length=self.seq_length, group=self.group, masks=self._mask_sink)

    def _node_inputs(self, node: Node, values, ctx: LowerCtx) -> List[torch.Tensor]:
        """The values ``node`` reads, in its input order (a tensor-parallel
        rank first moves each into the layout the node takes)."""
        return [values[(e.src, e.src_idx)] for e in self.graph.in_edges(node)]

    def _store_outputs(self, node: Node, outs, values) -> None:
        """Record ``node``'s outputs (a tensor-parallel rank first moves
        each into the layout its output spec names)."""
        for i, o in enumerate(outs):
            values[(node.guid, i)] = o

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
        (the JAX executor's default outside training), made on the
        device, when ``rng`` is None."""
        from ..generation import prng  # the generation package imports the runtime

        if rng is None:
            return prng.key(torch.zeros((), dtype=torch.int64, device=self.device))
        k1, k2 = rng
        return k1.to(self.device), k2.to(self.device)

    def _split_words(self, rng, n: int) -> torch.Tensor:
        """[n, 2] int64 on the device: row i holds the words of
        ``split(rng, n)[i]``, which is ``fold_in(rng, i)``."""
        from ..generation import prng  # the generation package imports the runtime

        k = self._step_key(rng)
        k1, k2 = prng.fold_in(k, torch.arange(n, dtype=torch.int64, device=k[0].device))
        return torch.stack([k1, k2], dim=1)

    def set_learning_rate(self, lr: float) -> None:
        """Set the learning rate in place (it lives in ``opt_state`` as a
        float32 device scalar the step reads, so a captured step takes it
        with no re-capture; reference: flexflow_c.cc set_learning_rate)."""
        if self.opt_state is not None and "lr" in self.opt_state:
            self.opt_state["lr"].fill_(float(lr))

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

    def _train_body(self, inputs, label, key) -> Dict[str, torch.Tensor]:
        """The device work of one train step: forward, loss, backward, the
        optimizer's in-place update (its host scalars already written by
        ``prepare``) and the new state copied into the state tensors.
        Launches only, no host sync: a CUDA graph captures it."""
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
            # grad_accum_steps is static: the loop unrolls over the keys'
            # leading axis (an unbind, no host sync)
            for i, k in enumerate(prng.split(key, accum)):  # flexlint: disable=capture-discipline
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
        self._sync_grads(grads)
        self._apply_update(grads)
        self._store_state(new_state)
        for p in leaves:
            p.grad = None
        return mets

    def _sync_grads(self, grads: Params) -> None:
        """Between the backward and the update: nothing on one device (a
        data-parallel rank all-reduces them here)."""

    def _apply_update(self, grads: Params) -> None:
        """The optimizer's in-place update of the parameters."""
        self.optimizer.update(self.params, grads, self.opt_state)

    @torch.no_grad()
    def _store_state(self, new_state: Params) -> None:
        """Copy the step's new state into the state tensors, in place."""
        if new_state is self.state:
            return
        for key, group in new_state.items():
            for name, val in group.items():
                cur = self.state[key][name]
                if val is not cur:
                    cur.copy_(val)

    def _check_trainable(self, what: str) -> None:
        if self.optimizer is None or self.loss_type is None:
            raise RuntimeError(f"{what} requires a compiled optimizer and loss")

    def train_batch(self, inputs: Sequence, label, rng=None) -> Dict[str, torch.Tensor]:
        """Forward, loss, backward, optimizer update (in place). ``rng``
        is the step's threefry key (dropout masks). Returns the batch's
        metrics and loss as device tensors (no host sync)."""
        self._check_trainable("train_batch")
        inputs = faults.inject(faults.EXECUTOR_TRAIN_BATCH, inputs)
        return self._train_step(inputs, label, self._step_key(rng))

    def _train_step(self, inputs: Sequence, label, key) -> Dict[str, torch.Tensor]:
        """``train_batch`` after its fault site, with its key made."""
        inputs = self._as_inputs(inputs)
        label = to_tensor(label, self.device)
        self.optimizer.prepare(self.opt_state)
        with self._program_call(f"{self._prog_ns}.train_step", "train", inputs, label,
                                measure_train=True):
            mets = self._train_body(inputs, label, key)
        self.opt_state["step"] += 1
        return mets

    @torch.no_grad()
    def _eval_body(self, inputs, label, key) -> Dict[str, torch.Tensor]:
        with _full_fp32():
            final = self._forward_impl(self.params, self.state, inputs, training=False,
                                       rng=key)[0][-1]
        mets = metrics_mod.compute_metrics(self.metric_types, final, label)
        if self.loss_type is not None:
            mets["loss"] = losses.get_loss_fn(self.loss_type)(final, label)
        return mets

    def eval_batch(self, inputs: Sequence, label, rng=None) -> Dict[str, torch.Tensor]:
        """The batch's metrics and loss in inference mode; ``rng`` reaches
        the ops as the step key (no op reads it outside training)."""
        return self._eval_step(inputs, label, None if rng is None else self._step_key(rng))

    def _eval_step(self, inputs: Sequence, label, key) -> Dict[str, torch.Tensor]:
        inputs = self._as_inputs(inputs)
        label = to_tensor(label, self.device)
        with self._program_call(f"{self._prog_ns}.eval_step", "eval", inputs, label):
            return self._eval_body(inputs, label, key)

    # ------------------------------------------------------------ windows
    def train_window(self, inputs: Sequence, labels, rng) -> Dict[str, torch.Tensor]:
        """One optimizer step per stacked batch: ``inputs``/``labels``
        carry a leading ``[steps, ...]`` axis, step i takes slice i and
        the key ``split(rng, steps)[i]``. Returns every step's metrics
        stacked ``[steps]`` (device tensors)."""
        self._check_trainable("train_window")
        inputs = self._as_inputs(inputs)
        labels = to_tensor(labels, self.device)
        return self._train_window(inputs, labels, self._split_words(rng, int(inputs[0].shape[0])))

    def _train_window(self, inputs, labels, words) -> Dict[str, torch.Tensor]:
        """``train_window`` with its keys given as words ([steps, 2])."""
        return self._window("train", inputs, labels, words, per_step=True)

    def train_batch_repeated(self, inputs: Sequence, label, rng,
                             num_steps: int) -> Dict[str, torch.Tensor]:
        """``num_steps`` optimizer steps on ONE batch, step i with the key
        ``fold_in(rng, i)``. Returns the last step's metrics."""
        self._check_trainable("train_batch_repeated")
        inputs = self._as_inputs(inputs)
        label = to_tensor(label, self.device)
        mets = self._window("train", inputs, label, self._split_words(rng, int(num_steps)),
                            per_step=False)
        return {k: v[-1] for k, v in mets.items()}

    def eval_window(self, inputs: Sequence, labels, rng=None) -> Dict[str, torch.Tensor]:
        """Evaluate one batch per leading-axis slice, step i with the key
        ``split(rng, steps)[i]`` (``rng`` defaults to ``key(0)``). Returns
        every step's metrics stacked ``[steps]``."""
        inputs = self._as_inputs(inputs)
        labels = to_tensor(labels, self.device)
        return self._window("eval", inputs, labels, self._split_words(rng, int(inputs[0].shape[0])),
                            per_step=True)

    def _window(self, kind: str, inputs, labels, words, per_step: bool):
        """Run ``len(words)`` steps of ``kind`` ("train" or "eval"): step
        i on slice i of the stacked inputs (``per_step``) or on the same
        batch, with the key words ``words[i]``; a captured graph on a
        CUDA device, the eager body on the CPU."""
        w = int(words.shape[0])
        name = ("eval_window" if kind == "eval" else
                "train_window" if per_step else "train_repeat")
        with self._program_call(f"{self._prog_ns}.{name}[{w}]", kind, inputs, labels, steps=w,
                                measure_train=kind == "train"):
            return self._window_steps(kind, inputs, labels, words, per_step)

    def _window_steps(self, kind: str, inputs, labels, words, per_step: bool):
        body = self._train_body if kind == "train" else self._eval_body
        w = int(words.shape[0])
        first = ([x[0] for x in inputs], labels[0]) if per_step else (inputs, labels)
        graph = self._step_graph(kind, body, *first) if self._captures() else None
        out: Dict[str, torch.Tensor] = {}
        for i in range(w):
            ins, lab = ([x[i] for x in inputs], labels[i]) if per_step else (inputs, labels)
            if kind == "train":
                self.optimizer.prepare(self.opt_state)
            if graph is None:
                mets = body(ins, lab, (words[i, 0], words[i, 1]))
            else:
                new = graph.graph is None
                if per_step or i == 0:
                    graph.load(ins, lab, words[i])
                else:
                    graph.load(key=words[i])
                mets = graph.run()
                self.graph_captures += int(new)
            if kind == "train":
                self.opt_state["step"] += 1
            if not out:
                out = {k: torch.empty((w,) + tuple(v.shape), dtype=v.dtype, device=v.device)
                       for k, v in mets.items()}
            for k, v in mets.items():
                out[k][i].copy_(v)
        return out

    def _captures(self) -> bool:
        """Whether the window path runs captured graphs: on a CUDA device."""
        return self.device.type == "cuda"

    def _step_graph(self, kind: str, body, inputs, label):
        """The step graph of this geometry, made (not yet captured) when
        new; every graph is dropped first if a tensor of the params,
        state or optimizer state was replaced since the captures."""
        from .step_graph import StepGraph, leaf_ids

        leaves = leaf_ids(self.params, self.state, self.opt_state)
        if leaves != self._graph_leaves:
            self._graphs, self._graph_leaves = {}, leaves
        sig = (kind, tuple((tuple(x.shape), x.dtype) for x in inputs),
               (tuple(label.shape), label.dtype), self.seq_length,
               int(self.grad_accum_steps), self._remat_plan is not None)
        graph = self._graphs.get(sig)
        if graph is None:
            graph = self._graphs[sig] = StepGraph(self.device, body, inputs, label,
                                                  wrap=_full_fp32)
        return graph

    def predict(self, inputs: Sequence) -> List[torch.Tensor]:
        # chaos hook: error / stall / NaN-poisoned outputs
        return faults.inject(faults.EXECUTOR_PREDICT, self._predict_outputs(inputs))

    @torch.no_grad()
    def _predict_outputs(self, inputs: Sequence) -> List[torch.Tensor]:
        inputs = self._as_inputs(inputs)
        with self._program_call(f"{self._prog_ns}.forward", "forward", inputs, None), \
                _full_fp32():
            return self._forward_impl(self.params, self.state, inputs, training=False)[0]

    @torch.no_grad()
    def dropout_masks(self, inputs: Sequence, rng) -> List[List[torch.Tensor]]:
        """A probe: the dropout masks a training step on ``inputs`` with
        the key ``rng`` draws, in the order drawn, from a training-mode
        forward that updates nothing. One list per rank (one here)."""
        return [self._masks_of(self._as_inputs(inputs), self._step_key(rng))]

    def _masks_of(self, inputs, key) -> List[torch.Tensor]:
        self._mask_sink = []
        try:
            with _full_fp32():
                self._forward_impl(self.params, self.state, inputs, training=True, rng=key)
            return self._mask_sink
        finally:
            self._mask_sink = None

    # ------------------------------------------------ whole training state
    def whole_specs(self) -> Dict[str, Dict[str, Dict[str, tuple]]]:
        """``{"params": ..., "state": ...}``: each leaf's whole shape and
        dtype by node key and weight name (a tensor-parallel rank holds
        shards of some of them)."""
        return {part: {k: {n: (tuple(t.shape), t.dtype) for n, t in g.items()}
                       for k, g in tree.items()}
                for part, tree in (("params", self.params), ("state", self.state or {}))}

    def whole_params(self) -> Params:
        """Every parameter, whole (on one device, ``params`` itself)."""
        return self.params

    def whole_state(self) -> Params:
        """Every state entry, whole (on one device, ``state`` itself)."""
        return self.state

    def whole_weight(self, key: str, name: str) -> torch.Tensor:
        """One weight or state entry of node ``key``, whole."""
        return {**self.params.get(key, {}), **self.state.get(key, {})}[name]

    def full_opt_state(self) -> Optional[dict]:
        """The optimizer state with every moment whole (a checkpoint's and
        ``set_weights``'): on one device, ``opt_state`` itself."""
        return self.opt_state

    @torch.no_grad()
    def load_whole(self, params: Optional[Params] = None, state: Optional[Params] = None,
                   opt_state: Optional[dict] = None) -> None:
        """Overwrite leaves with whole tensors of their shapes and dtypes:
        ``params`` and ``state`` as ``{node key: {name: tensor}}`` (any
        subset of the leaves), ``opt_state`` as :meth:`full_opt_state`
        gives it (the given moments, the step and the learning rate)."""
        for tree, given in ((self.params, params), (self.state, state)):
            for k, ws in (given or {}).items():
                for n, v in ws.items():
                    tree[k][n].copy_(v)
        if opt_state is not None:
            for field in ("m", "v"):
                for k, ws in (opt_state.get(field) or {}).items():
                    for n, v in ws.items():
                        self.opt_state[field][k][n].copy_(v)
            self.opt_state["step"] = int(opt_state["step"])
            self.set_learning_rate(float(opt_state["lr"]))


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
