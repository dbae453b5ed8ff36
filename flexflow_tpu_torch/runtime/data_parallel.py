"""Data-parallel training over a group of ranks (the JAX package's GSPMD
data parallelism: ``data_parallel_strategy`` over a ``"data"`` mesh axis,
``flexflow_tpu/parallel/strategy.py`` and ``runtime/executor.py``).

``FFModel(config, mesh=data_parallel_mesh(N, ...))`` compiles a
:class:`DataParallelExecutor` on rank 0, in the caller's process, and
one on each worker rank of the mesh's group (``parallel/distributed.py``),
built from rank 0's graph (pickled, guids kept), optimizer, loss, metrics
and outputs; every rank draws its initial parameters from the model's
seed, as rank 0 did, so they are rank 0's. Each rank holds a full
replica and runs the one-device executor's step, its kernels included,
on its rows of the global batch. Every step gives what JAX's
data-parallel step gives, the step on the GLOBAL batch:

* **Rows.** With B global rows over N ranks, rank r takes the contiguous
  rows ``[r*B/N, (r+1)*B/N)``, GSPMD's batch sharding. When N does not
  divide B, the JAX package's strategy leaves the batch unsharded, and
  here every rank runs the whole batch (no row is dropped or padded);
  the gradients then go out from rank 0 by a broadcast instead of an
  all-reduce, so the ranks stay identical.
* **The rank's graph** (:func:`rank_plan`): the graph re-batched to the
  rank's rows, same node guids: an INPUT of B rows takes B/N, a RESHAPE
  whose leading literal is a multiple of B takes the same multiple of
  B/N. Every node's tensors are then either a block of rows of the
  global tensor or the whole of it; a node that is neither, or that
  turns rows into a whole tensor (a reduction over the batch), raises
  at compile. The plan tells each node which it is (``LowerCtx.split``).
* **Randomness.** A dropout node draws rows r of JAX's global mask, bit
  for bit: its threefry counters start at the rank's element offset
  (``LowerCtx.row_offset``, ``generation/prng.py``).
* **Batch reductions.** BatchNorm's training statistics are the global
  batch's (``ops/norm.py``), through an all-reduce with a backward. The
  loss is the mean of the ranks' equal-sized means; metrics merge as the
  JAX executor merges microbatches (:func:`merge_rank_metrics`).
* **Gradients.** After the local backward, one flat all-reduce per dtype
  (``parallel/distributed.py::all_reduce_flat``), in the gradient's own
  dtype: float32 for a float32 model; a bfloat16 (float16) model's
  gradients are bfloat16 (float16) and are summed, and divided by N, in
  that type. Every rank then holds the same bits, so the parameters stay
  bit-identical across ranks.
* **ZeRO-1** (``zero_optimizer=True``): each moment leaf is sharded as
  the JAX executor shards it, on its first dimension divisible by N
  (:func:`zero_dims`); each rank updates its slice of the parameters and
  moments (the update is elementwise, so its bits are the replicated
  update's), then one flat all-gather per dtype puts the slices
  together. Leaves with no such dimension update whole on every rank.
* **Accumulation, windows, evaluation.** ``grad_accum_steps`` strides
  each rank's rows (the rank's part of JAX's global microbatch i is
  exactly its rows ``i, i + accum, ...``). A window of steps runs its
  steps eagerly on every rank (no CUDA graph captures a gloo
  collective): ``eager_window_steps`` counts them, ``graph_captures``
  stays 0. ``evaluate`` and ``predict`` shard the rows and gather the
  outputs in row order.
* **Data.** ``fit`` ships every rank its rows of the dataset once
  (:meth:`DataParallelExecutor.load_rows`, a scatter through the group);
  a step then sends each rank only its window's place and keys.
* **Failures.** Every collective and every wait carries the group's
  timeout: a rank that dies makes the step raise on rank 0.

* **A mesh with a model axis.** ``runtime/tensor_parallel.py`` extends
  this executor: the rows and the ZeRO-1 slices then follow a rank's
  data coordinate, the gradients reduce over its data sub-group
  (:attr:`DataParallelExecutor.dgroup`, the whole group on a
  data-parallel mesh), and the answers merge from one rank of each block
  of rows (``_row_ranks``).

MoE graphs refuse N > 1 (``ops/moe_ops.py::refuse_data_parallel``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.graph import Node, PCGraph
from ..core.types import OpType
from ..parallel import distributed
from ..parallel.propagation import infer_all_specs
from ..parallel.strategy import _graph_batch
from .convert import to_tensor
from .executor import Executor
from .optimizers import Params, _leaves

_MODEL_IDS = itertools.count()


# ----------------------------------------------------------- rank plan
@dataclasses.dataclass
class RankPlan:
    """How one rank runs a step of ``batch`` global rows."""

    local: int  # this rank's rows (the whole batch when not split)
    split: bool  # the ranks hold row blocks (N divides the batch)
    nodes: Dict[int, Node]  # guid -> the rank's re-batched node
    rows: Dict[int, bool]  # guid -> its tensors are this rank's rows
    input_rows: Dict[int, bool]  # input index -> split by rows


def graph_batch(graph: PCGraph) -> int:
    """The batch the graph was built at: its first input's leading dim."""
    return _graph_batch(graph, 0)


def _rebatched(graph: PCGraph, gb: int, b: int) -> Tuple[PCGraph, Dict[int, Node]]:
    """``graph`` with its batch literals moved from ``gb`` to ``b`` rows:
    an INPUT of ``gb`` rows, a RESHAPE whose leading literal is a
    multiple of ``gb``. Same guids; returns the graph and the new nodes."""
    nodes: Dict[int, Node] = {}
    if b != gb:
        for node in graph.nodes.values():
            p = node.params
            if node.op_type == OpType.INPUT and p.shape and p.shape[0] == gb:
                nodes[node.guid] = dataclasses.replace(
                    node, params=dataclasses.replace(p, shape=(b,) + tuple(p.shape[1:])))
            elif (node.op_type == OpType.RESHAPE and p.shape and p.shape[0] > 0
                  and p.shape[0] % gb == 0):
                nodes[node.guid] = dataclasses.replace(
                    node, params=dataclasses.replace(
                        p, shape=(p.shape[0] // gb * b,) + tuple(p.shape[1:])))
    g = graph.copy()
    g.nodes.update(nodes)
    return g, nodes


def rank_plan(graph: PCGraph, batch: int, ranks: int) -> RankPlan:
    """The plan of a step of ``batch`` rows over ``ranks`` ranks: the
    rank's graph at ``batch / ranks`` rows when ``ranks`` divides it (else
    the whole batch on every rank), and which nodes hold row blocks.
    Raises ``NotImplementedError`` for a node whose rank tensor is not a
    block of rows of the global one, or that reduces rows to a whole
    tensor (a sum or mean over the batch)."""
    gb = graph_batch(graph)
    glob, _ = _rebatched(graph, gb, batch)
    split = ranks > 1 and batch % ranks == 0
    local = batch // ranks if split else batch
    loc, nodes = _rebatched(graph, gb, local)
    try:
        gspecs, lspecs = infer_all_specs(glob), infer_all_specs(loc)
    except ValueError as e:
        raise NotImplementedError(
            f"the graph (built at {gb} rows) does not re-batch to {local} rows a rank: {e}") from e
    rows: Dict[int, bool] = {}
    for node in glob.topo_order():
        kinds = set()
        for gs, ls in zip(gspecs[node.guid], lspecs[node.guid]):
            if tuple(gs.shape) == tuple(ls.shape):
                kinds.add(False)
            elif (ls.ndim == gs.ndim > 0 and tuple(gs.shape[1:]) == tuple(ls.shape[1:])
                  and ls.shape[0] * ranks == gs.shape[0]):
                kinds.add(True)
            else:
                raise NotImplementedError(
                    f"{node}: its rank tensor {tuple(ls.shape)} is not a block of rows of the "
                    f"global {tuple(gs.shape)}: data parallelism over a moved batch dim is not "
                    "ported")
        if len(kinds) > 1:
            raise NotImplementedError(f"{node}: some outputs hold rows, some the whole batch")
        r = kinds.pop() if kinds else False
        if split and not r and any(rows[e.src] for e in glob.in_edges(node)):
            raise NotImplementedError(
                f"{node} reduces the batch's rows to a whole tensor: a data-parallel rank "
                "would see its rows only")
        rows[node.guid] = r
    input_rows = {n.params.input_index: rows[n.guid]
                  for n in glob.nodes.values() if n.op_type == OpType.INPUT}
    return RankPlan(local, split, nodes, rows, input_rows)


def zero_dims(params: Params, ranks: int,
              taken: Optional[Dict[str, Dict[str, Optional[int]]]] = None
              ) -> Dict[str, Dict[str, Optional[int]]]:
    """The JAX executor's ZeRO-1 rule: each leaf's moments shard on its
    first dimension divisible by ``ranks`` that the leaf's own sharding
    leaves free (``taken[k][n]``: the dim the ``model`` axis shards, or
    None), None when it has none (its moments stay whole)."""
    taken = taken or {}
    return {k: {n: next((i for i, s in enumerate(p.shape)
                         if s % ranks == 0 and i != taken.get(k, {}).get(n)), None)
                for n, p in g.items()} for k, g in params.items()}


def merge_rank_metrics(per_rank: Sequence[Dict[str, torch.Tensor]],
                       batch: int) -> Dict[str, torch.Tensor]:
    """The ranks' metrics of equal row blocks merged as the JAX executor
    merges microbatches: the loss is their mean; ``rmse_loss`` (a square
    root of a mean, times the rows) goes back to each block's mean
    square, is averaged and re-applied; every other key is a per-batch
    sum. Works elementwise on stacked window metrics too."""
    b = batch // len(per_rank)
    out = {}
    for k, v0 in per_rank[0].items():
        v = torch.stack([v0] + [m[k].to(v0.device) for m in per_rank[1:]])
        if k == "loss":
            out[k] = v.mean(0)
        elif k == "rmse_loss":
            out[k] = (v / b).square().mean(0).sqrt() * batch
        else:
            out[k] = v.sum(0)
    return out


# ------------------------------------------------------------ the wire
@dataclasses.dataclass
class _Wired:
    """A tensor on the workers' pipes: its bytes in a numpy array (a
    plain pickle: no shared-memory handles), its dtype and shape."""

    dtype: str
    shape: Tuple[int, ...]
    data: np.ndarray


def to_wire(x: Any) -> Any:
    """``x`` with every tensor in it as a :class:`_Wired`."""
    if isinstance(x, torch.Tensor):
        t = x.detach().contiguous().cpu()
        raw = t.reshape(1) if t.dim() == 0 else t
        return _Wired(str(t.dtype)[6:], tuple(t.shape), raw.view(torch.uint8).numpy())
    if isinstance(x, dict):
        return {k: to_wire(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(to_wire(v) for v in x)
    return x


def from_wire(x: Any, device=None) -> Any:
    """``x`` with every :class:`_Wired` back as a tensor (on ``device``)."""
    if isinstance(x, _Wired):
        t = torch.from_numpy(np.array(x.data, copy=True)).view(getattr(torch, x.dtype))
        t = t.reshape(x.shape)
        return t if device is None else t.to(device)
    if isinstance(x, dict):
        return {k: from_wire(v, device) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(from_wire(v, device) for v in x)
    return x


def _part(t: torch.Tensor, rows: bool, r: int, n: int, dim: int) -> torch.Tensor:
    """Rank r's part of ``t`` along ``dim`` (a view): its block of rows, or
    all of ``t``."""
    if not rows:
        return t
    b = t.shape[dim] // n
    return t.narrow(dim, r * b, b)


@dataclasses.dataclass(eq=False)
class DataParallelExecutor(Executor):
    """One rank's executor of a data-parallel group (``group``). On rank
    0 its public methods (``train_batch``, the windows, ``eval_batch``,
    ``predict``) drive every rank: they send each worker its rows, run
    the same step here on rank 0's, and merge the answers. The
    ``_rank_*`` methods are one rank's part of a step, the same code on
    every rank."""

    zero: bool = False
    init_seed: int = 0  # the model's seed: every rank draws the same whole weights
    # steps a window ran eagerly on this rank (no graph captures here)
    eager_window_steps: int = 0

    def __post_init__(self):
        super().__post_init__()
        self._model_id = next(_MODEL_IDS)
        self._plans: Dict[int, RankPlan] = {}
        self._zero_dims = None
        self._data = None  # fit's rows on this rank: (inputs, label, rows a step)
        self._gb = None  # the graph's batch

    # --------------------------------------------------------- setup
    @property
    def rank(self) -> int:
        """This rank in the whole group."""
        return self.group.rank

    @property
    def ranks(self) -> int:
        return self.group.size

    @property
    def dgroup(self):
        """The ranks that share this rank's coordinates off the ``data``
        axis (the whole group on a data-parallel mesh): the gradients'
        all-reduce, ZeRO-1's slices and the batch statistics run over it."""
        return self.group.axis("data")

    @property
    def data_rank(self) -> int:
        return self.dgroup.rank

    @property
    def data_ranks(self) -> int:
        return self.dgroup.size

    def _data_coord(self, r: int) -> int:
        """Rank ``r``'s coordinate on the ``data`` axis (its block of rows)."""
        return r

    def _row_ranks(self) -> List[int]:
        """One rank per block of rows, in row order: the ranks whose
        answers are merged (every rank on a data-parallel mesh)."""
        return list(range(self.ranks))

    def plan(self, batch: int) -> RankPlan:
        """The rank plan of a ``batch``-row step (made once per batch)."""
        p = self._plans.get(batch)
        if p is None:
            p = self._plans[batch] = rank_plan(self.graph, batch, self.data_ranks)
        return p

    def initialize(self, generator: torch.Generator) -> "DataParallelExecutor":
        super().initialize(generator)
        self._data = None
        opt = self.opt_state
        if self.zero and opt is not None and any(opt.get(f) is not None for f in ("m", "v")):
            self._zero_dims = zero_dims(self.params, self.data_ranks, self._model_dims())
            # the moments of this rank's slices only
            with torch.no_grad():
                self.opt_state = self.optimizer.init_state(self._slices(self.params))
        return self

    def _model_dims(self) -> Optional[Dict[str, Dict[str, Optional[int]]]]:
        """Each leaf's dim sharded on the ``model`` axis (None: none)."""
        return None

    def _register_step_prediction(self) -> None:
        if self.rank == 0:  # the ledger of the caller's process
            super()._register_step_prediction()

    def _captures(self) -> bool:
        return False  # no CUDA graph captures a gloo collective

    def worker_spec(self) -> Dict[str, Any]:
        """What a worker rank builds its executor from."""
        return dict(cls=type(self), model_id=self._model_id, init_seed=self.init_seed,
                    graph=self.graph, loss_type=self.loss_type,
                    metric_types=self.metric_types, optimizer=self.optimizer,
                    outputs=self.outputs, backend=self.backend, remat_blocks=self.remat_blocks,
                    grad_accum_steps=self.grad_accum_steps, seq_length=self.seq_length,
                    zero=self.zero)

    def start_ranks(self) -> None:
        """Rank 0: build this executor on every worker rank (each draws
        the whole weights from the model's seed and keeps its part:
        nothing to send)."""
        self.group.call("build", self.worker_spec())

    def close(self) -> None:
        """Rank 0: drop this executor on the worker ranks (the group
        itself belongs to the mesh)."""
        if self.rank == 0 and self.group is not None and self.group._conns:
            self.group.call("drop", self._model_id)

    # --------------------------------------------------- driving ranks
    def _drive(self, op: str, local_args: tuple, worker_args: Sequence[tuple]) -> List[Any]:
        """Rank 0: run ``op`` on every rank, each with its own args
        (rank 0's here, with ``local_args``); returns every rank's result
        in rank order (the workers' on rank 0's device)."""
        g = self.group
        with g.lock:
            g.send_each("call", [(self._model_id, op, to_wire(a)) for a in worker_args])
            try:
                mine = getattr(self, op)(*local_args)
            except BaseException:
                # the workers' answers to this command must not be read as
                # the next one's
                with contextlib.suppress(Exception):
                    g.replies()
                raise
            rest = g.replies()
        return [mine] + [from_wire(x, self.device) for x in rest]

    def _same(self, op: str, *args) -> List[Any]:
        return self._drive(op, args, [args] * (self.ranks - 1))

    def _batch_of(self, inputs: Sequence[torch.Tensor], dim: int = 0) -> int:
        """The global rows of a step: the leading dim of the first input
        built at the graph's batch."""
        if self._gb is None:
            self._gb = graph_batch(self.graph)
        gb = self._gb
        for n in sorted((n for n in self.graph.nodes.values() if n.op_type == OpType.INPUT),
                        key=lambda n: n.params.input_index):
            if n.params.shape and n.params.shape[0] == gb:
                return int(inputs[n.params.input_index].shape[dim])
        return int(inputs[0].shape[dim])

    def _parts(self, inputs, label, batch: int, dim: int) -> List[tuple]:
        """Each rank's (inputs, label), in rank order: views of its rows
        of the step's tensors (``_drive`` puts the workers' on the wire)."""
        plan = self.plan(batch)
        label_rows = plan.rows[self.outputs[-1][0]]
        n = self.data_ranks
        out = []
        for r in range(self.ranks):
            d = self._data_coord(r)
            ins = [_part(x, plan.input_rows.get(i, False), d, n, dim)
                   for i, x in enumerate(inputs)]
            lab = None if label is None else _part(label, label_rows, d, n, dim)
            out.append((ins, lab))
        return out

    def _merged(self, per_rank: List[Dict[str, torch.Tensor]], batch: int):
        if not self.plan(batch).split:
            return per_rank[0]
        return merge_rank_metrics([per_rank[r] for r in self._row_ranks()], batch)

    def _key_words(self, key) -> Optional[torch.Tensor]:
        return None if key is None else torch.stack([key[0], key[1]]).cpu()

    def _key(self, words: Optional[torch.Tensor]):
        return None if words is None else (words[0], words[1])

    # ------------------------------------------- rank 0: the public steps
    def _train_step(self, inputs, label, key) -> Dict[str, torch.Tensor]:
        inputs = self._as_inputs(inputs)
        label = to_tensor(label, self.device)
        batch = self._batch_of(inputs)
        words = self._key_words(key)
        parts = self._parts(inputs, label, batch, 0)
        res = self._drive("_rank_train", (*parts[0], words, batch),
                          [(*p, words, batch) for p in parts[1:]])
        return self._merged(res, batch)

    def _window(self, kind: str, inputs, labels, words, per_step: bool):
        dim = 1 if per_step else 0
        batch = self._batch_of(inputs, dim)
        words = words.cpu()
        parts = self._parts(inputs, labels, batch, dim)
        res = self._drive("_rank_window", (kind, *parts[0], words, batch, per_step),
                          [(kind, *p, words, batch, per_step) for p in parts[1:]])
        return self._merged(res, batch)

    def _eval_step(self, inputs, label, key) -> Dict[str, torch.Tensor]:
        inputs = self._as_inputs(inputs)
        label = to_tensor(label, self.device)
        batch = self._batch_of(inputs)
        words = self._key_words(key)
        parts = self._parts(inputs, label, batch, 0)
        res = self._drive("_rank_eval", (*parts[0], words, batch),
                          [(*p, words, batch) for p in parts[1:]])
        return self._merged(res, batch)

    @torch.no_grad()
    def _predict_outputs(self, inputs) -> List[torch.Tensor]:
        inputs = self._as_inputs(inputs)
        batch = self._batch_of(inputs)
        parts = self._parts(inputs, None, batch, 0)
        res = self._drive("_rank_predict", (parts[0][0], batch),
                          [(p[0], batch) for p in parts[1:]])
        plan = self.plan(batch)
        # each output in row order: the ranks' blocks, or rank 0's whole
        return [torch.cat([res[r][j] for r in self._row_ranks()]) if plan.rows[g] else res[0][j]
                for j, (g, _) in enumerate(self.outputs)]

    @torch.no_grad()
    def dropout_masks(self, inputs, rng) -> List[List[torch.Tensor]]:
        """Every rank's dropout masks of a step on its rows (rank order):
        rank r's masks are rows r of the global ones."""
        inputs = self._as_inputs(inputs)
        batch = self._batch_of(inputs)
        words = self._key_words(self._step_key(rng))
        parts = self._parts(inputs, None, batch, 0)
        return self._drive("_rank_masks", (parts[0][0], words, batch),
                           [(p[0], words, batch) for p in parts[1:]])

    def _rank_masks(self, inputs, words, batch: int):
        with self._planned(batch):
            return self._masks_of(self._as_inputs(inputs), self._step_key(self._key(words)))

    def set_learning_rate(self, lr: float) -> None:
        if self.rank == 0:
            self._same("_rank_set_lr", float(lr))
        else:
            super().set_learning_rate(lr)

    def _rank_set_lr(self, lr: float) -> None:
        Executor.set_learning_rate(self, lr)

    # ------------------------------------------------- fit's shipped rows
    def load_rows(self, inputs: Sequence[torch.Tensor], label: torch.Tensor, batch: int,
                  steps: int) -> None:
        """Rank 0: ship every rank its rows of ``steps`` batches of
        ``batch`` rows of the dataset, once (a scatter of the row blocks,
        or a broadcast of the whole when the ranks run whole batches);
        :meth:`fit_window` then steps through them."""
        plan = self.plan(batch)
        n = self.data_ranks
        tensors = list(inputs) + [label]
        flags = [plan.input_rows.get(i, False) for i in range(len(inputs))] + [
            plan.rows[self.outputs[-1][0]]]
        metas, mine = [], []
        for t, rows in zip(tensors, flags):
            t = t[:steps * batch]
            rest = tuple(t.shape[1:])
            if rows:
                b = batch // n
                blocks = t.reshape((steps, n, b) + rest)
                blocks = [blocks[:, d].reshape((steps * b,) + rest) for d in range(n)]
                parts = [blocks[self._data_coord(r)] for r in range(self.ranks)]
                metas.append(((steps * b,) + rest, t.dtype, True))
                mine.append(parts)
            else:
                metas.append((tuple(t.shape), t.dtype, False))
                mine.append(t)
        self._drive("_rank_load_rows", (metas, batch, mine),
                    [(metas, batch, None)] * (self.ranks - 1))

    def _rank_load_rows(self, metas, batch: int, tensors=None) -> None:
        got = []
        for i, (shape, dtype, rows) in enumerate(metas):
            src = None if tensors is None else tensors[i]
            if rows:
                got.append(distributed.scatter_from_root(src, shape, dtype, self.group))
            else:
                got.append(distributed.broadcast_from_root(src, shape, dtype, self.group))
        plan = self.plan(batch)
        self._data = (got[:-1], got[-1], plan.local if plan.split else batch)

    def fit_window(self, first_step: int, steps: int, words: torch.Tensor,
                   batch: int) -> Dict[str, torch.Tensor]:
        """Rank 0: ``steps`` optimizer steps from step ``first_step`` of
        the rows :meth:`load_rows` shipped (a window of them when
        ``steps > 1``), with the key words ``words`` ([steps, 2] on the
        host). Returns every step's merged metrics stacked ``[steps]``."""
        res = self._same("_rank_fit_window", first_step, steps, words, batch)
        return self._merged(res, batch)

    def _rank_fit_window(self, first_step: int, steps: int, words, batch: int):
        xs, y, b = self._data
        lo, hi = first_step * b, (first_step + steps) * b
        if steps > 1:
            stack = lambda t: t[lo:hi].reshape((steps, b) + tuple(t.shape[1:]))  # noqa: E731
            return self._rank_window("train", [stack(x) for x in xs], stack(y), words, batch,
                                     True)
        mets = self._rank_train([x[lo:hi] for x in xs], y[lo:hi], words[0], batch)
        return {k: v.reshape(1) for k, v in mets.items()}

    # ---------------------------------------------- one rank's part
    @contextlib.contextmanager
    def _planned(self, batch: int):
        """Run the block under the rank plan of a ``batch``-row step."""
        self._plan = self.plan(batch)
        try:
            yield
        finally:
            self._plan = None

    def _rank_train(self, inputs, label, words, batch: int):
        with self._planned(batch):
            return Executor._train_step(self, inputs, label, self._step_key(self._key(words)))

    def _rank_window(self, kind: str, inputs, labels, words, batch: int, per_step: bool):
        inputs = self._as_inputs(inputs)
        labels = to_tensor(labels, self.device)
        words = words.to(self.device)
        with self._planned(batch):
            mets = Executor._window(self, kind, inputs, labels, words, per_step)
        self.eager_window_steps += int(words.shape[0])
        return mets

    def _rank_eval(self, inputs, label, words, batch: int):
        key = None if words is None else self._step_key(self._key(words))
        with self._planned(batch):
            return Executor._eval_step(self, inputs, label, key)

    def _rank_predict(self, inputs, batch: int):
        with self._planned(batch):
            return Executor._predict_outputs(self, inputs)

    # --------------------------------------------- gradients and update
    def _sync_grads(self, grads: Params) -> None:
        leaves = [grads[k][n] for k, n, _ in _leaves(self.params)]
        if self._plan.split:
            distributed.all_reduce_flat(leaves, self.dgroup, average=True)
        else:
            # every rank ran the whole batch: rank 0's gradients for all
            distributed.broadcast_flat(leaves, self.dgroup)

    def _slices(self, tree: Params) -> Params:
        """This rank's ZeRO-1 slice of each leaf of a params-shaped tree
        (views; a leaf with no sharded dimension whole)."""
        out: Params = {}
        for k, g in tree.items():
            out[k] = {}
            for n, t in g.items():
                d = self._zero_dims[k][n]
                out[k][n] = t if d is None else _part(t, True, self.data_rank, self.data_ranks, d)
        return out

    def _all_gather_slices(self, pairs, group=None) -> None:
        """Fill every rank's slice of each ``(whole tensor, dim, this
        rank's slice)`` from the rank of ``group`` (default: the data
        axis's) that owns it: one flat all-gather per dtype."""
        group = self.dgroup if group is None else group
        by_dtype: Dict[torch.dtype, list] = {}
        for whole, d, part in pairs:
            by_dtype.setdefault(part.dtype, []).append((whole, d, part))
        for items in by_dtype.values():
            flat = torch.cat([part.reshape(-1) for _, _, part in items])
            for q, got in enumerate(distributed.all_gather_flat(flat, group)):
                o = 0
                for whole, d, part in items:
                    k = part.numel()
                    l_ = part.shape[d]
                    whole.narrow(d, q * l_, l_).copy_(got[o:o + k].view(part.shape))
                    o += k

    def _apply_update(self, grads: Params) -> None:
        if self._zero_dims is None:
            return super()._apply_update(grads)
        with torch.no_grad():
            self.optimizer.update(self._slices(self.params), self._slices(grads), self.opt_state)
            self._all_gather_slices([
                (p, self._zero_dims[k][n], _part(p, True, self.data_rank, self.data_ranks,
                                                   self._zero_dims[k][n]))
                for k, n, p in _leaves(self.params) if self._zero_dims[k][n] is not None])

    # ------------------------------------------------- whole training state
    def full_opt_state(self) -> Optional[dict]:
        """The optimizer state with whole moments: under ZeRO-1 the ranks'
        slices all-gathered (new tensors, on rank 0); else ``opt_state``."""
        if self._zero_dims is None:
            return self.opt_state
        return self._same("_rank_whole_moments")[0]

    def _rank_whole_moments(self) -> Optional[dict]:
        out = self._local_moments()
        return out if self.rank == 0 else None

    @torch.no_grad()
    def _local_moments(self) -> dict:
        """The optimizer state with this rank's ZeRO-1 slices gathered over
        the data axis (every rank's)."""
        out = dict(self.opt_state)
        for field in ("m", "v"):
            tree = self.opt_state.get(field)
            if tree is None:
                continue
            whole = {k: {n: (s if self._zero_dims[k][n] is None else torch.empty(
                self.params[k][n].shape, dtype=s.dtype, device=s.device))
                for n, s in g.items()} for k, g in tree.items()}
            self._all_gather_slices([(whole[k][n], self._zero_dims[k][n], tree[k][n])
                                     for k, n, _ in _leaves(tree)
                                     if self._zero_dims[k][n] is not None])
            out[field] = whole
        return out

    def load_whole(self, params: Optional[Params] = None, state: Optional[Params] = None,
                   opt_state: Optional[dict] = None) -> None:
        """Rank 0: overwrite leaves with whole tensors (as
        :meth:`Executor.load_whole` takes them): one broadcast per dtype
        to every rank, which keeps its part (``_local_weight``) and its
        ZeRO-1 slices of the moments."""
        items = []
        for part, tree in (("params", params), ("state", state)):
            items += [(part, k, n, v) for k, ws in (tree or {}).items() for n, v in ws.items()]
        step = lr = None
        if opt_state is not None:
            for field in ("m", "v"):
                items += [(field, k, n, v) for k, ws in (opt_state.get(field) or {}).items()
                          for n, v in ws.items()]
            step, lr = int(opt_state["step"]), float(opt_state["lr"])
        meta = [(part, k, n, tuple(v.shape), str(v.dtype)[6:]) for part, k, n, v in items]
        tensors = [v for *_, v in items]
        self._drive("_rank_load_whole", (meta, tensors, step, lr),
                    [(meta, None, step, lr)] * (self.ranks - 1))

    @torch.no_grad()
    def _rank_load_whole(self, meta, tensors, step, lr) -> None:
        if tensors is None:
            tensors = [torch.empty(shape, dtype=getattr(torch, dt), device=self.device)
                       for *_, shape, dt in meta]
        else:
            tensors = [t.to(self.device).contiguous() for t in tensors]
        distributed.broadcast_flat(tensors, self.group)
        for (part, k, n, _, _), t in zip(meta, tensors):
            block = self._local_weight(k, n, t)
            if part in ("m", "v"):
                z = None if self._zero_dims is None else self._zero_dims[k][n]
                if z is not None:
                    block = _part(block, True, self.data_rank, self.data_ranks, z)
                self.opt_state[part][k][n].copy_(block)
            else:
                getattr(self, part)[k][n].copy_(block)
        if step is not None:
            self.opt_state["step"] = step
            Executor.set_learning_rate(self, lr)

    # ------------------------------------------------------- per rank
    def rank_info(self) -> List[Dict[str, Any]]:
        """Rank 0: every rank's counters (``_rank_info``), in rank order."""
        return self._same("_rank_info")

    def _rank_info(self) -> Dict[str, Any]:
        from ..ops.kernels import flash_attention as fa

        groups = {id(g): g for g in [self.group, *self.group.axes.values()]}.values()
        info = {"rank": self.rank, "device": str(self.device), "coords": dict(self.group.coords),
                "flash_launches": dict(fa.LAUNCHES),
                "flash_launches_by_body": dict(getattr(fa, "LAUNCHES_BY_BODY", {})),
                "flash_launches_by_heads": dict(fa.LAUNCHES_BY_HEADS),
                # every group of this rank together: the whole group's and
                # the axes' sub-groups'
                "collectives": {k: sum(g.counts[k] for g in groups) for k in distributed.KINDS},
                "collective_s": {k: sum(g.seconds[k] for g in groups) for k in distributed.KINDS},
                "collective_bytes": {k: sum(g.moved[k] for g in groups)
                                     for k in distributed.KINDS},
                "eager_window_steps": self.eager_window_steps,
                "graph_captures": self.graph_captures,
                "param_bytes": sum(t.numel() * t.element_size()
                                   for _, _, t in _leaves(self.params)),
                "moment_bytes": sum(t.numel() * t.element_size()
                                    for f in ("m", "v") if self.opt_state is not None
                                    and self.opt_state.get(f) is not None
                                    for _, _, t in _leaves(self.opt_state[f])),
                "params_sha": _tree_digest(self.params)}
        if self.device.type == "cuda":
            info["max_memory_allocated"] = torch.cuda.max_memory_allocated(self.device)
        return info

    def reset_rank_counters(self) -> None:
        """Rank 0: zero every rank's flash launch counts, collective
        counters and peak memory."""
        self._same("_rank_reset_counters")

    def _rank_reset_counters(self) -> None:
        from ..ops.kernels import flash_attention as fa

        fa.reset_launch_counts()
        self.group.reset_counters()
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)


def _tree_digest(tree: Params) -> str:
    """A digest of every leaf's bytes, in leaf order (ranks compare it to
    show their parameters are bit-identical)."""
    import hashlib

    h = hashlib.sha256()
    for k, n, t in _leaves(tree):
        h.update(f"{k}.{n}".encode())
        t = t.detach().contiguous().cpu()
        h.update((t.reshape(1) if t.dim() == 0 else t).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


class _RankHost:
    """A worker rank's target: the executors of every model compiled on
    its mesh, by model id."""

    def __init__(self, group):
        self.group = group
        self.executors: Dict[int, DataParallelExecutor] = {}

    def split_axes(self, shape: Dict[str, int]) -> None:
        """Build this rank's sub-group along each axis of the mesh (with
        every other rank: ``Mesh.group``)."""
        distributed.split_axes(self.group, shape)

    def build(self, spec: Dict[str, Any]) -> None:
        spec = dict(spec)
        cls, mid = spec.pop("cls"), spec.pop("model_id")
        ex = cls(device=self.group.device, group=self.group, **spec)
        ex._model_id = mid
        # the whole weights rank 0 drew, from the model's seed; the rank
        # keeps its part
        ex.initialize(torch.Generator().manual_seed(ex.init_seed))
        self.executors[mid] = ex

    def drop(self, model_id: int) -> None:
        self.executors.pop(model_id, None)

    def call(self, model_id: int, op: str, args) -> Any:
        return to_wire(getattr(self.executors[model_id], op)(*from_wire(args)))


def rank_host(group) -> _RankHost:
    """The factory of a data-parallel worker rank (``Mesh.group``)."""
    return _RankHost(group)
