"""A group of processes, one rank per device: its bootstrap, its
command channel, its collectives and its shutdown.

Two users share it. The generation engine serves over KV heads split
across ranks (``generation/sharding.py``, a ``"tensor-parallel"``
group), and the trainer runs a mesh of ``"data"`` and ``"model"`` axes:
each rank on its rows of the batch (``runtime/data_parallel.py``) and
its shards of the model-sharded weights (``runtime/tensor_parallel.py``). Rank 0 lives in the caller's process; it
starts ranks 1..N-1 itself (:func:`start_group`), as ``spawn`` processes
running :func:`_worker_main`, whose target object (built in the worker
by a factory the caller names) executes the commands rank 0 sends.
Everything runs in one Python program from the caller's view:
``GenerationEngine(params, cfg, tp_degree=2)``, or ``FFModel(config,
mesh=data_parallel_mesh(2))``.

* **Rendezvous.** A ``FileStore`` in a fresh temporary directory (never
  a fixed port: several groups, and several test processes, may start at
  once). The process group object is built directly on the store, not as
  ``torch.distributed``'s default group, so one process may hold several
  groups (several engines).
* **Transport.** Explicit (``parallel/mesh.py::serving_mesh``): ``nccl``
  for ranks on distinct GPUs, ``gloo`` on the CPU and for ranks that
  share one GPU. Gloo's collectives here run on host tensors: a CUDA
  tensor is staged through a pinned host buffer in :func:`all_reduce`
  and copied through host memory in :func:`gather_to_root` and
  :func:`scatter_from_root` (admission-time block moves), explicitly.
  Gather, scatter, broadcast and all-gather move bytes, so every dtype
  crosses either transport; an all-reduce sums in the tensor's own
  dtype (gloo and NCCL both add bfloat16 and float16).
* **Flat collectives.** Over gloo a call costs milliseconds whatever its
  size, so the trainer moves a step's tensors in one call per dtype:
  :func:`all_reduce_flat` (the gradients), :func:`broadcast_flat` (rank
  0's parameters) and :func:`all_gather_flat` (ZeRO-1's parameter
  slices) pack every tensor of a dtype into one flat buffer.
* **Sub-groups.** :func:`split_axes` gives every rank of a mesh's group
  its sub-group along each axis (the ranks whose other coordinates are
  its own, renumbered), each a process group on a prefix of the group's
  store, built by every rank in axis order.
* **Autograd.** :func:`all_reduce_sum` is an all-reduce with a backward
  (the all-reduce of the output's gradient): BatchNorm's global
  statistics reduce through it. The tensor-parallel layout moves each
  have one too: :func:`reduce_partial` (all-reduce; identity),
  :func:`copy_to_group` (identity; all-reduce), :func:`gather_dim`
  (all-gather along a dim; the rank's block), :func:`slice_dim` (the
  rank's block; all-gather) and :func:`reduce_scatter_dim` (the rank's
  block of the sum; all-gather).
* **Counts.** Each group counts its collectives by kind, with the host
  seconds spent in them and the bytes each rank put in
  (``RankGroup.counts``, ``seconds``, ``moved``).
* **Timeouts.** Every collective and every wait on a worker's answer
  carries the group's timeout, so a dead rank raises on rank 0 instead of
  hanging it.
* **Commands.** :meth:`RankGroup.send` pickles ``(op, args)`` to every
  worker over its pipe (:meth:`RankGroup.send_each`: each worker its own
  args); each worker calls ``getattr(target, op)(*args)`` and answers
  ``("ok", result)`` or ``("err", traceback)``; :meth:`RankGroup.replies`
  collects the answers. A command and the local work that pairs with it
  run under :attr:`RankGroup.lock`, so two threads never interleave
  their collectives.

The multi-host part of the JAX package's ``parallel/distributed.py``
(the ``FF_*`` environment, training across hosts) waits for a later
part of ROADMAP queue 1, item 5.
"""
from __future__ import annotations

import contextlib
import datetime
import multiprocessing as mp
import os
import shutil
import sys
import tempfile
import threading
import time
import traceback
import types
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 120.0

# the kinds of collective a group counts
KINDS = ("all_reduce", "gather", "scatter", "broadcast", "all_gather", "reduce_scatter")


def _process_group(store, rank: int, size: int, backend: str, timeout_s: float):
    """The group's collectives object for ``rank``, built on ``store`` (the
    group's file store, or a prefix of it for a sub-group)."""
    timeout = datetime.timedelta(seconds=timeout_s)
    if backend == "gloo":
        opts = dist.ProcessGroupGloo._Options()
        opts._timeout = timeout
        # every rank is on this host: the loopback interface
        opts._devices = [dist.ProcessGroupGloo.create_device(hostname="127.0.0.1")]
        return dist.ProcessGroupGloo(store, rank, size, opts)
    if backend == "nccl":
        opts = dist.ProcessGroupNCCL.Options()
        opts._timeout = timeout
        return dist.ProcessGroupNCCL(store, rank, size, opts)
    raise ValueError(f"unknown backend {backend!r}")


class RankGroup:
    """One rank's view of a group: its process group (``pg``), rank,
    size, transport and device, and what it is (``kind``, the word its
    errors use: ``"tensor-parallel"`` or ``"data-parallel"``). On rank 0
    it also holds the workers' processes and pipes (:meth:`send`,
    :meth:`replies`, :meth:`close`)."""

    def __init__(self, pg, rank: int, size: int, backend: str, device: torch.device,
                 timeout_s: float, kind: str = "tensor-parallel"):
        self.pg = pg
        self.kind = kind
        self.rank = rank
        self.size = size
        self.backend = backend
        self.device = device
        self.timeout_s = timeout_s
        self.lock = threading.RLock()
        self._pinned: Dict[Tuple[Tuple[int, ...], torch.dtype], torch.Tensor] = {}
        self._conns: List[Any] = []
        self._procs: List[Any] = []
        self._finalizer = None
        # the file store the group was built on (its sub-groups take
        # prefixes of it), and the mesh's axes once split (:func:`split_axes`):
        # axis name -> this rank's sub-group along it, and its coordinates
        self.store = None
        self.axes: Dict[str, "RankGroup"] = {}
        self.coords: Dict[str, int] = {}
        # collectives run so far on this rank, by kind, with the host
        # seconds spent inside them and the bytes each rank put in
        # (staging included: on a group whose ranks share a card, mostly
        # waiting for the peer)
        self.counts: Dict[str, int] = {k: 0 for k in KINDS}
        self.seconds: Dict[str, float] = {k: 0.0 for k in KINDS}
        self.moved: Dict[str, int] = {k: 0 for k in KINDS}

    def reset_counters(self) -> None:
        """Zero the counts, seconds and bytes of every kind, here and in
        the axes' sub-groups."""
        for g in {id(g): g for g in [self, *self.axes.values()]}.values():
            for k in KINDS:
                g.counts[k], g.seconds[k], g.moved[k] = 0, 0.0, 0

    def axis(self, name: str) -> "RankGroup":
        """This rank's sub-group along the mesh axis ``name``
        (:func:`split_axes`; a group of one rank for an axis the mesh
        lacks)."""
        if name not in self.axes:
            self.axes[name] = solo_group(self)
        return self.axes[name]

    @contextlib.contextmanager
    def _timed(self, kind: str, nbytes: int):
        self.counts[kind] += 1
        self.moved[kind] += nbytes
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[kind] += time.perf_counter() - t0

    # ---------------------------------------------------------- staging
    @property
    def host_staged(self) -> bool:
        """Gloo on a CUDA rank: collectives go through pinned host memory."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def _staging(self, t: torch.Tensor) -> torch.Tensor:
        key = (tuple(t.shape), t.dtype)
        buf = self._pinned.get(key)
        if buf is None:
            buf = self._pinned[key] = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return buf

    # -------------------------------------------------------- commands
    def send(self, op: str, *args) -> None:
        """Rank 0: send one command to every worker (no wait)."""
        self.send_each(op, [args] * len(self._conns))

    def send_each(self, op: str, args_by_worker: Sequence[tuple]) -> None:
        """Rank 0: send ``op`` to every worker, worker r with
        ``args_by_worker[r - 1]`` (no wait)."""
        for r, (conn, args) in enumerate(zip(self._conns, args_by_worker), start=1):
            try:
                conn.send((op, tuple(args)))
            except (BrokenPipeError, EOFError, OSError) as e:
                raise RuntimeError(f"{self.kind} rank {r} is gone ({e!r})") from e

    def replies(self) -> List[Any]:
        """Rank 0: every worker's answer to the last command, in rank
        order; raises with the worker's traceback on an error, or when a
        worker does not answer within the group's timeout."""
        out = []
        for r, conn in enumerate(self._conns, start=1):
            out.append(_answer(conn, r, self.timeout_s, self._procs[r - 1], self.kind))
        return out

    def call(self, op: str, *args) -> List[Any]:
        """Rank 0: a command answered before anything else runs (the
        workers' results)."""
        with self.lock:
            self.send(op, *args)
            return self.replies()

    def close(self) -> None:
        """Stop and join the workers, drop the store (rank 0); idempotent."""
        if self._finalizer is not None:
            self._finalizer()


# the engine's name for the group, kept for its callers
TPGroup = RankGroup


def _answer(conn, rank: int, timeout_s: float, proc, kind: str = "tensor-parallel") -> Any:
    if not conn.poll(timeout_s):
        state = "dead" if not proc.is_alive() else "alive"
        raise RuntimeError(f"{kind} rank {rank} did not answer within {timeout_s} s ({state})")
    try:
        status, value = conn.recv()
    except (EOFError, OSError) as e:
        raise RuntimeError(f"{kind} rank {rank} is gone ({e!r})") from e
    if status != "ok":
        raise RuntimeError(f"{kind} rank {rank} failed:\n{value}")
    return value


def _shutdown(conns, procs, store_dir, timeout_s) -> None:
    for conn in conns:
        try:
            conn.send(None)
        except Exception:
            pass
    for p in procs:
        p.join(timeout=min(timeout_s, 30.0))
        if p.is_alive():
            p.terminate()
            p.join(timeout=10.0)
    for conn in conns:
        try:
            conn.close()
        except Exception:
            pass
    shutil.rmtree(store_dir, ignore_errors=True)


@contextlib.contextmanager
def _main_module_hidden():
    """While a worker starts: ``spawn`` imports the parent's main module
    in the child (a script without a ``__main__`` guard would run again
    there; a test module would bring its imports). The workers need none
    of it: their entry point and factory are this package's, imported by
    name."""
    main = sys.modules["__main__"]
    sys.modules["__main__"] = types.ModuleType("__main__")
    try:
        yield
    finally:
        sys.modules["__main__"] = main


def start_group(
    devices: Sequence[torch.device],
    backend: str,
    factory: Callable[..., Any],
    worker_kwargs: Sequence[Dict[str, Any]],
    timeout_s: float = DEFAULT_TIMEOUT_S,
    kind: str = "tensor-parallel",
) -> RankGroup:
    """Start a group of ``len(devices)`` ranks: rank 0 here, on
    ``devices[0]``; rank r >= 1 in a new ``spawn`` process on
    ``devices[r]``, where ``factory(group=<the worker's RankGroup>,
    **worker_kwargs[r - 1])`` builds the object that executes rank 0's
    commands. ``factory`` must be importable by name (a module-level
    function of this package). Returns rank 0's group once every worker
    is ready; a worker that fails to start raises here with its
    traceback."""
    size = len(devices)
    store_dir = tempfile.mkdtemp(prefix="ff_tp_" if kind == "tensor-parallel" else "ff_dp_")
    store_path = os.path.join(store_dir, "store")
    ctx = mp.get_context("spawn")
    conns, procs = [], []
    try:
        for r in range(1, size):
            parent, child = ctx.Pipe()
            p = ctx.Process(
                target=_worker_main,
                args=(r, size, store_path, backend, str(devices[r]), timeout_s, child,
                      factory, worker_kwargs[r - 1], kind),
                daemon=True, name=f"ff-{'tp' if kind == 'tensor-parallel' else 'dp'}-rank{r}",
            )
            with _main_module_hidden():
                p.start()
            child.close()
            conns.append(parent)
            procs.append(p)
        device = torch.device(devices[0])
        store = dist.FileStore(store_path, size)
        pg = _process_group(store, 0, size, backend, timeout_s)
        group = RankGroup(pg, 0, size, backend, device, timeout_s, kind)
        group.store = store
        group._conns, group._procs = conns, procs
        for r, conn in enumerate(conns, start=1):
            _answer(conn, r, timeout_s, procs[r - 1], kind)  # "ready"
    except BaseException:
        _shutdown(conns, procs, store_dir, timeout_s)
        raise
    # stops the workers when the group is closed, collected, or at exit
    group._finalizer = weakref.finalize(group, _shutdown, conns, procs, store_dir, timeout_s)
    return group


def _worker_main(rank, size, store_path, backend, device, timeout_s, conn, factory, kwargs,
                 kind="tensor-parallel"):
    """A worker rank: join the group, build its target, then execute
    commands until rank 0 sends None or its pipe closes."""
    torch.set_num_threads(1)  # N ranks share the host's cores
    device = torch.device(device)
    try:
        if device.type == "cuda":
            torch.cuda.set_device(device)
        store = dist.FileStore(store_path, size)
        pg = _process_group(store, rank, size, backend, timeout_s)
        group = RankGroup(pg, rank, size, backend, device, timeout_s, kind)
        group.store = store
        target = factory(group=group, **kwargs)
        conn.send(("ok", "ready"))
    except BaseException:
        conn.send(("err", traceback.format_exc()))
        return
    while True:
        try:
            msg = conn.recv()
        except (EOFError, OSError):
            break
        if msg is None:
            break
        op, args = msg
        try:
            result = getattr(target, op)(*args)
            conn.send(("ok", result))
        except BaseException:
            conn.send(("err", traceback.format_exc()))
    close = getattr(target, "close", None)
    if close is not None:
        close()


# ------------------------------------------------------------ sub-groups
def solo_group(parent: RankGroup) -> RankGroup:
    """A group of one rank (an axis of size 1): every collective over it
    returns its input."""
    return RankGroup(None, 0, 1, parent.backend, parent.device, parent.timeout_s, parent.kind)


def mesh_coords(shape: Dict[str, int], rank: int) -> Dict[str, int]:
    """Rank ``rank``'s coordinate on each axis of ``shape`` (axis name ->
    size, in the mesh's order): the row-major reshape of the rank list,
    as the JAX package's ``build_mesh`` reshapes its device list (the
    last axis varies fastest)."""
    out: Dict[str, int] = {}
    for name in reversed(list(shape)):
        out[name] = rank % shape[name]
        rank //= shape[name]
    return {name: out[name] for name in shape}


def split_axes(group: RankGroup, shape: Dict[str, int]) -> Dict[str, RankGroup]:
    """Give ``group`` (a mesh's whole group, ``group.size`` the product of
    ``shape``'s sizes) one sub-group per axis: along axis a, the ranks
    whose other coordinates are this rank's, renumbered in rank order.
    Every rank of ``group`` calls it with the same ``shape`` (it is
    collective): each sub-group is a process group on a prefix of the
    group's store (``axis/<name>/<other coordinates>``), and every rank
    builds its sub-groups in axis order, or gloo's rendezvous would wait
    until the timeout. An axis of the whole group is the group itself;
    an axis of size 1 a group of one rank. Sets ``group.axes`` and
    ``group.coords`` and returns the axes."""
    total = 1
    for v in shape.values():
        total *= int(v)
    if total != group.size:
        raise ValueError(f"mesh {shape} needs {total} ranks, the group has {group.size}")
    mine = mesh_coords(shape, group.rank)
    axes: Dict[str, RankGroup] = {}
    for name, size in shape.items():
        if size == group.size:
            axes[name] = group
            continue
        if size == 1:
            axes[name] = solo_group(group)
            continue
        others = tuple(c for a, c in mine.items() if a != name)
        members = [r for r in range(group.size)
                   if tuple(c for a, c in mesh_coords(shape, r).items() if a != name) == others]
        prefix = f"axis/{name}/" + ".".join(map(str, others))
        sub_rank = members.index(group.rank)
        pg = _process_group(dist.PrefixStore(prefix, group.store), sub_rank, len(members),
                            group.backend, group.timeout_s)
        sub = RankGroup(pg, sub_rank, len(members), group.backend, group.device,
                        group.timeout_s, group.kind)
        sub.members = members
        axes[name] = sub
    group.axes, group.coords = axes, mine
    return axes


# ------------------------------------------------------------ collectives
def all_reduce(t: torch.Tensor, group: RankGroup) -> torch.Tensor:
    """Sum ``t`` over every rank of ``group``, in place, and return it.
    Every rank gets the same sum, bit for bit. Gloo on a CUDA rank stages
    through a pinned host buffer (a device sync)."""
    if group.size == 1:
        return t
    with group._timed("all_reduce", t.numel() * t.element_size()):
        if group.host_staged:
            buf = _staged_copy(group, t)
            group.pg.allreduce([buf]).wait()
            t.copy_(buf)
        else:
            if not t.is_contiguous():
                raise ValueError("all_reduce needs a contiguous tensor")
            group.pg.allreduce([t]).wait()
    return t


def _staged_copy(group: RankGroup, t: torch.Tensor) -> torch.Tensor:
    buf = group._staging(t)
    buf.copy_(t)  # blocking: the device's writes to t are done after it
    return buf


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """``t``'s bytes as a uint8 tensor (gather and scatter move bytes, so
    any dtype crosses either transport)."""
    t = t.contiguous()
    return t.view(torch.uint8) if t.dim() else t.reshape(1).view(torch.uint8)


def gather_to_root(t: torch.Tensor, group: RankGroup) -> Optional[List[torch.Tensor]]:
    """Every rank's ``t`` (the same shape and dtype on each) to rank 0:
    rank 0 gets the list in rank order, on its device; the others None."""
    if group.size == 1:
        return [t]
    staged = group.backend == "gloo"
    src = _bytes(t.cpu() if staged else t)
    opts = dist.GatherOptions()
    opts.rootRank = 0
    with group._timed("gather", src.numel()):
        if group.rank == 0:
            outs = [torch.empty_like(src) for _ in range(group.size)]
            group.pg.gather([outs], [src], opts).wait()
            return [o.view(t.dtype).view(t.shape).to(t.device) for o in outs]
        group.pg.gather([], [src], opts).wait()
    return None


def scatter_from_root(parts: Optional[Sequence[torch.Tensor]], shape, dtype: torch.dtype,
                      group: RankGroup) -> torch.Tensor:
    """Rank 0's ``parts[r]`` to rank r (every part ``shape`` and
    ``dtype``); every rank returns its own part, on its device. The other
    ranks pass None for ``parts``."""
    if group.size == 1:
        return parts[0].to(device=group.device, dtype=dtype).reshape(tuple(shape))
    staged = group.backend == "gloo"
    dev = torch.device("cpu") if staged else group.device
    shape = tuple(shape)
    out = _bytes(torch.empty(shape, dtype=dtype, device=dev))
    opts = dist.ScatterOptions()
    opts.rootRank = 0
    with group._timed("scatter", out.numel()):
        if group.rank == 0:
            ins = [_bytes(p.to(device=dev, dtype=dtype)) for p in parts]
            group.pg.scatter([out], [ins], opts).wait()
        else:
            group.pg.scatter([out], [], opts).wait()
    return out.view(dtype).view(shape).to(group.device)


def broadcast_from_root(t: Optional[torch.Tensor], shape, dtype: torch.dtype,
                        group: RankGroup) -> torch.Tensor:
    """Rank 0's ``t`` to every rank (``shape`` and ``dtype`` given on
    each; the other ranks pass None for ``t``); every rank returns it on
    its device."""
    staged = group.backend == "gloo"
    dev = torch.device("cpu") if staged else group.device
    shape = tuple(shape)
    if group.rank == 0:
        buf = _bytes(t.to(device=dev, dtype=dtype).contiguous())
    else:
        buf = _bytes(torch.empty(shape, dtype=dtype, device=dev))
    if group.size == 1:
        return buf.view(dtype).view(shape).to(group.device)
    opts = dist.BroadcastOptions()
    opts.rootRank = 0
    with group._timed("broadcast", buf.numel()):
        group.pg.broadcast([buf], opts).wait()
    return buf.view(dtype).view(shape).to(group.device)


def all_gather_flat(t: torch.Tensor, group: RankGroup) -> List[torch.Tensor]:
    """Every rank's ``t`` (one shape and dtype on all), in rank order, on
    this rank's device: bytes through host memory on gloo."""
    if group.size == 1:
        return [t]
    staged = group.backend == "gloo"
    src = _bytes(t.cpu() if staged else t)
    outs = [torch.empty_like(src) for _ in range(group.size)]
    with group._timed("all_gather", src.numel()):
        group.pg.allgather([outs], [src]).wait()
    return [o.view(t.dtype).view(t.shape).to(group.device) for o in outs]


def all_gather(t: torch.Tensor, group: RankGroup, dim: int) -> torch.Tensor:
    """The ranks' ``t`` (one shape and dtype on all) concatenated along
    ``dim`` in rank order: a tensor sharded on ``dim`` made whole."""
    return torch.cat(all_gather_flat(t.contiguous(), group), dim=dim)


def reduce_scatter(t: torch.Tensor, group: RankGroup, dim: int) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of every rank's ``t``
    (a new tensor). Over gloo the sum is one all-reduce of the whole
    tensor, then the rank's block (the same bits as a reduce-scatter:
    each element is the same sum of the same ranks' values)."""
    if group.size == 1:
        return t
    full = t.contiguous().clone()
    with group._timed("reduce_scatter", full.numel() * full.element_size()):
        if group.host_staged:
            buf = _staged_copy(group, full)
            group.pg.allreduce([buf]).wait()
            full.copy_(buf)
        else:
            group.pg.allreduce([full]).wait()
    return _block(full, group, dim).contiguous()


def _block(t: torch.Tensor, group: RankGroup, dim: int) -> torch.Tensor:
    """This rank's block of ``t`` along ``dim`` (a view)."""
    b = t.shape[dim] // group.size
    return t.narrow(dim, group.rank * b, b)


def _by_dtype(tensors: Sequence[torch.Tensor]) -> Dict[torch.dtype, List[torch.Tensor]]:
    """``tensors`` bucketed by dtype, each bucket in the given order."""
    out: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        out.setdefault(t.dtype, []).append(t)
    return out


def _flat(ts: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in ts])


def _unflat(flat: torch.Tensor, ts: Sequence[torch.Tensor]) -> None:
    """Copy the consecutive pieces of ``flat`` back into ``ts``."""
    o = 0
    for t in ts:
        n = t.numel()
        t.copy_(flat[o:o + n].view(t.shape))
        o += n


@torch.no_grad()
def all_reduce_flat(tensors: Sequence[torch.Tensor], group: RankGroup,
                    average: bool = False) -> None:
    """Sum ``tensors`` over the group, in place, with one all-reduce per
    dtype: each dtype's tensors, in the given order, packed into one
    flat buffer. The sum runs in that dtype: a bfloat16 or float16
    gradient is summed in bfloat16 or float16 (each partial sum rounds
    to it, as a GSPMD all-reduce of a 2-byte gradient does), a float32
    one in float32. ``average`` then divides by the group's size, in the
    same dtype. Every rank holds the same bits after it. Every rank must
    pass tensors of the same shapes, dtypes and order."""
    if group.size == 1:
        return
    for ts in _by_dtype(tensors).values():
        flat = _flat(ts)
        all_reduce(flat, group)
        if average:
            flat.div_(group.size)
        _unflat(flat, ts)


@torch.no_grad()
def broadcast_flat(tensors: Sequence[torch.Tensor], group: RankGroup) -> None:
    """Overwrite ``tensors`` on every rank with rank 0's, in place, with
    one broadcast per dtype (the same shapes, dtypes and order on every
    rank)."""
    if group.size == 1:
        return
    for dtype, ts in _by_dtype(tensors).items():
        n = sum(t.numel() for t in ts)
        flat = broadcast_from_root(_flat(ts) if group.rank == 0 else None, (n,), dtype, group)
        _unflat(flat, ts)


# ------------------------------------------------- collectives with a backward
class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        # every rank's output is the sum of every rank's input: the
        # gradient of an input gathers every rank's output gradient
        return all_reduce(g.contiguous().clone(), ctx.group), None


def all_reduce_sum(x: torch.Tensor, group: RankGroup) -> torch.Tensor:
    """``x`` summed over the group, with a backward (a new tensor; the
    backward is the all-reduce of the output's gradient)."""
    return _AllReduceSum.apply(x, group)


class _ReducePartial(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        # each rank's partial reaches the sum once: its gradient is the
        # sum's, which every rank holds whole
        return g, None


def reduce_partial(x: torch.Tensor, group: RankGroup) -> torch.Tensor:
    """A partial sum made whole: the all-reduce of ``x`` over ``group``;
    backward, the identity (layout rule "partial -> replicated")."""
    return _ReducePartial.apply(x, group)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


def copy_to_group(x: torch.Tensor, group: RankGroup) -> torch.Tensor:
    """A replicated tensor fed to an op whose weight is sharded over
    ``group``: the identity forward; backward, the all-reduce of the
    gradient (each rank's is the part its shard of the weight gives)."""
    return _CopyToGroup.apply(x, group)


class _GatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.group, ctx.dim).contiguous(), None, None


def gather_dim(x: torch.Tensor, group: RankGroup, dim: int) -> torch.Tensor:
    """A tensor sharded on ``dim`` over ``group`` made whole (all-gather);
    backward, the rank's block of the gradient (layout rule "sharded ->
    replicated")."""
    return _GatherDim.apply(x, group, dim)


class _SliceDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _block(x, group, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None


def slice_dim(x: torch.Tensor, group: RankGroup, dim: int) -> torch.Tensor:
    """A replicated tensor's block for this rank along ``dim``; backward,
    the all-gather of the blocks' gradients (layout rule "replicated ->
    sharded")."""
    return _SliceDim.apply(x, group, dim)


class _ReduceScatterDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None


def reduce_scatter_dim(x: torch.Tensor, group: RankGroup, dim: int) -> torch.Tensor:
    """A partial sum's block for this rank along ``dim``, summed over
    ``group``; backward, the all-gather of the blocks' gradients (layout
    rule "partial -> sharded")."""
    return _ReduceScatterDim.apply(x, group, dim)
