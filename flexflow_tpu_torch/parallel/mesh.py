"""Mesh axis names, the training mesh and its device-count check (port
of ``flexflow_tpu/parallel/mesh.py``: the axis names, ``build_mesh`` and
``data_parallel_mesh``).

A strategy names its parallelism kinds by mesh axis:
  "data"    -- batch/sample parallelism (reference: DP)
  "model"   -- tensor/parameter parallelism (reference: TP)
  "seq"     -- sequence/context parallelism
  "expert"  -- expert parallelism for MoE
  "pipe"    -- pipeline stages
Unused axes have size 1 and are dropped.

:func:`build_mesh` checks that the devices it is given cover the
strategy's axes (the JAX package's error otherwise) and returns a
:class:`Mesh`: the axes of size > 1, one device per rank and the
collectives' transport. A mesh of one rank is the one device it names.
A ``"data"`` axis of N > 1 ranks trains data-parallel
(``runtime/data_parallel.py``): ``FFModel(config, mesh=
data_parallel_mesh(2, ...))``; a ``"model"`` axis, alone or with
``"data"``, tensor-parallel (``runtime/tensor_parallel.py``): ``mesh=
tensor_parallel_mesh(tp, dp, ...)``. Rank r's coordinates follow the JAX
package's ``build_mesh``: its device list reshaped row-major to the
axes' sizes, so with ``{"data": dp, "model": tp}`` rank r sits at
``(r // tp, r % tp)``. The mesh starts its group of ranks
(``parallel/distributed.py``) at the first model compiled on it, and
every model compiled on it shares the group; every rank then builds its
sub-group along each axis (:meth:`Mesh.group`: the data sub-group of the
ranks that share its model coordinate, the model sub-group of the ranks
that share its rows). :meth:`Mesh.close` stops it (a finalizer does it
for a mesh never closed).

The transport is explicit (:func:`transport`, the same rule for the
training mesh and the engine's :func:`serving_mesh`): ``nccl`` by default
for ranks on distinct GPUs; ``gloo`` on the CPU (CPU ranks are
processes: list ``"cpu"`` once per rank) and, named by the caller, for
ranks that share one GPU, where NCCL cannot put two ranks of one
communicator. No transport is switched quietly, and no CPU rank is made
unless the caller lists it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
EXPERT_AXIS = "expert"
PIPE_AXIS = "pipe"

# the collectives' transports a mesh may name
BACKENDS = ("gloo", "nccl")


def available_devices() -> List[torch.device]:
    """The GPUs of this process, or the CPU when there is none."""
    if torch.cuda.is_available():
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def gpus() -> List[torch.device]:
    """The GPUs of this process (none on a machine without one)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return [torch.device("cuda", i) for i in range(n)]


def transport(devices: Sequence[torch.device], backend: Optional[str], what: str = "mesh"):
    """``(devices, backend)`` of a group of ranks, ``devices[r]`` rank
    r's, checked: all on cuda or all on cpu; ``nccl`` by default on
    distinct GPUs, ``gloo`` on the CPU; ranks that share a GPU need
    ``backend="gloo"`` from the caller; ``nccl`` on CPU ranks raises."""
    use = tuple(torch.device(d) for d in devices)
    types = {d.type for d in use}
    if len(types) != 1 or types - {"cpu", "cuda"}:
        raise ValueError(f"a {what}'s ranks all sit on cuda or all on cpu, got {use}")
    if backend is not None and backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if "cpu" in types:
        if backend == "nccl":
            raise ValueError("backend='nccl' needs CUDA devices; CPU ranks use backend='gloo'")
        return use, "gloo"
    use = tuple(torch.device("cuda", d.index if d.index is not None else 0) for d in use)
    shared = len(set(use)) < len(use)
    if backend is None:
        if shared:
            raise ValueError(
                f"ranks share a GPU ({[str(d) for d in use]}): NCCL cannot put two "
                f"ranks of one communicator on one device; pass backend='gloo'"
            )
        backend = "nccl"
    elif backend == "nccl" and shared:
        raise ValueError(
            f"backend='nccl' with ranks sharing a GPU ({[str(d) for d in use]}); "
            f"pass backend='gloo'"
        )
    return use, backend


class Mesh:
    """A training mesh: its named axes (``shape``, sizes > 1), one device
    per rank (``devices[r]`` is rank r's), the collectives' transport
    (None for one rank) and the group's timeout. Compares equal to its
    ``shape`` dict (the axes :func:`build_mesh` returned before the mesh
    carried devices)."""

    def __init__(self, shape: Dict[str, int], devices: Sequence[torch.device],
                 backend: Optional[str] = None, timeout_s: Optional[float] = None):
        from .distributed import DEFAULT_TIMEOUT_S

        self._shape = dict(shape)
        self.devices: Tuple[torch.device, ...] = tuple(devices)
        self.backend = backend
        self.timeout_s = DEFAULT_TIMEOUT_S if timeout_s is None else float(timeout_s)
        self._group = None

    @property
    def shape(self) -> Dict[str, int]:
        return dict(self._shape)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self._shape)

    @property
    def size(self) -> int:
        return len(self.devices)

    def __eq__(self, other) -> bool:
        if isinstance(other, Mesh):
            return (self._shape, self.devices, self.backend) == (
                other._shape, other.devices, other.backend)
        return self._shape == other

    __hash__ = None

    def __repr__(self) -> str:
        return (f"Mesh({self._shape}, devices={[str(d) for d in self.devices]}, "
                f"backend={self.backend!r})")

    def group(self):
        """Rank 0's :class:`~.distributed.RankGroup` over the mesh's
        devices, started at the first call (the kernels are built here
        first on a GPU, so no two ranks build them at once), with every
        rank's sub-group along each axis (``group.axis("data")``,
        ``group.axis("model")``)."""
        if self._group is None:
            from ..runtime import data_parallel
            from . import distributed

            if self.devices[0].type == "cuda":
                from ..ops.kernels._build import load_library

                load_library()
            kind = "tensor-parallel" if MODEL_AXIS in self._shape else "data-parallel"
            group = distributed.start_group(
                self.devices, self.backend, data_parallel.rank_host, [{}] * (self.size - 1),
                timeout_s=self.timeout_s, kind=kind)
            try:
                # every rank builds its sub-group along each axis, together
                with group.lock:
                    group.send("split_axes", self._shape)
                    distributed.split_axes(group, self._shape)
                    group.replies()
            except BaseException:
                group.close()
                raise
            self._group = group
        return self._group

    @property
    def started(self) -> bool:
        return self._group is not None

    def close(self) -> None:
        """Stop and join the mesh's ranks (nothing when none started);
        idempotent."""
        if self._group is not None:
            self._group.close()
            self._group = None


def build_mesh(axis_sizes: Dict[str, int], devices: Optional[Sequence] = None,
               backend: Optional[str] = None, timeout_s: Optional[float] = None) -> Mesh:
    """The :class:`Mesh` of a strategy's axes (sizes > 1; ``{"data": 1}``
    when none is) over the first of ``devices`` (default:
    :func:`available_devices`), after checking that they hold as many
    devices as the axes' product, with the JAX package's
    ``ValueError("mesh needs N devices, have M")``. A mesh of more than
    one rank takes its transport from :func:`transport`."""
    sizes = {k: v for k, v in axis_sizes.items() if v > 1}
    if not sizes:
        sizes = {DATA_AXIS: 1}
    if devices is None:
        devices = available_devices()
    total = 1
    for v in sizes.values():
        total *= int(v)
    if total > len(devices):
        raise ValueError(f"mesh needs {total} devices, have {len(devices)}")
    use = [torch.device(d) for d in list(devices)[:total]]
    if total == 1:
        return Mesh(sizes, use, None, timeout_s)
    use, backend = transport(use, backend)
    return Mesh(sizes, use, backend, timeout_s)


def data_parallel_mesh(n: int, devices: Optional[Sequence] = None,
                       backend: Optional[str] = None,
                       timeout_s: Optional[float] = None) -> Mesh:
    """A ``"data"`` axis of ``n`` ranks over the first ``n`` of
    ``devices`` (default: the GPUs of this process; never the CPU unless
    listed), the JAX package's ``data_parallel_mesh``. Two ranks on one
    card: ``devices=["cuda:0", "cuda:0"], backend="gloo"``; two CPU
    ranks: ``devices=["cpu", "cpu"]``. ``timeout_s`` bounds every
    collective and every wait on a rank (default
    ``parallel/distributed.py``'s ``DEFAULT_TIMEOUT_S``)."""
    if n < 1:
        raise ValueError(f"a data-parallel mesh needs n >= 1, got {n}")
    return build_mesh({DATA_AXIS: n}, gpus() if devices is None else devices, backend,
                      timeout_s)


def tensor_parallel_mesh(tp: int, dp: int = 1, devices: Optional[Sequence] = None,
                         backend: Optional[str] = None,
                         timeout_s: Optional[float] = None) -> Mesh:
    """A ``{"data": dp, "model": tp}`` training mesh (``megatron_strategy(
    graph, dp, tp)``'s) over the first ``dp * tp`` of ``devices`` (default:
    the GPUs of this process; never the CPU unless listed). Rank r sits
    at data coordinate ``r // tp`` and model coordinate ``r % tp``, the
    JAX package's row-major device order. Ranks sharing one card:
    ``devices=["cuda:0"] * n, backend="gloo"``; CPU ranks: ``["cpu"] * n``."""
    if tp < 1 or dp < 1:
        raise ValueError(f"a tensor-parallel mesh needs tp, dp >= 1, got tp={tp}, dp={dp}")
    return build_mesh({DATA_AXIS: dp, MODEL_AXIS: tp}, gpus() if devices is None else devices,
                      backend, timeout_s)


@dataclasses.dataclass(frozen=True)
class ServingMesh:
    """The generation engine's mesh: one ``"model"`` axis whose ranks
    each hold one device (``devices[r]`` is rank r's), and the transport
    their collectives run over."""

    devices: Tuple[torch.device, ...]
    backend: str

    axis_names = (MODEL_AXIS,)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> Dict[str, int]:
        return {MODEL_AXIS: self.size}


def serving_mesh(tp_degree: int, devices: Optional[Sequence] = None,
                 backend: Optional[str] = None) -> ServingMesh:
    """A ``"model"`` axis over the first ``tp_degree`` of ``devices``
    (default: the GPUs of this process; never the CPU unless listed).

    The transport is explicit: ``nccl`` is the default when the ranks sit
    on distinct GPUs and ``gloo`` the default on the CPU (CPU ranks are
    processes: list ``"cpu"`` once per rank). Ranks that share one GPU
    need ``backend="gloo"`` from the caller: NCCL cannot put two ranks of
    one communicator on one device, and no transport is switched
    quietly."""
    if tp_degree < 1:
        raise ValueError(f"tp_degree must be >= 1, got {tp_degree}")
    devices = gpus() if devices is None else [torch.device(d) for d in devices]
    if tp_degree > len(devices):
        raise ValueError(
            f"serving mesh needs {tp_degree} devices, have {len(devices)}"
        )
    use, backend = transport(devices[:tp_degree], backend, "serving mesh")
    return ServingMesh(use, backend)
