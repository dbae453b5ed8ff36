"""Mesh axis names and the device-count check (port of the axis names
and ``build_mesh``'s check from ``flexflow_tpu/parallel/mesh.py``).

A strategy names its parallelism kinds by mesh axis:
  "data"    -- batch/sample parallelism (reference: DP)
  "model"   -- tensor/parameter parallelism (reference: TP)
  "seq"     -- sequence/context parallelism
  "expert"  -- expert parallelism for MoE
  "pipe"    -- pipeline stages
Unused axes have size 1 and are dropped.

A training strategy executes on one device: :func:`build_mesh` checks
that the devices it is given cover the strategy's axes and raises the
JAX package's error otherwise; it returns the axes of size > 1. The
``torch.distributed`` device mesh that would place a training strategy's
shards over several GPUs waits for the multi-GPU training slice (ROADMAP
queue 1, item 5).

The generation engine's serving mesh (:func:`serving_mesh`) is a
``"model"`` axis over one device per rank of a tensor-parallel group
(``parallel/distributed.py``): the devices of the ranks and the
collectives' transport.
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


def available_devices() -> List[torch.device]:
    """The GPUs of this process, or the CPU when there is none."""
    if torch.cuda.is_available():
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def build_mesh(axis_sizes: Dict[str, int],
               devices: Optional[Sequence] = None) -> Dict[str, int]:
    """The mesh's named axes (sizes > 1; ``{"data": 1}`` when none is)
    after checking that ``devices`` (default: :func:`available_devices`)
    hold as many devices as their product, with the JAX package's
    ``ValueError("mesh needs N devices, have M")``."""
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
    return sizes


# the collectives' transports a serving mesh may name
BACKENDS = ("gloo", "nccl")


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
    if devices is None:
        n_gpu = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [torch.device("cuda", i) for i in range(n_gpu)]
    devices = [torch.device(d) for d in devices]
    if tp_degree > len(devices):
        raise ValueError(
            f"serving mesh needs {tp_degree} devices, have {len(devices)}"
        )
    use = tuple(devices[:tp_degree])
    types = {d.type for d in use}
    if len(types) != 1 or types - {"cpu", "cuda"}:
        raise ValueError(f"a serving mesh's ranks all sit on cuda or all on cpu, got {use}")
    if backend is not None and backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if "cpu" in types:
        if backend == "nccl":
            raise ValueError("backend='nccl' needs CUDA devices; CPU ranks use backend='gloo'")
        return ServingMesh(use, "gloo")
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
    return ServingMesh(use, backend)
