"""Mesh axis names and the device-count check (port of the axis names
and ``build_mesh``'s check from ``flexflow_tpu/parallel/mesh.py``).

A strategy names its parallelism kinds by mesh axis:
  "data"    -- batch/sample parallelism (reference: DP)
  "model"   -- tensor/parameter parallelism (reference: TP)
  "seq"     -- sequence/context parallelism
  "expert"  -- expert parallelism for MoE
  "pipe"    -- pipeline stages
Unused axes have size 1 and are dropped.

The port executes on one device: :func:`build_mesh` checks that the
devices it is given cover the strategy's axes and raises the JAX
package's error otherwise; it returns the axes of size > 1. The
``torch.distributed`` device mesh that would place shards over several
GPUs waits for the multi-GPU slice (ROADMAP queue 1, item 5).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

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
