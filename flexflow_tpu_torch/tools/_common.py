"""What the port's serving tools share: their output directory, the
virtual clock they drive schedulers on, the seeded decoder weights of
their in-process engines, the ranks of their tensor-parallel engines,
and the history line's stamps.

The tools write their default outputs (bench artifacts, the bench
history, simfleet's reports) into :data:`OUT_DIR`, a git-ignored
directory beside the checkout's files, never over the JAX package's
tracked ``BENCH_GEN.json`` / ``SIM_*.json``.
"""
from __future__ import annotations

import math
import os
import subprocess
from typing import Optional, Sequence

# default output directory of every port tool (git-ignored)
OUT_DIR = "torch_tools_out"

DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
# the canned overload storm (a byte-for-byte copy of the JAX package's
# tests/data/storm_schedule.json; a test holds the two equal)
STORM_SCHEDULE = os.path.join(DATA_DIR, "storm_schedule.json")


def out_path(name: str) -> str:
    """``OUT_DIR/name``, creating the directory."""
    os.makedirs(OUT_DIR, exist_ok=True)
    return os.path.join(OUT_DIR, name)


class Clock:
    """A virtual clock (callable, with ``advance``) for deterministic
    scheduler drives."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def seeded_params(cfg, seed: int = 0, device=None):
    """Decoder weights of ``cfg`` from ``torch.Generator().manual_seed(seed)``
    (the port's own draws: a comparison with the JAX package passes its
    weights through ``decoder_params_from_numpy`` instead)."""
    import torch

    from flexflow_tpu_torch.generation import init_decoder_params
    from flexflow_tpu_torch.generation.decoder import params_to

    params = init_decoder_params(torch.Generator().manual_seed(seed), cfg)
    return params if device is None else params_to(params, device)


def tool_mesh(n: int, device=None, devices: Optional[Sequence] = None,
              backend: Optional[str] = None):
    """The ranks of a tool's tp=N engine (the port's counterpart of the
    JAX tools' ``_meshenv.py``, which forces N host devices): ``devices``,
    or N CPU ranks for ``device="cpu"``, or the first N GPUs; over
    ``backend`` (default: gloo on the CPU, nccl on distinct GPUs; ranks
    sharing a GPU must name gloo). Returns the ``ServingMesh``."""
    from flexflow_tpu_torch.parallel.mesh import serving_mesh

    if devices is None and device == "cpu":
        devices = ["cpu"] * n
    return serving_mesh(n, devices, backend=backend or None)


def backend(device) -> str:
    """The history line's backend: ``gpu`` for a CUDA engine, else ``cpu``."""
    import torch

    return "gpu" if torch.device(device or "cuda").type == "cuda" else "cpu"


def pct(xs: Sequence[float], p: float) -> Optional[float]:
    """Nearest-rank percentile (``None`` for no samples)."""
    if not xs:
        return None
    xs = sorted(xs)
    return xs[min(len(xs) - 1, math.ceil(p * len(xs)) - 1)]


def git_sha() -> str:
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=10,
        ).stdout.strip()
        return out or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"
