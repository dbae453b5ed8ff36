"""Device selection for the port's entry points.

Entry points run on the GPU unless the caller asks for the CPU: a
missing GPU is an error, never a silent switch to the CPU, so a run
that meant to measure the card cannot measure the host instead.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means ``cuda``. Raises when CUDA is asked for (or
    defaulted to) and no GPU is present; ``device="cpu"`` opts into the
    CPU, where every kernel wrapper takes its plain PyTorch version."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
