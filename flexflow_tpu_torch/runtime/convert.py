"""Weights from the JAX package's executor.

The JAX executor keys its parameters ``"{op_type}_{guid}"``; guids differ
between two builds of one model, layer names do not. Turn the JAX
parameters into ``{layer_name: {weight_name: numpy array}}`` on the JAX
side and hand that here: :func:`params_from_numpy` gives CPU tensors in
the same layouts, which ``FFModel.set_weights`` copies into the port's
executor. This module needs neither JAX nor the JAX package.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def params_from_numpy(
    tree: Mapping[str, Mapping[str, Any]],
) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{layer_name: {weight_name: array}}`` as float32 CPU tensors."""
    return {
        layer: {
            name: torch.from_numpy(np.array(arr, dtype=np.float32, copy=True))
            for name, arr in weights.items()
        }
        for layer, weights in tree.items()
    }
