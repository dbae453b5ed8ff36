"""Weights and inputs from the JAX package's side, as numpy arrays.

The JAX executor keys its parameters ``"{op_type}_{guid}"``; guids differ
between two builds of one model, layer names do not. Turn the JAX
parameters into ``{layer_name: {weight_name: numpy array}}`` on the JAX
side and hand that here: :func:`params_from_numpy` gives CPU tensors in
the same layouts, which ``FFModel.set_weights`` copies into the port's
executor. This module needs neither JAX nor the JAX package.

numpy has no bfloat16 of its own: JAX's bfloat16 arrays carry the
``ml_dtypes`` type, recognised here by its name (``ml_dtypes`` itself is
not imported, so the port runs where it is not installed) and carried
over bit for bit through a ``uint16`` view.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _is_bf16(arr) -> bool:
    return getattr(getattr(arr, "dtype", None), "name", "") == "bfloat16"


def _bf16_from_numpy(arr) -> torch.Tensor:
    """A bfloat16 numpy array as a bfloat16 CPU tensor with the same bits."""
    bits = np.ascontiguousarray(arr).view(np.uint16)
    return torch.from_numpy(bits.copy()).view(torch.bfloat16)


def to_tensor(x, device=None) -> torch.Tensor:
    """``x`` (a tensor, a numpy array or anything numpy takes) as a tensor
    on ``device``, in its own dtype; a bfloat16 numpy array stays
    bfloat16, bit for bit."""
    if isinstance(x, torch.Tensor):
        return x.to(device) if device is not None else x
    if _is_bf16(x):
        return _bf16_from_numpy(x).to(device)
    return torch.as_tensor(x, device=device)


def params_from_numpy(
    tree: Mapping[str, Mapping[str, Any]],
) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{layer_name: {weight_name: array}}`` as CPU tensors: bfloat16
    arrays stay bfloat16 (bit for bit), every other array becomes
    float32."""
    return {
        layer: {
            name: (_bf16_from_numpy(arr) if _is_bf16(arr)
                   else torch.from_numpy(np.array(arr, dtype=np.float32, copy=True)))
            for name, arr in weights.items()
        }
        for layer, weights in tree.items()
    }
