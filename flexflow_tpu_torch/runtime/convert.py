"""Weights and inputs from the JAX package's side, as numpy arrays.

The JAX executor keys its parameters ``"{op_type}_{guid}"``; guids differ
between two builds of one model, layer names do not. Turn the JAX
parameters into ``{layer_name: {weight_name: numpy array}}`` on the JAX
side and hand that here: :func:`params_from_numpy` gives CPU tensors in
the same layouts, which ``FFModel.set_weights`` copies into the port's
executor. The JAX executor's ``state`` (BatchNorm's running statistics)
crosses the same way, and its ``opt_state`` through
:func:`opt_state_from_numpy` (the moments ``v`` and ``m`` by layer name,
as the JAX checkpoint's ``_opt_rekey`` renames them, and the step and
learning rate), so a JAX run continues in the port where it stopped.
This module needs neither JAX nor the JAX package.

numpy has no bfloat16 of its own: JAX's bfloat16 arrays carry the
``ml_dtypes`` type, recognised here by its name (``ml_dtypes`` itself is
not imported, so the port runs where it is not installed) and carried
over bit for bit through a ``uint16`` view. float16 arrays are numpy's
own and come across as float16, bit for bit.
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
    and float16 arrays keep their type (bit for bit), every other array
    becomes float32."""
    def one(arr) -> torch.Tensor:
        if _is_bf16(arr):
            return _bf16_from_numpy(arr)
        keep = np.float16 if np.asarray(arr).dtype == np.float16 else np.float32
        return torch.from_numpy(np.array(arr, dtype=keep, copy=True))

    return {layer: {name: one(arr) for name, arr in weights.items()}
            for layer, weights in tree.items()}


def opt_state_from_numpy(tree: Mapping[str, Any]) -> Dict[str, Any]:
    """An optimizer state ``{"v": {layer: {weight: array}} or None,
    "m": ... (Adam), "step": int, "lr": float}`` with its moments as CPU
    tensors (:func:`params_from_numpy`) and its scalars as Python
    numbers, for ``FFModel.set_weights(..., opt_state=...)``."""
    out: Dict[str, Any] = {"step": int(np.asarray(tree["step"])),
                           "lr": float(np.asarray(tree["lr"]))}
    for field in ("v", "m"):
        if field in tree:
            out[field] = None if tree[field] is None else params_from_numpy(tree[field])
    return out
