"""Weights from the JAX package's decoder pytree.

The JAX decoder's parameters are a nested dict/list pytree
(``flexflow_tpu.generation.decoder.init_decoder_params``). Turn its
leaves into numpy arrays on the JAX side
(``jax.tree.map(np.asarray, params)``) and hand the tree here: the port
gets the same weights, in the same layouts, as its own parameter
dictionary. This module needs neither JAX nor the JAX package.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .decoder import DecoderParams

_TOP_KEYS = ("tok_embed", "pos_embed", "final_ln_g", "final_ln_b", "lm_head")
_LAYER_KEYS = (
    "ln1_g", "ln1_b", "wq", "wk", "wv", "wo",
    "ln2_g", "ln2_b", "ff1", "ff1_b", "ff2", "ff2_b",
)


def _tensor(x: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def decoder_params_from_numpy(tree: Mapping[str, Any]) -> DecoderParams:
    """The port's decoder parameters (CPU tensors; the engine moves
    them to its device) from a JAX decoder pytree whose leaves are numpy
    arrays. Raises on a missing or unexpected key."""
    extra = set(tree) - set(_TOP_KEYS) - {"layers"}
    if extra:
        raise ValueError(f"unexpected decoder parameters {sorted(extra)}")
    params: DecoderParams = {k: _tensor(tree[k]) for k in _TOP_KEYS}
    layers = []
    for i, layer in enumerate(tree["layers"]):
        if set(layer) != set(_LAYER_KEYS):
            raise ValueError(
                f"layer {i} has parameters {sorted(layer)}, expected {sorted(_LAYER_KEYS)}"
            )
        layers.append({k: _tensor(layer[k]) for k in _LAYER_KEYS})
    params["layers"] = layers
    return params
