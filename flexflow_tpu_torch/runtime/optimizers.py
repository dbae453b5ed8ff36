"""Optimizers: SGD (momentum/nesterov) and Adam (port of
``flexflow_tpu/runtime/optimizers.py``).

The arithmetic is the JAX package's, but the update runs IN PLACE under
``torch.no_grad()``: ``apply`` overwrites the parameter tensors (and the
optimizer's moment tensors) instead of returning new ones, so a step
holds no second copy of the model. ``params``/``grads`` are the
executor's nested ``{node key: {weight name: tensor}}`` dictionaries.

Types follow JAX's promotion, so a bfloat16 parameter gets the JAX
update's bits: ``lr`` (and Adam's ``alpha_t``) is a strong float32
scalar in the JAX optimizers, so ``p - lr * g`` runs in float32 and is
rounded once to the parameter's dtype; the other constants (momentum,
betas, weight decay, epsilon) are weak Python scalars there, which take
the dtype of the tensor they meet, so they are rounded to it here
(:func:`_weak`) and the moment arithmetic runs, op by op, in the
parameter's dtype. That is ``apply`` of the JAX optimizers bit for bit;
inside a ``jax.jit`` XLA may keep a fused chain's intermediates in
float32 instead, which moves some bfloat16 Adam updates by one unit in
the last place.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

Params = Dict[str, Dict[str, torch.Tensor]]


def _leaves(tree: Params) -> Iterator[Tuple[str, str, torch.Tensor]]:
    for key in sorted(tree):
        for name in sorted(tree[key]):
            yield key, name, tree[key][name]


def _zeros_like(tree: Params) -> Params:
    return {k: {n: torch.zeros_like(t) for n, t in g.items()} for k, g in tree.items()}


def _weak(x: float, like: torch.Tensor) -> float:
    """``x`` as a weak-typed JAX scalar meeting ``like``: rounded to its
    dtype (a no-op for float32, where PyTorch rounds the scalar alike)."""
    return _rounded(float(x), like.dtype)


@functools.lru_cache(maxsize=None)
def _rounded(x: float, dtype: torch.dtype) -> float:
    return float(torch.tensor(x, dtype=dtype))


def _descend(p: torch.Tensor, step: float, direction: torch.Tensor) -> None:
    """``p = (p - step * direction).astype(p.dtype)`` with ``step`` a
    float32 scalar: in float32, rounded once to p's dtype, in place."""
    p.copy_(p.float() - step * direction.float())


class Optimizer:
    """Base optimizer (reference: Optimizer optimizer.h:36)."""

    def init_state(self, params: Params) -> Dict[str, Any]:
        raise NotImplementedError

    def apply(self, params: Params, grads: Params, opt_state) -> Tuple[Params, Dict[str, Any]]:
        """One update, in place; returns (params, opt_state), the same
        objects, for the JAX package's calling convention."""
        raise NotImplementedError


@dataclasses.dataclass
class SGDOptimizer(Optimizer):
    """Reference: SGDOptimizer (optimizer.h:51, optimizer.cc:90)."""

    lr: float = 0.01
    momentum: float = 0.0
    nesterov: bool = False
    weight_decay: float = 0.0

    def init_state(self, params: Params) -> Dict[str, Any]:
        v = _zeros_like(params) if self.momentum != 0.0 else None
        return {"v": v, "step": 0, "lr": float(self.lr)}

    @torch.no_grad()
    def apply(self, params: Params, grads: Params, opt_state):
        lr = float(np.float32(opt_state["lr"]))
        for key, name, p in _leaves(params):
            g = grads[key][name] + _weak(self.weight_decay, p) * p
            if self.momentum > 0.0:
                mom = _weak(self.momentum, p)
                v = opt_state["v"][key][name]
                v.mul_(mom).add_(g)
                g = g + mom * v if self.nesterov else v
            _descend(p, lr, g)
        opt_state["step"] += 1
        return params, opt_state


@dataclasses.dataclass
class AdamOptimizer(Optimizer):
    """Reference: AdamOptimizer (optimizer.h:77, optimizer.cc:379), with
    its bias correction alpha_t = alpha * sqrt(1 - beta2^t) / (1 - beta1^t)."""

    alpha: float = 0.001
    beta1: float = 0.9
    beta2: float = 0.999
    weight_decay: float = 0.0
    epsilon: float = 1e-8

    def init_state(self, params: Params) -> Dict[str, Any]:
        return {"m": _zeros_like(params), "v": _zeros_like(params), "step": 0,
                "lr": float(self.alpha)}

    @torch.no_grad()
    def apply(self, params: Params, grads: Params, opt_state):
        t = opt_state["step"] + 1
        # float32 throughout, as the JAX optimizer computes it from its
        # float32 lr and step
        one, tf = np.float32(1.0), np.float32(t)
        alpha_t = float(np.float32(opt_state["lr"]) * np.sqrt(one - np.float32(self.beta2) ** tf)
                        / (one - np.float32(self.beta1) ** tf))
        for key, name, p in _leaves(params):
            g = grads[key][name] + _weak(self.weight_decay, p) * p
            m = opt_state["m"][key][name].mul_(_weak(self.beta1, p)).add_(
                _weak(1 - self.beta1, p) * g)
            v = opt_state["v"][key][name].mul_(_weak(self.beta2, p)).add_(
                _weak(1 - self.beta2, p) * g.square())
            _descend(p, 1.0, alpha_t * m.float() / (v.sqrt() + _weak(self.epsilon, p)).float())
        opt_state["step"] = t
        return params, opt_state
