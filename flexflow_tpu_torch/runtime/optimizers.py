"""Optimizers: SGD (momentum/nesterov) and Adam (port of
``flexflow_tpu/runtime/optimizers.py``).

The arithmetic is the JAX package's, but the update runs IN PLACE under
``torch.no_grad()``: ``apply`` overwrites the parameter tensors (and the
optimizer's moment tensors) instead of returning new ones, so a step
holds no second copy of the model. ``params``/``grads`` are the
executor's nested ``{node key: {weight name: tensor}}`` dictionaries.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, Tuple

import torch

Params = Dict[str, Dict[str, torch.Tensor]]


def _leaves(tree: Params) -> Iterator[Tuple[str, str, torch.Tensor]]:
    for key in sorted(tree):
        for name in sorted(tree[key]):
            yield key, name, tree[key][name]


def _zeros_like(tree: Params) -> Params:
    return {k: {n: torch.zeros_like(t) for n, t in g.items()} for k, g in tree.items()}


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
        lr = opt_state["lr"]
        for key, name, p in _leaves(params):
            g = grads[key][name] + self.weight_decay * p
            if self.momentum > 0.0:
                v = opt_state["v"][key][name]
                v.mul_(self.momentum).add_(g)
                g = g + self.momentum * v if self.nesterov else v
            p.sub_(lr * g)
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
        alpha_t = opt_state["lr"] * (1.0 - self.beta2**t) ** 0.5 / (1.0 - self.beta1**t)
        for key, name, p in _leaves(params):
            g = grads[key][name] + self.weight_decay * p
            m = opt_state["m"][key][name].mul_(self.beta1).add_((1 - self.beta1) * g)
            v = opt_state["v"][key][name].mul_(self.beta2).add_((1 - self.beta2) * g.square())
            p.sub_(alpha_t * m / (v.sqrt() + self.epsilon))
        opt_state["step"] = t
        return params, opt_state
