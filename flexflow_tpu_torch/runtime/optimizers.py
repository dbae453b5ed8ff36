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

The learning rate lives in ``opt_state["lr"]`` as a float32 scalar on
the parameters' device, which the update reads (the JAX package keeps it
in ``opt_state`` as a traced scalar): ``Executor.set_learning_rate``
writes it in place, so a captured CUDA graph of the step takes the new
rate with no re-capture. An update is split in two for such a graph:
:meth:`Optimizer.prepare` runs on the host before each step and writes
what depends on the step count into device scalars with ``fill_`` (no
host sync: Adam's bias-correction terms ``sqrt(1 - beta2^t)`` and
``1 - beta1^t``, computed in ``np.float32`` as before), and
:meth:`Optimizer.update` is the device work a graph captures. ``apply``
runs both and counts the step.
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


def _descend(p: torch.Tensor, step, direction: torch.Tensor) -> None:
    """``p = (p - step * direction).astype(p.dtype)`` with ``step`` a
    float32 scalar (a device scalar or a Python float holding a float32
    value): in float32, rounded once to p's dtype, in place."""
    p.copy_(p.float() - step * direction.float())


def _device_of(params: Params) -> torch.device:
    for _, _, p in _leaves(params):
        return p.device
    return torch.device("cpu")


def _scalar(value: float, params: Params) -> torch.Tensor:
    """A float32 scalar on the parameters' device."""
    return torch.full((), float(np.float32(value)), dtype=torch.float32,
                      device=_device_of(params))


class Optimizer:
    """Base optimizer (reference: Optimizer optimizer.h:36)."""

    def init_state(self, params: Params) -> Dict[str, Any]:
        raise NotImplementedError

    def prepare(self, opt_state) -> None:
        """Host work before a step: write the step's scalars into the
        state's device scalars (no host sync)."""

    def update(self, params: Params, grads: Params, opt_state) -> None:
        """The device work of one update, in place (what a CUDA graph of
        the step captures); the step count is not advanced."""
        raise NotImplementedError

    def apply(self, params: Params, grads: Params, opt_state) -> Tuple[Params, Dict[str, Any]]:
        """One update, in place; returns (params, opt_state), the same
        objects, for the JAX package's calling convention."""
        self.prepare(opt_state)
        self.update(params, grads, opt_state)
        opt_state["step"] += 1
        return params, opt_state


@dataclasses.dataclass
class SGDOptimizer(Optimizer):
    """Reference: SGDOptimizer (optimizer.h:51, optimizer.cc:90)."""

    lr: float = 0.01
    momentum: float = 0.0
    nesterov: bool = False
    weight_decay: float = 0.0

    def init_state(self, params: Params) -> Dict[str, Any]:
        v = _zeros_like(params) if self.momentum != 0.0 else None
        return {"v": v, "step": 0, "lr": _scalar(self.lr, params)}

    @torch.no_grad()
    def update(self, params: Params, grads: Params, opt_state) -> None:
        lr = opt_state["lr"]
        for key, name, p in _leaves(params):
            g = grads[key][name] + _weak(self.weight_decay, p) * p
            if self.momentum > 0.0:
                mom = _weak(self.momentum, p)
                v = opt_state["v"][key][name]
                v.mul_(mom).add_(g)
                g = g + mom * v if self.nesterov else v
            _descend(p, lr, g)


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
        # "bias": the coming step's sqrt(1 - beta2^t) and 1 - beta1^t
        return {"m": _zeros_like(params), "v": _zeros_like(params), "step": 0,
                "lr": _scalar(self.alpha, params),
                "bias": torch.zeros(2, dtype=torch.float32, device=_device_of(params))}

    def prepare(self, opt_state) -> None:
        # float32 throughout, as the JAX optimizer computes it from its
        # float32 lr and step
        one, tf = np.float32(1.0), np.float32(opt_state["step"] + 1)
        bias = opt_state["bias"]
        bias[0].fill_(float(np.sqrt(one - np.float32(self.beta2) ** tf)))
        bias[1].fill_(float(one - np.float32(self.beta1) ** tf))

    @torch.no_grad()
    def update(self, params: Params, grads: Params, opt_state) -> None:
        bias = opt_state["bias"]
        alpha_t = opt_state["lr"] * bias[0] / bias[1]
        for key, name, p in _leaves(params):
            g = grads[key][name] + _weak(self.weight_decay, p) * p
            m = opt_state["m"][key][name].mul_(_weak(self.beta1, p)).add_(
                _weak(1 - self.beta1, p) * g)
            v = opt_state["v"][key][name].mul_(_weak(self.beta2, p)).add_(
                _weak(1 - self.beta2, p) * g.square())
            _descend(p, 1.0, alpha_t * m.float() / (v.sqrt() + _weak(self.epsilon, p)).float())
