"""Keras optimizer wrappers (port of ``flexflow_tpu/frontends/keras/
optimizers.py``; reference: python/flexflow/keras/optimizers.py:18-60)."""
from __future__ import annotations

from ...runtime.optimizers import AdamOptimizer, SGDOptimizer


class Optimizer:
    lr: float = 0.01

    def to_ff(self):
        raise NotImplementedError


class SGD(Optimizer):
    """Reference: optimizers.py:26."""

    def __init__(self, learning_rate=0.01, momentum=0.0, nesterov=False, weight_decay=0.0):
        self.lr = learning_rate
        self.momentum = momentum
        self.nesterov = nesterov
        self.weight_decay = weight_decay

    def to_ff(self):
        return SGDOptimizer(lr=self.lr, momentum=self.momentum, nesterov=self.nesterov, weight_decay=self.weight_decay)


class Adam(Optimizer):
    """Reference: optimizers.py:40."""

    def __init__(self, learning_rate=0.001, beta_1=0.9, beta_2=0.999, epsilon=1e-8):
        self.lr = learning_rate
        self.beta1 = beta_1
        self.beta2 = beta_2
        self.epsilon = epsilon

    def to_ff(self):
        return AdamOptimizer(alpha=self.lr, beta1=self.beta1, beta2=self.beta2, epsilon=self.epsilon)
