"""Keras initializers (port of ``flexflow_tpu/frontends/keras/
initializers.py``; reference: python/flexflow/keras/initializers.py:18-56).

Names map onto the initializer registry in runtime/initializers.py.
"""
from __future__ import annotations


class Initializer:
    ff_name = "glorot_uniform"


class DefaultInitializer(Initializer):
    ff_name = "glorot_uniform"


class Zeros(Initializer):
    ff_name = "zeros"


class GlorotUniform(Initializer):
    ff_name = "glorot_uniform"


class RandomUniform(Initializer):
    def __init__(self, minval=-0.05, maxval=0.05, seed=None):
        self.minval, self.maxval, self.seed = minval, maxval, seed

    ff_name = "uniform"


class RandomNormal(Initializer):
    def __init__(self, mean=0.0, stddev=0.05, seed=None):
        self.mean, self.stddev, self.seed = mean, stddev, seed

    ff_name = "normal"
