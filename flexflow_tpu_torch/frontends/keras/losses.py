"""Keras loss wrappers (port of ``flexflow_tpu/frontends/keras/losses.py``;
reference: python/flexflow/keras/losses.py:18-55)."""
from __future__ import annotations

from ...core.types import LossType


class Loss:
    loss_type: LossType

    def __init__(self, name: str = ""):
        self.name = name or type(self).__name__


class CategoricalCrossentropy(Loss):
    loss_type = LossType.CATEGORICAL_CROSSENTROPY


class SparseCategoricalCrossentropy(Loss):
    loss_type = LossType.SPARSE_CATEGORICAL_CROSSENTROPY


class MeanSquaredError(Loss):
    loss_type = LossType.MEAN_SQUARED_ERROR


class Identity(Loss):
    loss_type = LossType.IDENTITY


_LOSS_BY_NAME = {
    "categorical_crossentropy": CategoricalCrossentropy(),
    "sparse_categorical_crossentropy": SparseCategoricalCrossentropy(),
    "mean_squared_error": MeanSquaredError(),
    "mse": MeanSquaredError(),
    "identity": Identity(),
}
