"""Keras metric wrappers (port of ``flexflow_tpu/frontends/keras/
metrics.py``; reference: python/flexflow/keras/metrics.py:18-69)."""
from __future__ import annotations

from ...core.types import MetricsType


class Metric:
    metrics_type: MetricsType

    def __init__(self, name: str = ""):
        self.name = name or type(self).__name__


class Accuracy(Metric):
    metrics_type = MetricsType.ACCURACY


class CategoricalCrossentropy(Metric):
    metrics_type = MetricsType.CATEGORICAL_CROSSENTROPY


class SparseCategoricalCrossentropy(Metric):
    metrics_type = MetricsType.SPARSE_CATEGORICAL_CROSSENTROPY


class MeanSquaredError(Metric):
    metrics_type = MetricsType.MEAN_SQUARED_ERROR


class RootMeanSquaredError(Metric):
    metrics_type = MetricsType.ROOT_MEAN_SQUARED_ERROR


class MeanAbsoluteError(Metric):
    metrics_type = MetricsType.MEAN_ABSOLUTE_ERROR


_METRIC_BY_NAME = {
    "accuracy": Accuracy(),
    "categorical_crossentropy": CategoricalCrossentropy(),
    "sparse_categorical_crossentropy": SparseCategoricalCrossentropy(),
    "mean_squared_error": MeanSquaredError(),
    "mse": MeanSquaredError(),
    "root_mean_squared_error": RootMeanSquaredError(),
    "mean_absolute_error": MeanAbsoluteError(),
    "mae": MeanAbsoluteError(),
}
