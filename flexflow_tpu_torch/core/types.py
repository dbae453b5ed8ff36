"""Core enums (port of ``flexflow_tpu/core/types.py``).

Only the members the ported slices use: float32 parameters, activations
and KV cache (the JAX default), int32 tokens, positions and block tables,
int64 for the sampler's emulated uint32 words; the five op types of the
BERT-style training graph and the activation, loss, metric and
compilation modes around them.
"""
from __future__ import annotations

import enum

import torch


class DataType(enum.Enum):
    """Tensor element types (reference: ffconst.h DataType)."""

    INT32 = "int32"
    INT64 = "int64"
    FLOAT = "float32"

    @property
    def torch(self) -> torch.dtype:
        return getattr(torch, self.value)

    @property
    def size_bytes(self) -> int:
        return torch.empty((), dtype=self.torch).element_size()


class ActiMode(enum.Enum):
    """Fused activation modes (reference: ffconst.h ActiMode)."""

    NONE = "none"
    RELU = "relu"
    SIGMOID = "sigmoid"
    TANH = "tanh"
    GELU = "gelu"


class LossType(enum.Enum):
    """Loss functions (reference: include/flexflow/loss_functions.h:27)."""

    CATEGORICAL_CROSSENTROPY = "categorical_crossentropy"
    SPARSE_CATEGORICAL_CROSSENTROPY = "sparse_categorical_crossentropy"
    MEAN_SQUARED_ERROR = "mean_squared_error"
    MEAN_SQUARED_ERROR_AVG_REDUCE = "mean_squared_error_avg_reduce"
    MEAN_SQUARED_ERROR_SUM_REDUCE = "mean_squared_error_sum_reduce"
    IDENTITY = "identity"


class MetricsType(enum.Enum):
    """Metrics (reference: include/flexflow/metrics_functions.h:27)."""

    ACCURACY = "accuracy"
    CATEGORICAL_CROSSENTROPY = "categorical_crossentropy"
    SPARSE_CATEGORICAL_CROSSENTROPY = "sparse_categorical_crossentropy"
    MEAN_SQUARED_ERROR = "mean_squared_error"
    ROOT_MEAN_SQUARED_ERROR = "root_mean_squared_error"
    MEAN_ABSOLUTE_ERROR = "mean_absolute_error"


class CompMode(enum.Enum):
    """Compilation mode (reference: ffconst.h:41-44)."""

    TRAINING = "training"
    INFERENCE = "inference"


class OpType(enum.Enum):
    """The operators of the ported training graph (values as in the JAX
    package, so node keys read the same in both)."""

    INPUT = "input"
    LINEAR = "linear"
    MULTIHEAD_ATTENTION = "multihead_attention"
    LAYERNORM = "layer_norm"
    EW_ADD = "add"
