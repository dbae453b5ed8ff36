"""flexflow_tpu_torch.frontends.keras: the tf.keras-style frontend (port
of ``flexflow_tpu/frontends/keras``).

Reference: python/flexflow/keras/ (~4000 LoC): Sequential and functional
Model over the FFModel graph API. Importable as
``from flexflow_tpu_torch.frontends import keras`` with the usual
``keras.layers`` / ``keras.models`` / ... submodule layout. A model
trains on the GPU unless ``compile(..., device="cpu")``.
"""
from . import callbacks, datasets, initializers, layers, losses, metrics, models, optimizers
from .layers import (
    Activation,
    Add,
    AveragePooling2D,
    BatchNormalization,
    Concatenate,
    Conv2D,
    Dense,
    Dropout,
    Embedding,
    Flatten,
    Input,
    InputLayer,
    LayerNormalization,
    Maximum,
    MaxPooling2D,
    Minimum,
    Multiply,
    Permute,
    Reshape,
    Subtract,
    add,
    concatenate,
    multiply,
    subtract,
)
from .models import Model, Sequential
from .optimizers import SGD, Adam
from .tensor import KerasTensor

__all__ = [
    "Model",
    "Sequential",
    "Input",
    "KerasTensor",
    "SGD",
    "Adam",
    "layers",
    "models",
    "optimizers",
    "losses",
    "metrics",
    "callbacks",
    "initializers",
    "datasets",
]
