"""Keras-style layers (port of ``flexflow_tpu/frontends/keras/layers.py``).

Reference: python/flexflow/keras/layers/ (base_layer.py:20 Layer,
core.py Dense/Flatten/Embedding/Activation/Dropout/Reshape/Permute,
convolutional.py Conv2D, pool.py MaxPooling2D/AveragePooling2D,
merge.py Concatenate/Add/Subtract/Multiply/Maximum/Minimum,
normalization.py BatchNormalization, input_layer.py Input).

Each layer is symbolic: __call__ records DAG edges and infers the output
shape; ``build_ff(ffmodel, inputs)`` replays it into FFModel layer
calls at compile time. Layout is NCHW like the reference's Keras.
"""
from __future__ import annotations

import collections
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ...core.types import ActiMode, DataType, PoolType
from .tensor import KerasTensor, to_datatype

_ACTIVATIONS = {
    None: None,
    "linear": None,
    "relu": "relu",
    "sigmoid": "sigmoid",
    "tanh": "tanh",
    "elu": "elu",
    "gelu": "gelu",
    "softmax": "softmax",
}

_name_counters: collections.defaultdict = collections.defaultdict(int)


def _out_and_pads(in_hw, kernel, strides, padding):
    """Keras output-size/padding semantics for conv/pool.

    'same' -> out = ceil(in/stride), total pad (out-1)*s + k - in split
    with the extra row/col at the end like tf.keras; 'valid' -> no pad.
    Returns (oh, ow, pad_h, pad_w) where each pad is a (before, after)
    pair accepted by Conv2DParams/Pool2DParams.
    """
    if isinstance(padding, (tuple, list)):
        ph, pw = [(p, p) if isinstance(p, int) else tuple(p) for p in padding]
    elif padding == "same":
        oh = -(-in_hw[0] // strides[0])
        ow = -(-in_hw[1] // strides[1])
        th = max((oh - 1) * strides[0] + kernel[0] - in_hw[0], 0)
        tw = max((ow - 1) * strides[1] + kernel[1] - in_hw[1], 0)
        return oh, ow, (th // 2, th - th // 2), (tw // 2, tw - tw // 2)
    else:
        ph, pw = (0, 0), (0, 0)
    oh = (in_hw[0] + ph[0] + ph[1] - kernel[0]) // strides[0] + 1
    ow = (in_hw[1] + pw[0] + pw[1] - kernel[1]) // strides[1] + 1
    return oh, ow, ph, pw


def _auto_name(prefix: str) -> str:
    _name_counters[prefix] += 1
    return f"{prefix}_{_name_counters[prefix]}"


class Layer:
    """Reference: base_layer.py:20."""

    prefix = "layer"

    def __init__(self, name: Optional[str] = None, **kwargs):
        self.name = name or _auto_name(self.prefix)
        self.inbound: List[KerasTensor] = []
        self.outbound: List[KerasTensor] = []
        # set by Sequential when a layer declares input_shape
        self.input_shape_arg: Optional[Tuple[int, ...]] = kwargs.pop("input_shape", None)

    # -- symbolic call ------------------------------------------------
    def __call__(self, inputs):
        if self.inbound:
            # each call site would need its own PCG node but share weights,
            # which the PCG has no aliasing mechanism for yet
            raise NotImplementedError(
                f"layer {self.name} called twice: shared layers are not supported; "
                "create a new layer instance per call site"
            )
        ins = list(inputs) if isinstance(inputs, (list, tuple)) else [inputs]
        self.inbound = ins
        out_shapes = self.compute_output_shape([t.batch_shape for t in ins])
        dtype = self.output_dtype(ins)
        self.outbound = [
            KerasTensor(s, dtype, from_layer=self, output_index=i, name=f"{self.name}:{i}")
            for i, s in enumerate(out_shapes)
        ]
        return self.outbound[0] if len(self.outbound) == 1 else self.outbound

    def output_dtype(self, inputs: List[KerasTensor]) -> DataType:
        return inputs[0].dtype

    def compute_output_shape(self, in_shapes) -> List[Tuple]:
        raise NotImplementedError

    def build_ff(self, ffmodel, inputs):
        """Replay into FFModel; returns list of ff Tensors."""
        raise NotImplementedError

    # weight access post-compile (reference: Layer.get_weights via
    # ffmodel.get_layer_by_name + get_weight_tensor)
    def get_weights(self, model):
        return model.get_layer_weights(self.name)

    def __repr__(self):
        return f"<{type(self).__name__} {self.name}>"


class InputLayer(Layer):
    """Reference: input_layer.py:22."""

    prefix = "input"

    def __init__(self, shape=None, batch_size=None, dtype=None, name=None):
        super().__init__(name=name)
        self.shape_no_batch = tuple(shape)
        self.dtype = to_datatype(dtype)
        self.batch_size = batch_size
        self.outbound = [
            KerasTensor((batch_size,) + self.shape_no_batch, self.dtype, from_layer=self, name=self.name)
        ]

    def compute_output_shape(self, in_shapes):
        return [(self.batch_size,) + self.shape_no_batch]

    def build_ff(self, ffmodel, inputs):
        bs = ffmodel.config.batch_size
        return [ffmodel.create_tensor((bs,) + self.shape_no_batch, dtype=self.dtype, name=self.name)]


def Input(shape=None, batch_size=None, dtype=None, name=None) -> KerasTensor:
    """Reference: input_layer.py:43."""
    return InputLayer(shape=shape, batch_size=batch_size, dtype=dtype, name=name).outbound[0]


class Dense(Layer):
    """Reference: core.py:25."""

    prefix = "dense"

    def __init__(self, units, activation=None, use_bias=True, kernel_initializer="glorot_uniform", name=None, **kw):
        super().__init__(name=name, **kw)
        self.units = int(units)
        self.activation = _ACTIVATIONS[activation] if isinstance(activation, (str, type(None))) else activation
        self.use_bias = use_bias
        self.kernel_initializer = kernel_initializer

    def compute_output_shape(self, in_shapes):
        (s,) = in_shapes
        return [s[:-1] + (self.units,)]

    def build_ff(self, ffmodel, inputs):
        act = {
            None: ActiMode.NONE,
            "relu": ActiMode.RELU,
            "sigmoid": ActiMode.SIGMOID,
            "tanh": ActiMode.TANH,
            "gelu": ActiMode.GELU,
        }.get(self.activation, ActiMode.NONE)
        init = self.kernel_initializer
        if not isinstance(init, str):  # keras.initializers.Initializer instance
            init = init.ff_name
        out = ffmodel.dense(
            inputs[0], self.units, activation=act, use_bias=self.use_bias, kernel_initializer=init, name=self.name
        )
        if self.activation == "softmax":
            out = ffmodel.softmax(out, name=self.name + "_softmax")
        elif self.activation == "elu":
            out = ffmodel.elu(out, name=self.name + "_elu")
        return [out]


class Conv2D(Layer):
    """Reference: convolutional.py:25. NCHW."""

    prefix = "conv2d"

    def __init__(
        self,
        filters,
        kernel_size,
        strides=(1, 1),
        padding="valid",
        activation=None,
        groups=1,
        use_bias=True,
        name=None,
        **kw,
    ):
        super().__init__(name=name, **kw)
        self.filters = int(filters)
        self.kernel = (kernel_size, kernel_size) if isinstance(kernel_size, int) else tuple(kernel_size)
        self.strides = (strides, strides) if isinstance(strides, int) else tuple(strides)
        self.padding = padding
        self.activation = _ACTIVATIONS[activation] if isinstance(activation, (str, type(None))) else activation
        self.groups = groups
        self.use_bias = use_bias

    def compute_output_shape(self, in_shapes):
        (s,) = in_shapes
        n, c, h, w = s
        oh, ow, _, _ = _out_and_pads((h, w), self.kernel, self.strides, self.padding)
        return [(n, self.filters, oh, ow)]

    def build_ff(self, ffmodel, inputs):
        h, w = inputs[0].shape[2], inputs[0].shape[3]
        _, _, ph, pw = _out_and_pads((h, w), self.kernel, self.strides, self.padding)
        act = {None: ActiMode.NONE, "relu": ActiMode.RELU, "sigmoid": ActiMode.SIGMOID, "tanh": ActiMode.TANH}.get(
            self.activation, ActiMode.NONE
        )
        out = ffmodel.conv2d(
            inputs[0],
            self.filters,
            self.kernel[0],
            self.kernel[1],
            self.strides[0],
            self.strides[1],
            ph,
            pw,
            activation=act,
            groups=self.groups,
            use_bias=self.use_bias,
            name=self.name,
        )
        return [out]


class Pooling2D(Layer):
    """Reference: pool.py:24."""

    prefix = "pool2d"
    pool_type = PoolType.MAX

    def __init__(self, pool_size=(2, 2), strides=None, padding="valid", name=None, **kw):
        super().__init__(name=name, **kw)
        self.pool_size = (pool_size, pool_size) if isinstance(pool_size, int) else tuple(pool_size)
        strides = strides if strides is not None else self.pool_size
        self.strides = (strides, strides) if isinstance(strides, int) else tuple(strides)
        self.padding = padding

    def compute_output_shape(self, in_shapes):
        (s,) = in_shapes
        n, c, h, w = s
        oh, ow, _, _ = _out_and_pads((h, w), self.pool_size, self.strides, self.padding)
        return [(n, c, oh, ow)]

    def build_ff(self, ffmodel, inputs):
        h, w = inputs[0].shape[2], inputs[0].shape[3]
        _, _, ph, pw = _out_and_pads((h, w), self.pool_size, self.strides, self.padding)
        out = ffmodel.pool2d(
            inputs[0],
            self.pool_size[0],
            self.pool_size[1],
            self.strides[0],
            self.strides[1],
            ph,
            pw,
            pool_type=self.pool_type,
            name=self.name,
        )
        return [out]


class MaxPooling2D(Pooling2D):
    pool_type = PoolType.MAX


class AveragePooling2D(Pooling2D):
    pool_type = PoolType.AVG


class Flatten(Layer):
    """Reference: core.py:124."""

    prefix = "flatten"

    def compute_output_shape(self, in_shapes):
        (s,) = in_shapes
        return [(s[0], int(np.prod([d for d in s[1:]])))]

    def build_ff(self, ffmodel, inputs):
        return [ffmodel.flat(inputs[0], name=self.name)]


class Embedding(Layer):
    """Reference: core.py:160."""

    prefix = "embedding"

    def __init__(self, input_dim, output_dim, name=None, **kw):
        super().__init__(name=name, **kw)
        self.input_dim = int(input_dim)
        self.output_dim = int(output_dim)

    def output_dtype(self, inputs):
        return DataType.FLOAT

    def compute_output_shape(self, in_shapes):
        (s,) = in_shapes
        return [s + (self.output_dim,)]

    def build_ff(self, ffmodel, inputs):
        return [ffmodel.embedding(inputs[0], self.input_dim, self.output_dim, name=self.name)]


class Activation(Layer):
    """Reference: core.py:209."""

    prefix = "activation"

    def __init__(self, activation, name=None, **kw):
        super().__init__(name=name, **kw)
        self.activation = activation

    def compute_output_shape(self, in_shapes):
        return [in_shapes[0]]

    def build_ff(self, ffmodel, inputs):
        fn = {
            "relu": ffmodel.relu,
            "sigmoid": ffmodel.sigmoid,
            "tanh": ffmodel.tanh,
            "elu": ffmodel.elu,
            "gelu": ffmodel.gelu,
            "softmax": ffmodel.softmax,
            "linear": ffmodel.identity,
        }[self.activation]
        return [fn(inputs[0], name=self.name)]


class Dropout(Layer):
    """Reference: core.py:239."""

    prefix = "dropout"

    def __init__(self, rate, seed=0, name=None, **kw):
        super().__init__(name=name, **kw)
        self.rate = float(rate)
        self.seed = seed

    def compute_output_shape(self, in_shapes):
        return [in_shapes[0]]

    def build_ff(self, ffmodel, inputs):
        return [ffmodel.dropout(inputs[0], self.rate, seed=self.seed, name=self.name)]


class Reshape(Layer):
    """Reference: core.py:271. target_shape excludes the batch dim."""

    prefix = "reshape"

    def __init__(self, target_shape, name=None, **kw):
        super().__init__(name=name, **kw)
        self.target_shape = tuple(target_shape)

    def compute_output_shape(self, in_shapes):
        return [(in_shapes[0][0],) + self.target_shape]

    def build_ff(self, ffmodel, inputs):
        bs = ffmodel.config.batch_size
        return [ffmodel.reshape(inputs[0], (bs,) + self.target_shape, name=self.name)]


class Permute(Layer):
    """Reference: core.py:302. dims are 1-indexed over non-batch dims."""

    prefix = "permute"

    def __init__(self, dims, name=None, **kw):
        super().__init__(name=name, **kw)
        self.dims = tuple(dims)

    def compute_output_shape(self, in_shapes):
        (s,) = in_shapes
        return [(s[0],) + tuple(s[d] for d in self.dims)]

    def build_ff(self, ffmodel, inputs):
        perm = (0,) + self.dims
        return [ffmodel.transpose(inputs[0], perm, name=self.name)]


class _Merge(Layer):
    """Reference: merge.py:23."""

    prefix = "merge"

    def compute_output_shape(self, in_shapes):
        return [in_shapes[0]]


class Concatenate(_Merge):
    """Reference: merge.py:66."""

    prefix = "concatenate"

    def __init__(self, axis=1, name=None, **kw):
        super().__init__(name=name, **kw)
        self.axis = axis

    def compute_output_shape(self, in_shapes):
        out = list(in_shapes[0])
        out[self.axis] = sum(s[self.axis] for s in in_shapes)
        return [tuple(out)]

    def build_ff(self, ffmodel, inputs):
        return [ffmodel.concat(list(inputs), self.axis, name=self.name)]


def concatenate(input_tensors, axis=1):
    return Concatenate(axis=axis)(input_tensors)


class Add(_Merge):
    prefix = "add"

    def build_ff(self, ffmodel, inputs):
        return [ffmodel.add(inputs[0], inputs[1], name=self.name)]


def add(input_tensors):
    return Add()(input_tensors)


class Subtract(_Merge):
    prefix = "subtract"

    def build_ff(self, ffmodel, inputs):
        return [ffmodel.subtract(inputs[0], inputs[1], name=self.name)]


def subtract(input_tensors):
    return Subtract()(input_tensors)


class Multiply(_Merge):
    prefix = "multiply"

    def build_ff(self, ffmodel, inputs):
        return [ffmodel.multiply(inputs[0], inputs[1], name=self.name)]


def multiply(input_tensors):
    return Multiply()(input_tensors)


class Maximum(_Merge):
    prefix = "maximum"

    def build_ff(self, ffmodel, inputs):
        return [ffmodel.max(inputs[0], inputs[1], name=self.name)]


class Minimum(_Merge):
    prefix = "minimum"

    def build_ff(self, ffmodel, inputs):
        return [ffmodel.min(inputs[0], inputs[1], name=self.name)]


class BatchNormalization(Layer):
    """Reference: normalization.py:23 (relu-fused option off by default)."""

    prefix = "batch_normalization"

    def __init__(self, relu=False, name=None, **kw):
        super().__init__(name=name, **kw)
        self.relu = relu

    def compute_output_shape(self, in_shapes):
        return [in_shapes[0]]

    def build_ff(self, ffmodel, inputs):
        return [ffmodel.batch_norm(inputs[0], relu=self.relu, name=self.name)]


class LayerNormalization(Layer):
    """An addition to the reference's layers (it exposes layer_norm only
through the FFModel API)."""

    prefix = "layer_normalization"

    def __init__(self, epsilon=1e-5, name=None, **kw):
        super().__init__(name=name, **kw)
        self.epsilon = epsilon

    def compute_output_shape(self, in_shapes):
        return [in_shapes[0]]

    def build_ff(self, ffmodel, inputs):
        return [ffmodel.layer_norm(inputs[0], eps=self.epsilon, name=self.name)]
