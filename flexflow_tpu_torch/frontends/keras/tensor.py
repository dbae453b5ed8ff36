"""Symbolic tensors for the Keras frontend (port of
``flexflow_tpu/frontends/keras/tensor.py``).

Reference: python/flexflow/keras/models/tensor.py (Tensor holding
batch_shape/dtype and from_layer provenance). Here a KerasTensor is a
pure-Python symbolic handle; the real PCG node is created when the model
is compiled and the layer DAG is replayed into an FFModel.
"""
from __future__ import annotations

from typing import Optional, Tuple

from ...core.types import DataType

_DTYPES = {
    "float32": DataType.FLOAT,
    "float64": DataType.DOUBLE,
    "float16": DataType.HALF,
    "bfloat16": DataType.BFLOAT16,
    "int32": DataType.INT32,
    "int64": DataType.INT64,
}


def to_datatype(dtype) -> DataType:
    if isinstance(dtype, DataType):
        return dtype
    if dtype is None:
        return DataType.FLOAT
    return _DTYPES[str(dtype)]


class KerasTensor:
    """Symbolic tensor: batch_shape has None in position 0 until compile."""

    def __init__(
        self,
        batch_shape: Tuple[Optional[int], ...],
        dtype: DataType = DataType.FLOAT,
        from_layer=None,
        output_index: int = 0,
        name: str = "",
    ):
        self.batch_shape = tuple(batch_shape)
        self.dtype = to_datatype(dtype)
        self.from_layer = from_layer
        self.output_index = output_index
        self.name = name

    @property
    def shape(self) -> Tuple[Optional[int], ...]:
        return self.batch_shape

    def __repr__(self):
        return f"KerasTensor(shape={self.batch_shape}, dtype={self.dtype.name})"
