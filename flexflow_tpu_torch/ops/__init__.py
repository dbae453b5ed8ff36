"""Operators of the port: the training graphs' ops (registered on
import: the BERT encoder, its heads and dropout, the seq2seq decoder's,
the shape ops, the vision models' convolution, pooling, BatchNorm and
elementwise families) and the generation path's attention."""
from . import (  # noqa: F401 (registers the ops)
    attention,
    conv,
    elementwise,
    embedding,
    io_ops,
    linear,
    norm,
    shape_ops,
    softmax,
)
from .base import LowerCtx, OpDef, WeightSpec, get_op_def, register_op

__all__ = ["LowerCtx", "OpDef", "WeightSpec", "get_op_def", "register_op"]
