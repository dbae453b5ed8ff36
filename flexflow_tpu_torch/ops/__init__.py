"""Operators of the port: the training graph's ops (registered on
import) and the generation path's attention."""
from . import attention, elementwise, io_ops, linear, norm  # noqa: F401 (registers the ops)
from .base import LowerCtx, OpDef, WeightSpec, get_op_def, register_op

__all__ = ["LowerCtx", "OpDef", "WeightSpec", "get_op_def", "register_op"]
