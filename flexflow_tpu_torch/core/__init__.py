"""Core definitions shared by the port's modules."""
from .device import resolve_device
from .graph import Edge, Node, PCGraph
from .tensor import TensorSpec
from .types import ActiMode, CompMode, DataType, LossType, MetricsType, OpType

__all__ = [
    "ActiMode",
    "CompMode",
    "DataType",
    "Edge",
    "LossType",
    "MetricsType",
    "Node",
    "OpType",
    "PCGraph",
    "TensorSpec",
    "resolve_device",
]
