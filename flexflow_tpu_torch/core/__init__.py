"""Core definitions shared by the port's modules."""
from .device import resolve_device
from .types import DataType

__all__ = ["DataType", "resolve_device"]
