"""Shape propagation over the graph (the sharding half waits for the
multi-GPU slices)."""
from .propagation import infer_all_specs

__all__ = ["infer_all_specs"]
