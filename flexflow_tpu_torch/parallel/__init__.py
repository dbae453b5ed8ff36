"""Shape propagation over the graph and the repeated-block discovery
that rematerialization uses (the sharding half and the pipeline schedule
wait for the multi-GPU slices)."""
from .pipeline import detect_repeats
from .propagation import infer_all_specs

__all__ = ["detect_repeats", "infer_all_specs"]
