"""Speculative decoding: drafters + fixed-shape batched verification (port
of ``flexflow_tpu/generation/speculative``).

A cheap *drafter* guesses up to k tokens per sequence, ONE fixed-shape
``engine.verify`` step scores every slot's (k+1)-token window against the
block KV cache (the paged append kernel at W = k+1) and accepts exactly
(``sampling.py``): greedy streams are token-for-token the
non-speculative ones, and temperature/top-k streams keep the target
distribution, drawn from the JAX package's per-token-count keys. The
continuous-batching scheduler drives it (``submit(speculation=...)``).
"""
from .drafter import (
    Drafter,
    DraftModelDrafter,
    NgramDrafter,
    SpeculationConfig,
    build_drafter,
)
from .sampling import rejection_sample, residual_distribution, speculative_accept

__all__ = [
    "Drafter",
    "DraftModelDrafter",
    "NgramDrafter",
    "SpeculationConfig",
    "build_drafter",
    "rejection_sample",
    "residual_distribution",
    "speculative_accept",
]
