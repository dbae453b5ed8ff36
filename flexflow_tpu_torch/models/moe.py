"""Mixture-of-experts example model (port of ``flexflow_tpu/models/moe.py``).

Reference: examples/cpp/mixture_of_experts/moe.cc (MNIST-style 784-dim
input, the moe composite layer with the cache and recompile hooks at
moe.cc:180,204).
"""
from __future__ import annotations

from ..config import FFConfig
from ..model import FFModel


def build_moe_mlp(
    config: FFConfig,
    in_dim: int = 784,
    num_classes: int = 10,
    num_experts: int = 8,
    num_select: int = 2,
    expert_hidden: int = 64,
    alpha: float = 2.0,
    lambda_bal: float = 0.04,
    use_cache: bool = False,
    device=None,
) -> FFModel:
    """``input -> [cache] -> moe -> dense head -> softmax``, the JAX
    package's layer names; ``device`` as ``FFModel``'s (None: the GPU)."""
    model = FFModel(config, device=device)
    x = model.create_tensor((config.batch_size, in_dim), name="input")
    t = x
    if use_cache:
        t = model.cache(t, num_batches=4, name="cache")
    t = model.moe(t, num_experts, num_select, expert_hidden, alpha, lambda_bal, name="moe")
    t = model.dense(t, num_classes, name="head")
    model.softmax(t, name="softmax")
    return model
