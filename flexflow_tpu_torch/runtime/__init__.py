"""The single-GPU training runtime: executor, optimizers, losses,
metrics, initializers and the weight converter."""
from .convert import params_from_numpy
from .executor import Executor
from .metrics import PerfMetrics, compute_metrics
from .optimizers import AdamOptimizer, Optimizer, SGDOptimizer

__all__ = [
    "AdamOptimizer",
    "Executor",
    "Optimizer",
    "PerfMetrics",
    "SGDOptimizer",
    "compute_metrics",
    "params_from_numpy",
]
