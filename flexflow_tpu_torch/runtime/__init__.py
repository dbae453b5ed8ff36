"""The training runtime: the executor (one device, or a rank of a
data-parallel group: ``data_parallel.py``), optimizers, losses, metrics,
initializers, the weight converter, the data loader and the
checkpoints."""
from .checkpoint import CheckpointManager, load_strategy, restore_checkpoint, save_checkpoint
from .convert import opt_state_from_numpy, params_from_numpy
from .dataloader import DataLoader, SingleDataLoader
from .executor import Executor
from .metrics import PerfMetrics, compute_metrics
from .optimizers import AdamOptimizer, Optimizer, SGDOptimizer

__all__ = [
    "AdamOptimizer",
    "CheckpointManager",
    "DataLoader",
    "Executor",
    "Optimizer",
    "PerfMetrics",
    "SGDOptimizer",
    "SingleDataLoader",
    "compute_metrics",
    "opt_state_from_numpy",
    "params_from_numpy",
    "load_strategy",
    "restore_checkpoint",
    "save_checkpoint",
]
