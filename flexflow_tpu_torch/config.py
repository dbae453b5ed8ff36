"""FFConfig: the training configuration (port of the members of
``flexflow_tpu/config.py`` that the single-GPU training path reads).

The port trains on one GPU: ``num_devices`` is 1, and a configuration
that asks for the strategy search, pipeline stages or more than one
device raises instead of silently training on one card.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class FFConfig:
    # training flags (reference: model.cc:4041-4075)
    epochs: int = 1
    batch_size: int = 64
    learning_rate: float = 0.01
    weight_decay: float = 0.0001
    printing_interval: int = 10
    # fit() reads metrics back once per window of this many steps
    trace_window: int = 1
    # weights and the training loop's randomness derive from it
    seed: int = 0
    # activation rematerialization: each repeated block's activations
    # are recomputed in the backward pass instead of stored
    # (torch.utils.checkpoint per block; engages at >= 2 blocks)
    remat_blocks: bool = False
    # gradient accumulation: microbatches per optimizer update (one
    # microbatch's activations live at a time). 1 = off.
    grad_accum_steps: int = 1
    # what the port does not run yet: each must keep its default
    num_nodes: int = 1
    workers_per_node: int = 0  # 0 -> the one local device
    search_budget: int = 0
    pipeline_stages: int = 1

    def __post_init__(self):
        if self.search_budget > 0:
            raise NotImplementedError("the strategy search is not ported; use search_budget=0")
        if self.pipeline_stages > 1:
            raise NotImplementedError("pipeline stages are not ported; use pipeline_stages=1")
        if self.num_nodes > 1 or self.workers_per_node > 1:
            raise NotImplementedError("the port trains on one GPU: num_nodes=1, workers_per_node<=1")
        if self.batch_size < 1 or self.epochs < 1 or self.trace_window < 1:
            raise ValueError("batch_size, epochs and trace_window must be >= 1")

    @property
    def num_devices(self) -> int:
        return 1
