"""FFConfig: the runtime and search configuration (port of
``flexflow_tpu/config.py``).

Every field of the JAX package's ``FFConfig`` is here, with its default,
and :meth:`FFConfig.from_args` parses the reference's CLI surface into
the same field values. ``num_devices`` is the JAX package's:
``workers_per_node``, or else the GPUs of this process, over
``num_nodes``; a strategy over N > 1 devices trains data-parallel over N
ranks (``runtime/data_parallel.py``), with ZeRO-1 moments under
``zero_optimizer``. A configuration that asks for what the port cannot
run yet raises instead of silently training another way: pipeline
stages and more than one node (ROADMAP queue 1, item 5's later parts).
``search_budget > 0`` runs the Unity search in
``FFModel.compile`` (``search/unity.py``), which reads the search knobs
(``search_num_nodes`` / ``search_num_workers`` search for a machine the
port does not have: compile then raises the device-count error);
``profiling`` prints the per-op table (``FFModel.profile``) before
``fit`` trains. The XLA-era flags are kept for CLI parity and read by
nothing.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Sequence


@dataclasses.dataclass
class FFConfig:
    # training flags (reference: model.cc:4041-4075)
    epochs: int = 1
    batch_size: int = 64
    learning_rate: float = 0.01
    weight_decay: float = 0.0001
    printing_interval: int = 10
    dataset_path: str = ""
    # machine (reference: -ll:gpu / -ll:cpu / numNodes)
    num_nodes: int = 1
    workers_per_node: int = 0  # 0 -> every GPU of this process
    # search flags (reference: config.h:128-163)
    search_budget: int = 0
    search_alpha: float = 1.05
    only_data_parallel: bool = False
    enable_sample_parallel: bool = True
    enable_parameter_parallel: bool = False
    enable_attribute_parallel: bool = False
    enable_inplace_optimizations: bool = False
    search_overlap_backward_update: bool = False
    search_num_nodes: int = -1
    search_num_workers: int = -1
    base_optimize_threshold: int = 10
    enable_control_replication: bool = True
    substitution_json_path: Optional[str] = None
    memory_search: bool = False
    machine_model_version: int = 0
    machine_model_file: str = ""
    simulator_segment_size: int = 16777216
    simulator_max_num_segments: int = 1
    # the search's op-cost source: the calibration table always; True
    # also times every op the table lacks, live (None and False: not)
    measure_op_costs: Optional[bool] = None
    # pipeline parallelism (must stay 1: not ported yet)
    pipeline_stages: int = 1
    pipeline_microbatches: int = 0  # 0 -> auto (parallel/strategy.py)
    # activation rematerialization: each repeated block's activations
    # are recomputed in the backward pass instead of stored
    # (torch.utils.checkpoint per block; engages at >= 2 blocks)
    remat_blocks: bool = False
    # iteration-tracing window (reference: Legion's begin_trace/end_trace,
    # flexflow_cffi.py:2079-2086): fit() runs each full window of this
    # many steps through Executor.train_window, which on the card replays
    # one captured CUDA graph of the step per step. 1 = eager steps.
    trace_window: int = 1
    # ZeRO-1: the optimizer's moments sharded over the "data" axis
    zero_optimizer: bool = False
    # gradient accumulation: microbatches per optimizer update (one
    # microbatch's activations live at a time). 1 = off.
    grad_accum_steps: int = 1
    # execution flags
    perform_fusion: bool = False  # kept for CLI parity
    profiling: bool = False  # per-op timing table before fit (FFModel.profile)
    allow_tensor_op_math_conversion: bool = True  # kept for CLI parity (TF32 stays off)
    seq_length: Optional[int] = None
    # export flags
    export_strategy_file: str = ""
    import_strategy_file: str = ""
    export_strategy_task_graph_file: str = ""
    export_strategy_computation_graph_file: str = ""
    include_costs_dot_graph: bool = False
    # fork flags (topology-aware allreduce optimization)
    topo_file: str = ""
    iteration: int = 1
    allreduce_optimize: bool = False
    # the port's own: weights and the training loop's randomness derive
    # from it (the JAX package takes FFModel(seed=...) alone)
    seed: int = 0

    def __post_init__(self):
        if self.pipeline_stages > 1:
            raise NotImplementedError(
                "pipeline stages are not ported (ROADMAP queue 1, item 5: GPipe with "
                "models/pipeline_transformer.py); use pipeline_stages=1")
        if self.num_nodes > 1:
            raise NotImplementedError(
                "training across nodes is not ported (ROADMAP queue 1, item 5: the multi-host "
                "FF_* entry); use num_nodes=1")
        if self.batch_size < 1 or self.epochs < 1 or self.trace_window < 1:
            raise ValueError("batch_size, epochs and trace_window must be >= 1")

    @property
    def num_devices(self) -> int:
        """The JAX package's device count: ``workers_per_node`` or the
        GPUs of this process, over ``num_nodes`` (at least 1)."""
        import torch

        n_gpu = torch.cuda.device_count() if torch.cuda.is_available() else 0
        per_node = self.workers_per_node or (n_gpu // max(1, self.num_nodes))
        return max(1, self.num_nodes * per_node)

    @classmethod
    def from_args(cls, argv: Optional[Sequence[str]] = None) -> "FFConfig":
        """Parse the reference's CLI surface (model.cc:4027) into the JAX
        package's field values; a flag the port cannot run raises."""
        p = argparse.ArgumentParser("flexflow_tpu_torch", allow_abbrev=False)
        p.add_argument("-e", "--epochs", type=int, default=1)
        p.add_argument("-b", "--batch-size", type=int, default=64)
        p.add_argument("--lr", type=float, default=0.01)
        p.add_argument("--wd", type=float, default=0.0001)
        p.add_argument("-p", "--print-freq", type=int, default=10)
        p.add_argument("-d", "--dataset", type=str, default="")
        p.add_argument("--budget", "--search-budget", dest="budget", type=int, default=0)
        p.add_argument("--alpha", "--search-alpha", dest="alpha", type=float, default=1.05)
        p.add_argument("--only-data-parallel", action="store_true")
        p.add_argument("--enable-parameter-parallel", action="store_true")
        p.add_argument("--enable-attribute-parallel", action="store_true")
        p.add_argument("--enable-inplace-optimizations", action="store_true")
        p.add_argument("--fusion", action="store_true")
        p.add_argument("--profiling", action="store_true")
        p.add_argument("--overlap", action="store_true")
        p.add_argument("--search-num-nodes", type=int, default=-1)
        p.add_argument("--search-num-workers", type=int, default=-1)
        p.add_argument("--base-optimize-threshold", type=int, default=10)
        p.add_argument("--substitution-json", type=str, default=None)
        p.add_argument("--memory-search", action="store_true")
        p.add_argument("--machine-model-version", type=int, default=0)
        p.add_argument("--machine-model-file", type=str, default="")
        p.add_argument("--simulator-segment-size", type=int, default=16777216)
        p.add_argument("--simulator-max-num-segments", type=int, default=1)
        p.add_argument("--export", "--export-strategy", dest="export_strategy", type=str, default="")
        p.add_argument("--import", "--import-strategy", dest="import_strategy", type=str, default="")
        p.add_argument("--taskgraph", type=str, default="")
        p.add_argument("--compgraph", type=str, default="")
        p.add_argument("--include-costs-dot-graph", action="store_true")
        p.add_argument("--pipeline-stages", type=int, default=1)
        p.add_argument("--remat-blocks", action="store_true")
        p.add_argument("--trace-window", type=int, default=1)
        p.add_argument("--zero-optimizer", action="store_true")
        p.add_argument("--grad-accum-steps", type=int, default=1)
        p.add_argument("--pipeline-microbatches", type=int, default=0)
        p.add_argument("--topo-file", type=str, default="")
        p.add_argument("--iteration", type=int, default=1)
        p.add_argument("--nodes", type=int, default=1)
        p.add_argument("--ll:gpu", dest="ll_gpu", type=int, default=0)  # reference CLI parity
        ns, _ = p.parse_known_args(argv)
        return cls(
            epochs=ns.epochs,
            batch_size=ns.batch_size,
            learning_rate=ns.lr,
            weight_decay=ns.wd,
            printing_interval=ns.print_freq,
            dataset_path=ns.dataset,
            num_nodes=ns.nodes,
            workers_per_node=ns.ll_gpu,
            search_budget=ns.budget,
            search_alpha=ns.alpha,
            only_data_parallel=ns.only_data_parallel,
            enable_parameter_parallel=ns.enable_parameter_parallel,
            enable_attribute_parallel=ns.enable_attribute_parallel,
            enable_inplace_optimizations=ns.enable_inplace_optimizations,
            perform_fusion=ns.fusion,
            profiling=ns.profiling,
            search_overlap_backward_update=ns.overlap,
            search_num_nodes=ns.search_num_nodes,
            search_num_workers=ns.search_num_workers,
            base_optimize_threshold=ns.base_optimize_threshold,
            substitution_json_path=ns.substitution_json,
            memory_search=ns.memory_search,
            machine_model_version=ns.machine_model_version,
            machine_model_file=ns.machine_model_file,
            simulator_segment_size=ns.simulator_segment_size,
            simulator_max_num_segments=ns.simulator_max_num_segments,
            export_strategy_file=ns.export_strategy,
            import_strategy_file=ns.import_strategy,
            export_strategy_task_graph_file=ns.taskgraph,
            export_strategy_computation_graph_file=ns.compgraph,
            include_costs_dot_graph=ns.include_costs_dot_graph,
            pipeline_stages=ns.pipeline_stages,
            remat_blocks=ns.remat_blocks,
            trace_window=ns.trace_window,
            zero_optimizer=ns.zero_optimizer,
            grad_accum_steps=ns.grad_accum_steps,
            pipeline_microbatches=ns.pipeline_microbatches,
            topo_file=ns.topo_file,
            iteration=ns.iteration,
        )


@dataclasses.dataclass
class FFIterationConfig:
    """Per-iteration config (reference: config.h:165-170)."""

    seq_length: int = -1

    def reset(self):
        self.seq_length = -1
