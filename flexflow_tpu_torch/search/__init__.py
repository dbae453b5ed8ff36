"""Unity-style parallelization search (port of
``flexflow_tpu/search/``).

Reference: the search stack of SURVEY §2.5 — PCG DP search
(src/runtime/graph.cc), substitution engine (src/runtime/substitution.cc),
execution simulator (src/runtime/simulator.cc), machine models
(src/runtime/machine_model.cc, src/runtime/network.cc), and the fork's
allreduce-schedule optimizer (src/runtime/simulator.cc:1721+).

The search is host code and gives the JAX package's answers: the same
analytic roofline and collective models, the same substitutions and
tie-breaking, the native task-graph simulator built from the repo's
``native/`` sources (``flexflow_tpu_torch/_native``). What is the port's
own: op costs calibrated on the card through the port's ops and kernels
(``calibration.py``), the card's chip spec, and the search's output
running on the card through ``FFModel.compile``.
"""
from .cost_model import CostModel
from .machine_model import (
    EnhancedMachineModel,
    NetworkedMachineModel,
    NetworkTopology,
    SimpleMachineModel,
    build_machine_model,
)
from .simulator import (
    AllreduceHelper,
    LogicalTaskgraphSimulator,
    SimTask,
    Simulator,
    allreduce_optimize,
)
from .substitution import (
    GraphXfer,
    OpX,
    base_optimize,
    generate_all_pcg_xfers,
    load_substitution_json,
)
from .dp_search import SearchHelper
from .mcmc import mcmc_optimize
from .unity import unity_optimize

__all__ = [
    "CostModel",
    "SimpleMachineModel",
    "EnhancedMachineModel",
    "NetworkedMachineModel",
    "NetworkTopology",
    "build_machine_model",
    "Simulator",
    "SimTask",
    "LogicalTaskgraphSimulator",
    "AllreduceHelper",
    "allreduce_optimize",
    "GraphXfer",
    "OpX",
    "base_optimize",
    "generate_all_pcg_xfers",
    "load_substitution_json",
    "SearchHelper",
    "mcmc_optimize",
    "unity_optimize",
]
