"""Shape/spec propagation over the PCG (port of
``flexflow_tpu/parallel/propagation.py``): walk the graph in topological
order and infer every node's output TensorSpecs from its inputs via the
op registry."""
from __future__ import annotations

from typing import Dict, List

from ..core.graph import PCGraph
from ..core.tensor import TensorSpec
from ..ops.base import get_op_def


def infer_all_specs(graph: PCGraph) -> Dict[int, List[TensorSpec]]:
    specs: Dict[int, List[TensorSpec]] = {}
    for node in graph.topo_order():
        in_specs = [specs[e.src][e.src_idx] for e in graph.in_edges(node)]
        specs[node.guid] = get_op_def(node.op_type).infer_output_specs(node.params, in_specs)
    return specs

