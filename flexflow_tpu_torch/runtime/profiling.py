"""Per-op profiling and tracing (port of ``flexflow_tpu/runtime/
profiling.py``).

Reference (SURVEY §5): the ``--profiling`` flag makes every kernel
bracket itself with cudaEvents and print elapsed ms
(linear_kernels.cu:95-118). :func:`profile_step` runs the forward graph
op by op and times each op's lowering: on the card with CUDA events
around its second call (the first is a warm-up), on the CPU with the
host clock. Beside each time stand the op's analytic flops and bytes
(``OpDef.cost``). :func:`trace` wraps ``torch.profiler`` and writes a
Chrome trace (the analog of Legion's -lg:prof logs).
:func:`export_cost_dot` writes the graph as DOT with each op's analytic
flops, bytes and the search's cost-model forward time.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import List, Sequence

import torch

from ..core.types import OpType
from ..ops.base import LowerCtx, get_op_def


@dataclasses.dataclass
class OpProfile:
    guid: int
    op_type: str
    name: str
    ms: float
    flops: float
    bytes_accessed: float

    @property
    def tflops(self) -> float:
        return self.flops / max(1e-9, self.ms / 1e3) / 1e12


def _timed_ms(fn, cuda: bool):
    """(outputs, ms) of one call of ``fn`` after a warm-up call."""
    fn()
    if cuda:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        outs = fn()
        end.record()
        end.synchronize()
        return outs, start.elapsed_time(end)
    t0 = time.perf_counter()
    outs = fn()
    return outs, (time.perf_counter() - t0) * 1e3


def profile_step(executor, inputs: Sequence, rng=None) -> List[OpProfile]:
    """Run the forward graph op by op in inference mode, timing each op
    (reference: per-op cudaEvent brackets under --profiling). Each op
    runs alone, so the times are upper bounds on its share of a step."""
    from ..parallel.propagation import infer_all_specs
    from .executor import _full_fp32, node_key

    graph = executor.graph
    specs = infer_all_specs(graph)
    ctx = LowerCtx(training=False, rng=executor._step_key(rng), backend=executor.backend,
                   seq_length=executor.seq_length)
    values = {}
    profiles: List[OpProfile] = []
    inputs = executor._as_inputs(inputs)
    cuda = executor.device.type == "cuda"
    with torch.no_grad(), _full_fp32():
        for node in graph.topo_order():
            op_def = get_op_def(node.op_type)
            nkey = node_key(node)
            if node.op_type == OpType.INPUT:
                values[(node.guid, 0)] = inputs[node.params.input_index]
                continue
            node_inputs = [values[(e.src, e.src_idx)] for e in graph.in_edges(node)]
            weights = {**executor.params.get(nkey, {}), **executor.state.get(nkey, {})}
            ctx.node_guid = node.guid

            def run(node=node, node_inputs=node_inputs, weights=weights, op_def=op_def):
                ctx.state_updates.clear()
                ctx.aux_losses.clear()
                return op_def.lower(node.params, node_inputs, weights, ctx)

            outs, ms = _timed_ms(run, cuda)
            for i, o in enumerate(outs):
                values[(node.guid, i)] = o
            in_specs = [specs[e.src][e.src_idx] for e in graph.in_edges(node)]
            try:
                cost = op_def.cost(node.params, in_specs, specs[node.guid])
                flops, nbytes = cost.flops, cost.bytes_accessed
            except Exception:
                flops = nbytes = 0.0
            profiles.append(OpProfile(node.guid, node.op_type.value, node.name or "", ms, flops,
                                      nbytes))
    return profiles


def format_profiles(profiles: List[OpProfile]) -> str:
    total = sum(p.ms for p in profiles)
    lines = [f"{'op':16s} {'name':20s} {'ms':>9s} {'%':>6s} {'TFLOP/s':>8s}"]
    for p in sorted(profiles, key=lambda p: -p.ms):
        lines.append(
            f"{p.op_type:16s} {p.name[:20]:20s} {p.ms:9.3f} {100*p.ms/max(1e-9,total):6.1f} {p.tflops:8.2f}"
        )
    lines.append(f"{'TOTAL':16s} {'':20s} {total:9.3f}")
    return "\n".join(lines)


@contextlib.contextmanager
def trace(logdir: str):
    """``torch.profiler`` over the block (host, and the card's kernels
    when one is present), written to ``logdir`` as a Chrome trace
    (``trace_N.json``; open it in Perfetto or chrome://tracing)."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=acts) as prof:
        yield
    n = sum(1 for f in os.listdir(logdir) if f.startswith("trace_"))
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{n}.json"))


def export_cost_dot(graph, machine=None) -> str:
    """PCG DOT annotated with analytic per-op costs (reference:
    --include-costs-dot-graph, config.h:145): flops and bytes from
    ``OpDef.cost`` and the forward time of the search's cost model
    (``search/cost_model.py``) for ``machine`` (default: its reference
    machine), as the JAX package's labels."""
    from ..parallel.propagation import infer_all_specs
    from ..search.cost_model import CostModel

    cm = CostModel(machine) if machine else CostModel()
    specs = infer_all_specs(graph)

    def label(node):
        base = f"{node.op_type.value}\\n{node.name or node.guid}"
        if node.op_type in (OpType.INPUT, OpType.WEIGHT):
            return base
        in_specs = [specs[e.src][e.src_idx] for e in graph.in_edges(node)]
        try:
            op_def = get_op_def(node.op_type)
            c = op_def.cost(node.params, in_specs, specs[node.guid])
            m = cm.op_cost_metrics(node.op_type, node.params, in_specs, specs[node.guid])
            return (
                f"{base}\\n{c.flops/1e9:.2f} GFLOP, {c.bytes_accessed/1e6:.1f} MB"
                f"\\n~{m.forward_time*1e6:.1f} us fwd"
            )
        except Exception:
            return base

    return graph.to_dot(label_fn=label)
