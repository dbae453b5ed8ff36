"""Conditional mid-training recompilation (port of
``flexflow_tpu/runtime/recompile.py``).

Reference: RecompileState (include/flexflow/recompile.h:26-41) and
FFModel::recompile_on_condition (src/runtime/model.cc:2430): a trigger
inspects runtime signals (the MoE Cache op's score, cache.cc) and an
alter mutates the model, after which the ops are set up again. Here the
model compiles anew (a new executor, its optimizer state fresh, as in the
JAX package) and the trained weights of every node whose name survives
the alteration, at the same shapes, are copied into the new executor's
own tensors. The old executor's captured step graphs are dropped, so no
replay reads its buffers again; the next window captures once per
geometry.
"""
from __future__ import annotations

from typing import Callable

import torch


class RecompileState:
    """Reference: recompile.h:26 (trigger_func, alter_func, ffmodel)."""

    def __init__(self, trigger: Callable[["RecompileState"], bool],
                 alter: Callable[["RecompileState"], None], model):
        self.trigger = trigger
        self.alter = alter
        self.model = model
        self.recompilations = 0
        # runtime signals the trigger may inspect (reference: Cache score)
        self.cache_score: float = 0.0
        self.last_metrics: dict = {}

    def trigger_and_alter(self) -> bool:
        """One check (reference: FFModel::recompile_on_condition)."""
        if not self.trigger(self):
            return False
        self.alter(self)
        self._recompile()
        self.recompilations += 1
        return True

    def _recompile(self):
        """Compile the (possibly altered) graph anew, keeping the weights
        of nodes whose names survive the alteration."""
        from .executor import node_key

        model = self.model
        old_executor = model.executor
        old_graph = model.graph
        outs = model._outputs if model._outputs else None
        if outs and any(t.node.guid not in model.graph.nodes for t in outs):
            outs = None  # alter removed an output node; fall back to sink
        model.compile(
            optimizer=model.optimizer,
            loss_type=model.loss_type,
            metrics=model.metrics,
            comp_mode=model.comp_mode,
            outputs=outs,
        )
        if old_executor is None:
            return
        old_executor._graphs, old_executor._graph_leaves = {}, None
        new_ex = model.executor
        old_by_name = {n.name: node_key(n) for n in old_graph.nodes.values() if n.name}
        with torch.no_grad():
            for node in model.graph.nodes.values():
                ok = old_by_name.get(node.name)
                nk = node_key(node)
                if ok and ok in old_executor.params and nk in new_ex.params:
                    old_ws = old_executor.params[ok]
                    if all(k in old_ws and old_ws[k].shape == v.shape
                           for k, v in new_ex.params[nk].items()):
                        for k, v in new_ex.params[nk].items():
                            v.copy_(old_ws[k])
