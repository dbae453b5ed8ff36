"""Checkpoint / resume of training state (port of
``flexflow_tpu/runtime/checkpoint.py``).

A checkpoint is a directory holding ``train_state.pt``: the executor's
``params``, ``state`` (BatchNorm's running statistics) and ``opt_state``
as CPU tensors, plus the step. The JAX package writes an orbax pytree
instead; orbax does not run here, so this on-disk format is the port's
own (``torch.save``, read back with ``weights_only=True``): bfloat16 and
float16 tensors are stored as they are, bit for bit. As in the JAX
package, the node level is keyed canonically,
``"{topo index:04d}.{op_type}[.{name}]"`` (:func:`_canon_map`), so a
model rebuilt in another process restores whatever its guids are. The
file is written beside its final name and renamed into place, so a
process that dies mid-save leaves no readable half file.

:class:`CheckpointManager` keeps the newest ``max_to_keep`` step
directories, restores the newest one that reads back (falling back past
a corrupt or partial newest), and removes the step directory of a save
that failed. The ``checkpoint.save`` fault site fires at the top of a
save, as in the JAX package. ``save_checkpoint(..., strategy=)`` writes
the parallelization strategy beside the state as ``strategy.json`` (the
JAX package's file and format) and :func:`load_strategy` reads it back.

A checkpoint holds whole tensors. A data-parallel or tensor-parallel
model (``runtime/data_parallel.py``, ``runtime/tensor_parallel.py``)
saves from rank 0, the caller's process, with its shards and ZeRO-1
moments gathered whole first (``executor.whole_params()``,
``whole_state()``, ``full_opt_state()``), so the file is the one a
single device writes after the same steps; a restore checks the file
against the whole shapes (``executor.whole_specs()``) and loads it at
any number of ranks and any mesh, every rank taking its part
(``executor.load_whole``).
"""
from __future__ import annotations

import os
import shutil
from typing import Any, Dict, Optional

import torch

_FILE = "train_state.pt"


def _canon_map(executor) -> Dict[str, str]:
    """Executor node key -> canonical key stable across process restarts."""
    from .executor import node_key

    return {node_key(node): f"{i:04d}.{node.op_type.value}" + (f".{node.name}" if node.name else "")
            for i, node in enumerate(executor.graph.topo_order())}


def _rekey(tree: Optional[dict], mapping: Dict[str, str]) -> Optional[dict]:
    """Rename the node-key level of a params-shaped dict."""
    if tree is None:
        return None
    return {mapping.get(k, k): v for k, v in tree.items()}


def _opt_rekey(opt_state: Optional[dict], mapping: Dict[str, str]) -> Optional[dict]:
    if opt_state is None:
        return None
    out = dict(opt_state)
    for field in ("v", "m"):
        if isinstance(out.get(field), dict):
            out[field] = _rekey(out[field], mapping)
    return out


def _to_cpu(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return tree


def save_checkpoint(path: str, executor, step: int = 0, strategy=None) -> None:
    """Write a checkpoint directory at ``path``: the training state and,
    when given, ``strategy`` as ``strategy.json``."""
    from . import faults

    faults.inject(faults.CHECKPOINT_SAVE, path)  # chaos hook: storage failure
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    fwd = _canon_map(executor)
    tree = {
        "params": _to_cpu(_rekey(executor.whole_params(), fwd)),
        "state": _to_cpu(_rekey(executor.whole_state(), fwd)) or {},
        "opt_state": _to_cpu(_opt_rekey(executor.full_opt_state(), fwd)) or {},
        "step": int(step),
    }
    tmp = os.path.join(path, _FILE + ".tmp")
    torch.save(tree, tmp)
    os.replace(tmp, os.path.join(path, _FILE))
    if strategy is not None:
        with open(os.path.join(path, "strategy.json"), "w") as f:
            f.write(strategy.to_json())


def _checked(have: dict, saved: dict, what: str) -> dict:
    """``saved`` checked against ``have`` ({node key: {name: (shape,
    dtype)}}) exactly: the same leaves, each a tensor of its shape and
    dtype (nothing is written before every part of the checkpoint has
    been checked)."""
    if set(saved) != set(have):
        raise ValueError(f"checkpoint {what} cover other layers than the model's")
    for key, ws in have.items():
        if set(saved[key]) != set(ws):
            raise ValueError(f"checkpoint {what} of {key}: {sorted(saved[key])}, "
                             f"expected {sorted(ws)}")
        for name, (shape, dtype) in ws.items():
            src = saved[key][name]
            if not isinstance(src, torch.Tensor) or tuple(src.shape) != tuple(shape) \
                    or src.dtype != dtype:
                raise ValueError(f"checkpoint {what} {key}.{name} does not match the model's")
    return saved


def restore_checkpoint(path: str, executor) -> int:
    """Restore into a compiled executor (every rank takes its part of the
    whole tensors); returns the saved step."""
    path = os.path.abspath(path)
    saved = torch.load(os.path.join(path, _FILE), map_location="cpu", weights_only=True)
    rev = {v: k for k, v in _canon_map(executor).items()}
    specs = executor.whole_specs()
    params = _checked(specs["params"], _rekey(saved["params"], rev), "params")
    state = _checked(specs["state"], _rekey(saved["state"], rev), "state")
    opt = None
    if executor.opt_state is not None and saved["opt_state"]:
        sopt = _opt_rekey(saved["opt_state"], rev)
        opt = {"step": int(sopt["step"]), "lr": float(sopt["lr"])}
        for field in ("v", "m"):
            have = executor.opt_state.get(field)
            if (have is None) != (sopt.get(field) is None):
                raise ValueError(f"checkpoint optimizer state {field!r} does not match the model's")
            if have is not None:
                mspecs = {k: {n: (shape, have[k][n].dtype) for n, (shape, _) in g.items()}
                          for k, g in specs["params"].items()}
                opt[field] = _checked(mspecs, sopt[field], f"opt_state[{field!r}]")
    executor.load_whole(params, state, opt)
    return int(saved["step"])


def load_strategy(path: str):
    """Load the strategy saved next to a checkpoint, if present."""
    from ..parallel.strategy import ParallelStrategy

    sp = os.path.join(os.path.abspath(path), "strategy.json")
    if not os.path.exists(sp):
        return None
    with open(sp) as f:
        return ParallelStrategy.from_json(f.read())


class CheckpointManager:
    """Rolling checkpoints with ``max_to_keep``, orbax-style."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _steps(self):
        return sorted(int(d[5:]) for d in os.listdir(self.directory)
                      if d.startswith("step_") and d[5:].isdigit())

    def save(self, executor, step: int, strategy=None) -> str:
        p = os.path.join(self.directory, f"step_{step}")
        try:
            save_checkpoint(p, executor, step=step, strategy=strategy)
        except Exception:
            # a failed save must not leave a partial step dir that a
            # later restore_latest would pick as "newest"; the previous
            # checkpoints stay untouched and usable
            shutil.rmtree(p, ignore_errors=True)
            raise
        for s in self._steps()[: -self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"), ignore_errors=True)
        return p

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore_latest(self, executor) -> Optional[int]:
        """Restore the newest restorable checkpoint, falling back to
        older ones if the newest is corrupt or partial (the process died
        mid-save). Returns the restored step, None when the directory
        holds no checkpoints, and re-raises the newest error when every
        candidate is unreadable."""
        last_err: Optional[Exception] = None
        for s in reversed(self._steps()):
            try:
                restore_checkpoint(os.path.join(self.directory, f"step_{s}"), executor)
                return s
            except Exception as e:  # corrupt/partial: try the previous one
                if last_err is None:
                    last_err = e
        if last_err is not None:
            raise last_err
        return None
