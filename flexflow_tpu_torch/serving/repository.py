"""Model repository: an on-disk model store with a load/unload lifecycle
(port of ``flexflow_tpu/serving/repository.py``, in its on-disk format,
so each package loads the models the other saved).

Layout per model: ``<root>/<name>/``
  config.json   -- name, max batch, batch size, input names, outputs
  graph.json    -- the graph (``PCGraph.to_json``, guids kept)
  strategy.json -- the compiled parallelization strategy
                   (``ParallelStrategy.to_json``), when the model has one
  weights.npz   -- the weights, keyed ``"p::<op_type>_<guid>::<weight>"``,
                   and the non-trainable state (BatchNorm's running
                   statistics), keyed ``"s::..."``; written to a
                   temporary file, then renamed

A bfloat16 weight is stored as its two-byte bit patterns (numpy dtype
``V2``), as numpy stores the JAX package's bfloat16 arrays; it is read
back by the compiled parameter's dtype, bit for bit, without
``ml_dtypes``. ``load_model`` compiles the graph with the stored
strategy, as the JAX package does: a strategy whose mesh needs more
devices than the port's one is refused by ``compile`` (``mesh needs N
devices, have 1``).
"""
from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from ..config import FFConfig
from ..core.graph import PCGraph
from ..core.types import CompMode
from ..runtime import faults
from .model import InferenceModel


def _to_numpy(w: torch.Tensor) -> np.ndarray:
    w = w.detach().cpu()
    if w.dtype == torch.bfloat16:
        return w.view(torch.int16).numpy().view(np.uint16).view(np.dtype("V2"))
    return w.numpy()


def _from_numpy(arr: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """A stored weight as a CPU tensor of the compiled parameter's dtype;
    bfloat16 from its stored bit patterns."""
    if arr.dtype.kind == "V" or arr.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.int16).copy()
        t = torch.from_numpy(bits).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(dtype)


def save_model(im: InferenceModel, root: str) -> str:
    """Persist a servable model (its graph, config and weights)."""
    d = Path(root) / im.name
    d.mkdir(parents=True, exist_ok=True)
    model = im.model
    ex = model.executor
    (d / "graph.json").write_text(model.graph.to_json())
    if model.strategy is not None:
        (d / "strategy.json").write_text(model.strategy.to_json())
    cfg = {
        "name": im.name,
        "max_batch": im.max_batch,
        "batch_size": model.config.batch_size,
        "input_names": [m.name for m in im.inputs],
        "outputs": [[g, i] for g, i in ex.outputs],
    }
    (d / "config.json").write_text(json.dumps(cfg, indent=1))
    flat: Dict[str, np.ndarray] = {
        f"{prefix}::{nkey}::{wname}": _to_numpy(w)
        for store, prefix in ((ex.params, "p"), (ex.state, "s"))
        for nkey, ws in store.items() for wname, w in ws.items()
    }
    # write-then-rename: a crash mid-save never leaves a truncated
    # weights.npz that a later load would read as a corrupt model
    tmp = d / "weights.npz.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, d / "weights.npz")
    return str(d)


def load_model(root: str, name: str, device=None) -> InferenceModel:
    """Rebuild a servable model from the repository: its graph compiled
    with its strategy for inference on ``device`` (the GPU unless
    ``"cpu"``), then its weights."""
    from ..model import FFModel
    from ..parallel.strategy import ParallelStrategy

    faults.inject(faults.SERVING_REPOSITORY_LOAD, name)
    d = Path(root) / name
    cfg = json.loads((d / "config.json").read_text())
    graph = PCGraph.from_json((d / "graph.json").read_text())
    strategy = None
    spath = d / "strategy.json"
    if spath.exists():
        strategy = ParallelStrategy.from_json(spath.read_text())
    model = FFModel.from_graph(graph, FFConfig(batch_size=cfg["batch_size"]), device=device)
    outputs = model.output_tensors([tuple(o) for o in cfg["outputs"]])
    model.compile(comp_mode=CompMode.INFERENCE, outputs=outputs, strategy=strategy)
    stores = {"p": model.executor.params, "s": model.executor.state}
    with np.load(d / "weights.npz") as z, torch.no_grad():
        for key in z.files:
            prefix, nkey, wname = key.split("::", 2)
            store = stores.get(prefix, {})
            if nkey not in store or wname not in store[nkey]:
                continue
            cur = store[nkey][wname]
            value = z[key]
            if tuple(value.shape) != tuple(cur.shape):
                raise ValueError(
                    f"repository weight {key} has shape {tuple(value.shape)}, "
                    f"compiled parameter expects {tuple(cur.shape)}"
                )
            cur.copy_(_from_numpy(value, cur.dtype))
    return InferenceModel(model, name=cfg["name"], max_batch=cfg["max_batch"],
                          input_names=cfg["input_names"])


class ModelRepository:
    """Directory of servable models with a Triton-style lifecycle; loaded
    models run on ``device`` (the GPU unless ``"cpu"``)."""

    def __init__(self, root: str, device=None):
        self.root = root
        self.device = device
        os.makedirs(root, exist_ok=True)

    def available(self) -> List[str]:
        return sorted(
            p.name
            for p in Path(self.root).iterdir()
            if p.is_dir() and (p / "config.json").exists()
        )

    def load(self, name: str) -> InferenceModel:
        if name not in self.available():
            raise KeyError(f"model {name!r} not in repository {self.root}")
        return load_model(self.root, name, device=self.device)

    def save(self, im: InferenceModel) -> str:
        return save_model(im, self.root)
