"""Servable model: a compiled inference graph plus its tensor metadata
(port of ``flexflow_tpu/serving/model.py``).

An :class:`~flexflow_tpu_torch.model.FFModel` compiled with
``CompMode.INFERENCE`` is the model instance; :meth:`InferenceModel.infer`
pads a batch to ``max_batch`` (one shape for every device batch, as the
JAX package pads for its single jitted shape), runs ``predict`` on the
model's device, and slices the padding back off. Outputs come back as
numpy arrays; a bfloat16 output comes back as float32 (numpy has no
bfloat16; the widening is exact).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.types import CompMode, DataType, OpType
from ..parallel.propagation import infer_all_specs
from ..runtime import faults


@dataclasses.dataclass(frozen=True)
class TensorMeta:
    """Wire metadata for one input/output (Triton model-metadata analog)."""

    name: str
    shape: tuple  # per-sample shape (no batch dim)
    dtype: str


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


class InferenceModel:
    """One servable model: a compiled graph and a fixed max batch size."""

    def __init__(self, model, name: str = "model", max_batch: Optional[int] = None,
                 input_names: Optional[Sequence[str]] = None):
        if model.executor is None:
            raise ValueError("compile() the FFModel before serving it")
        self.model = model
        self.name = name
        self.max_batch = max_batch or model.config.batch_size
        ins = sorted((n for n in model.graph.nodes.values() if n.op_type == OpType.INPUT),
                     key=lambda n: n.params.input_index)
        specs = infer_all_specs(model.graph)
        names = list(input_names) if input_names else [n.name or f"input_{i}"
                                                       for i, n in enumerate(ins)]
        self.inputs: List[TensorMeta] = [
            TensorMeta(nm, tuple(specs[n.guid][0].shape[1:]), specs[n.guid][0].dtype.value)
            for nm, n in zip(names, ins)
        ]
        self.outputs: List[TensorMeta] = [
            TensorMeta(f"output_{i}", tuple(t.shape[1:]), t.dtype.value)
            for i, t in enumerate(model._outputs)
        ]

    @classmethod
    def from_onnx(
        cls,
        onnx_model,
        input_shapes: Dict[str, Sequence[int]],
        name: str = "model",
        max_batch: int = 8,
        strategy_file: str = "",
        input_dtypes: Optional[Dict[str, DataType]] = None,
        config=None,
        device=None,
    ) -> "InferenceModel":
        """Load an ONNX graph, compile it for inference on ``device`` (the
        GPU unless ``"cpu"``) and serve the graph's own weights (reference:
        triton/src/onnx_parser.cc + strategy.cc + model.cc).
        ``strategy_file`` (a ``ParallelStrategy`` JSON, either package's)
        is read after the graph is built and compiled with, as the JAX
        package does: remapped onto the graph by layer name, and refused
        with the device-count error when its mesh needs more devices
        than the one the port runs on."""
        from ..config import FFConfig
        from ..frontends.onnx import ONNXModel
        from ..model import FFModel

        config = config or FFConfig(batch_size=max_batch)
        ff = FFModel(config, device=device)
        dtypes = input_dtypes or {}
        in_names = list(input_shapes)
        tensors = {nm: ff.create_tensor([max_batch] + list(input_shapes[nm]),
                                        dtype=dtypes.get(nm, DataType.FLOAT), name=nm)
                   for nm in in_names}
        om = ONNXModel(onnx_model)
        outs = om.apply(ff, tensors)
        strategy = None
        if strategy_file:
            from ..parallel.strategy import ParallelStrategy

            with open(strategy_file) as f:
                strategy = ParallelStrategy.from_json(f.read())
        ff.compile(comp_mode=CompMode.INFERENCE, outputs=outs, strategy=strategy)
        om.load_weights(ff)  # serve the graph's weights, not random init
        return cls(ff, name=name, max_batch=max_batch, input_names=in_names)

    # --------------------------------------------------------------- run
    def infer(self, inputs: Sequence[np.ndarray]) -> List[np.ndarray]:
        """Run a batch (any size <= max_batch): padded to the compiled
        batch, its padding sliced back off."""
        # chaos hook: rules can raise (device loss), stall, or poison;
        # `when` predicates see the stacked inputs, so a fault can track a
        # specific poisoned request through batch bisection
        inputs = faults.inject(faults.SERVING_MODEL_INFER, inputs)
        if len(inputs) != len(self.inputs):
            raise ValueError(f"model takes {len(self.inputs)} inputs, got {len(inputs)}")
        n = inputs[0].shape[0]
        if n > self.max_batch:
            raise ValueError(f"batch {n} exceeds max_batch {self.max_batch}")
        padded = []
        for x, meta in zip(inputs, self.inputs):
            x = np.asarray(x)
            if tuple(x.shape[1:]) != meta.shape:
                raise ValueError(f"input {meta.name}: expected {meta.shape}, "
                                 f"got {tuple(x.shape[1:])}")
            if n < self.max_batch:
                pad = np.zeros((self.max_batch - n,) + tuple(x.shape[1:]), x.dtype)
                x = np.concatenate([x, pad], axis=0)
            padded.append(x)
        outs = self.model.executor.predict(padded)
        return [_host(o)[:n] for o in outs]

    def metadata(self) -> Dict:
        """Triton-style model metadata."""
        return {
            "name": self.name,
            "platform": "flexflow_tpu_torch",
            "max_batch_size": self.max_batch,
            "inputs": [dataclasses.asdict(m) for m in self.inputs],
            "outputs": [dataclasses.asdict(m) for m in self.outputs],
        }
