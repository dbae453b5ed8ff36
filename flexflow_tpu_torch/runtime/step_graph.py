"""The executor's train and eval steps as captured CUDA graphs: the port's
counterpart of the JAX executor's window programs, where a window of
``k`` steps runs as ONE XLA program (a ``lax.scan`` over stacked
batches, ``flexflow_tpu/runtime/executor.py::_scan_train_steps``).

On the card the counterpart of one program is one captured graph of the
whole step, replayed once a step: the forward, the loss, the backward
(with the gradient-accumulation microbatches and the remat blocks), the
optimizer's in-place update and the copy of the new non-trainable state
into the executor's state tensors. A :class:`StepGraph` holds one such
step for one geometry (input shapes and dtypes, label, step kind):

* **static buffers**: the step reads its inputs, its label and its
  threefry key (two int64 words) from device buffers the graph owns;
  each step fills them by device-to-device copies, never through the
  host. The learning rate and Adam's bias-correction terms live in the
  optimizer state as device scalars, written by ``fill_`` before a step
  (``runtime/optimizers.py``), so a graph takes a new learning rate with
  no re-capture.
* **capture**: the first run is a real step, run eagerly on a side
  stream (the warm-up: the kernels' first launch builds their library
  and sets their shared-memory limits, and cuBLAS makes its workspace,
  none of which may happen inside a capture); the same step is then
  captured, which runs nothing, and every later run replays it. The
  capture runs under the executor's TF32-off flags (the cuBLAS and cuDNN
  calls read them when they are recorded). A capture or a replay that
  fails raises; nothing falls back to the eager step.
* **outputs**: the metrics a replay writes live in the graph's memory
  pool and the next replay overwrites them: the caller copies them out
  (device to device) before the next step.
* **launches**: the flash kernels count their launches on the Python
  side, which a replay never reaches: the capture records them
  (``flash_attention.capturing``) and each replay adds them back.

Python's cyclic garbage collector runs before a capture and is held off
during it, as the engine's step graphs do: a collection inside the
capture could destroy another graph, a CUDA call that breaks the capture.
"""
from __future__ import annotations

import gc
import time
from typing import Callable, Dict, List, Tuple

import torch

from ..ops.kernels import flash_attention as fa

# a step body: (inputs, label, key) -> metrics (device tensors)
StepBody = Callable[[List[torch.Tensor], torch.Tensor, Tuple[torch.Tensor, torch.Tensor]],
                    Dict[str, torch.Tensor]]


def leaf_ids(*trees) -> Tuple[int, ...]:
    """The identities of every tensor in nested dicts (params, state,
    optimizer state): a graph reads the tensors it was captured with, so
    a tree whose tensors were replaced needs a new capture."""
    out: List[int] = []

    def walk(t):
        if isinstance(t, torch.Tensor):
            out.append(id(t))
        elif isinstance(t, dict):
            for k in sorted(t, key=str):
                walk(t[k])

    for tree in trees:
        walk(tree)
    return tuple(out)


class StepGraph:
    """One step body captured for one geometry on a CUDA device."""

    def __init__(self, device: torch.device, body: StepBody, inputs, label, wrap=None):
        self.device = device
        self.body = body
        self.wrap = wrap  # a context manager factory the step runs under
        self.inputs = [torch.empty_like(x) for x in inputs]
        self.label = torch.empty_like(label)
        self.key = torch.zeros(2, dtype=torch.int64, device=device)
        self.graph = None
        self.mets = None  # the replays' metrics (the graph's outputs)
        self.launches: Dict[str, int] = {}  # the flash launches one replay makes
        self.capture_s = None  # host seconds of the capture (the warm-up step excluded)

    def load(self, inputs=None, label=None, key=None) -> None:
        """Copy a step's inputs, label and key words ([2] int64) into the
        static buffers, device to device; None leaves a buffer as it is."""
        if inputs is not None:
            for dst, src in zip(self.inputs, inputs):
                dst.copy_(src)
        if label is not None:
            self.label.copy_(label)
        if key is not None:
            self.key.copy_(key)

    def _call(self):
        with self.wrap():
            return self.body(self.inputs, self.label, (self.key[0], self.key[1]))

    def run(self) -> Dict[str, torch.Tensor]:
        """One step on the loaded buffers: the first is the eager warm-up
        on a side stream, followed by the capture; every later one a
        replay. Returns the step's metrics (a replay's are overwritten
        by the next replay)."""
        with torch.cuda.device(self.device):
            if self.graph is not None:
                self.graph.replay()
                fa.count_replay(self.launches)
                return self.mets
            return self._warm_up_and_capture()

    def _warm_up_and_capture(self) -> Dict[str, torch.Tensor]:
        stream = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            mets = self._call()  # a real step, not thrown away
        stream.wait_stream(side)
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        gc.collect()
        gc.disable()
        try:
            with fa.capturing() as captured, torch.cuda.graph(graph):
                outs = self._call()
        finally:
            if collecting:
                gc.enable()
        self.graph, self.mets, self.launches = graph, outs, captured
        self.capture_s = time.perf_counter() - t0
        return mets
