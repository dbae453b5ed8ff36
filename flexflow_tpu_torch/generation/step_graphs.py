"""The engine's fixed-shape steps as captured CUDA graphs: the port's
counterpart of the JAX engine's jitted step programs (one per prefill
bucket, one decode, one verify).

A step kind is a *body*: a function of device tensors that launches the
step's kernels and returns ``(readback, extra)`` — a 1-D int32 tensor the
host needs (sampled tokens, the finiteness flags) and device tensors it
keeps there (the logits). A :class:`StepRunner` runs bodies by
*signature*, the key the engine's ``trace_counts`` count:

* **inputs**: each step's host arrays (4-byte dtypes) are packed into one
  pinned int32 buffer and uploaded with one copy into a device buffer the
  signature owns (the counterpart of the JAX engine's ``_stage``/``_dev``);
  the body reads named views of it (:class:`StepLayout`).
* **graphs**: on the graph path the first step of a signature runs the
  body once eagerly on a side stream (the kernels' first launch builds
  their library and sets their shared-memory attribute, neither of which
  may happen inside a capture), then captures it into a CUDA graph in the
  runner's one memory pool and replays it; every later step is a replay.
  A capture that fails raises; nothing falls back to eager steps.
* **readback**: the readback tensor comes to a pinned host buffer in one
  non-blocking copy, followed by one event sync.
* **launches**: the paged kernels count their launches on the Python
  side, which a replay never reaches; the capture's launches are recorded
  and added per replay (``decode_attention.count_replay``).

Eager steps (CPU tensors, or ``graphs=False`` on a CUDA device) run the
same body on the same packed input buffer, so the only difference between
the two paths on the card is the replay.
"""
from __future__ import annotations

from typing import Callable, Dict, Hashable, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..ops.kernels import decode_attention as da

# a step body: views of the packed inputs -> (int32 readback [N], extra)
StepBody = Callable[[Dict[str, torch.Tensor]], Tuple[torch.Tensor, object]]

_DTYPES = (np.dtype(np.int32), np.dtype(np.uint32), np.dtype(np.float32))


class StepLayout:
    """Named host arrays of 4-byte dtypes (int32, uint32, float32) packed
    into one int32 buffer; float32 and uint32 travel by bit pattern (a
    uint32 field reads back as its int32 bits)."""

    def __init__(self, arrays: Mapping[str, np.ndarray]):
        self.fields: List[Tuple[str, Tuple[int, ...], np.dtype, int, int]] = []
        off = 0
        for name, a in arrays.items():
            if a.dtype not in _DTYPES:
                raise TypeError(f"step input {name!r} has dtype {a.dtype}, not a 4-byte one")
            self.fields.append((name, a.shape, a.dtype, off, a.size))
            off += a.size
        self.size = off

    def pack(self, out: np.ndarray, arrays: Mapping[str, np.ndarray]) -> None:
        """Write ``arrays`` (the same names, shapes and dtypes as the
        layout's) into the int32 buffer ``out``."""
        for name, shape, dtype, off, n in self.fields:
            a = arrays[name]
            if a.shape != shape or a.dtype != dtype:
                raise ValueError(
                    f"step input {name!r}: {a.dtype}{list(a.shape)} where the signature "
                    f"has {dtype}{list(shape)}"
                )
            out[off:off + n] = np.ascontiguousarray(a).reshape(-1).view(np.int32)

    def unpack(self, buf: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Views of the int32 tensor ``buf``, one per field."""
        views = {}
        for name, shape, dtype, off, n in self.fields:
            t = buf[off:off + n]
            if dtype == np.float32:
                t = t.view(torch.float32)
            views[name] = t.view(shape)
        return views


class _Step:
    """One signature's buffers and, on the graph path, its graph."""

    __slots__ = ("layout", "host", "host_np", "dev", "readback", "graph", "outputs", "launches")

    def __init__(self, layout: StepLayout, device: torch.device):
        self.layout = layout
        cuda = device.type == "cuda"
        self.host = torch.empty((layout.size,), dtype=torch.int32, pin_memory=cuda)
        self.host_np = self.host.numpy()
        # on the CPU the device buffer is the host buffer itself
        self.dev = torch.empty_like(self.host, device=device) if cuda else self.host
        self.readback: Optional[torch.Tensor] = None  # pinned, sized at the first step
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs = None  # the capture's (readback, extra)
        self.launches: Dict[str, int] = {}


class StepRunner:
    """Runs step bodies by signature on one device; ``graphs`` selects the
    captured-graph path (CUDA only)."""

    def __init__(self, device: torch.device, graphs: bool):
        if graphs and device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, not {device}")
        self.device = device
        self.graphs = graphs
        self._steps: Dict[Hashable, _Step] = {}
        self._pool = torch.cuda.graph_pool_handle() if graphs else None
        self._side = torch.cuda.Stream(device) if graphs else None  # warm-ups run here
        self._event = torch.cuda.Event() if device.type == "cuda" else None

    def __contains__(self, sig: Hashable) -> bool:
        return sig in self._steps

    def run(
        self, sig: Hashable, arrays: Mapping[str, np.ndarray], body: StepBody
    ) -> Tuple[np.ndarray, object]:
        """One step of signature ``sig``: pack and upload ``arrays``, run
        ``body`` on their views (on the graph path: replay the signature's
        graph, captured at its first step) and bring the readback to the
        host. Returns (readback as a numpy int32 array, the body's extra
        output, which on the graph path the next replay overwrites)."""
        step = self._steps.get(sig)
        if step is None:
            step = self._steps[sig] = _Step(StepLayout(arrays), self.device)
        step.layout.pack(step.host_np, arrays)
        if self.device.type != "cuda":
            readback, extra = body(step.layout.unpack(step.dev))
            return readback.numpy(), extra
        step.dev.copy_(step.host, non_blocking=True)
        if self.graphs:
            if step.graph is None:
                self._capture(step, body)
            step.graph.replay()
            da.count_replay(step.launches)
            readback, extra = step.outputs
        else:
            readback, extra = body(step.layout.unpack(step.dev))
        if step.readback is None:
            step.readback = torch.empty(readback.shape, dtype=readback.dtype, pin_memory=True)
        step.readback.copy_(readback, non_blocking=True)
        self._event.record()
        self._event.synchronize()
        return step.readback.numpy().copy(), extra

    def _capture(self, step: _Step, body: StepBody) -> None:
        inputs = step.layout.unpack(step.dev)
        stream = torch.cuda.current_stream(self.device)
        self._side.wait_stream(stream)
        with torch.cuda.stream(self._side):
            # warm-up: the same inputs, so its cache writes are the ones
            # the replay makes again
            body(inputs)
        stream.wait_stream(self._side)
        graph = torch.cuda.CUDAGraph()
        before = dict(da.LAUNCHES)
        with torch.cuda.graph(graph, pool=self._pool, capture_error_mode="thread_local"):
            outputs = body(inputs)
        step.launches = da.captured_launches(before)
        step.graph, step.outputs = graph, outputs
