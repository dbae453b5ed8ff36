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
  Python's cyclic garbage collector is run before a capture and held off
  during it: a collection inside the capture could destroy an unreachable
  engine's graphs, a CUDA call that invalidates the capture.
  A capture that fails raises; nothing falls back to eager steps.
* **readback**: the readback tensor comes to a pinned host buffer in one
  non-blocking copy, followed by an event the step's collect waits on.
  A step may be dispatched without waiting for it (the overlap
  pipeline): staging and readback buffers alternate between two per
  signature, and a step may take device tensors of its predecessor as
  inputs (``carry``), so a sampled token never visits the host between
  two steps.
* **launches**: the paged kernels count their launches on the Python
  side, which a replay never reaches; the capture's launches are recorded
  and added per replay (``decode_attention.count_replay``).

Everything a runner does on the card (its memory pool, side stream,
events, captures and replays) runs under its own device, whatever the
current device is: an engine on ``cuda:1`` captures and replays there.

Eager steps (CPU tensors, or ``graphs=False`` on a CUDA device) run the
same body on the same packed input buffer, so the only difference between
the two paths on the card is the replay. On the CPU a dispatch runs the
body at once and its collect returns the result.
"""
from __future__ import annotations

import gc
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
    """One signature's buffers and, on the graph path, its graph. The
    staging and readback buffers come in pairs, one per step in flight
    (``owner``: the handle that used each; on the CPU, where a step runs
    at its dispatch, both entries are the one staging buffer)."""

    __slots__ = ("layout", "host", "host_np", "dev", "views", "readback", "events",
                 "owner", "flip", "graph", "outputs", "launches")

    def __init__(self, layout: StepLayout, device: torch.device):
        self.layout = layout
        cuda = device.type == "cuda"
        self.host = [torch.empty((layout.size,), dtype=torch.int32, pin_memory=cuda)
                     for _ in range(2 if cuda else 1)] * (1 if cuda else 2)
        self.host_np = [h.numpy() for h in self.host]
        # on the CPU the device buffer is the host buffer itself
        self.dev = torch.empty_like(self.host[0], device=device) if cuda else self.host[0]
        self.views = layout.unpack(self.dev)
        self.readback: List[Optional[torch.Tensor]] = [None, None]  # pinned, sized at first use
        self.events = [torch.cuda.Event() for _ in range(2)] if cuda else [None, None]
        self.owner: List[Optional["InFlight"]] = [None, None]
        self.flip = 0
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs = None  # the capture's (readback, extra)
        self.launches: Dict[str, int] = {}


class InFlight:
    """One dispatched step: its staging slot, the event recorded after
    its readback copy, and its device outputs (``readback_dev``, which a
    later step may carry from, and ``extra``). Collected exactly once."""

    __slots__ = ("step", "slot", "event", "readback_dev", "extra", "result", "collected")

    def __init__(self, step: _Step, slot: int, event, readback_dev, extra, result=None):
        self.step = step
        self.slot = slot
        self.event = event
        self.readback_dev = readback_dev
        self.extra = extra
        self.result = result  # the host readback, set on the CPU at dispatch
        self.collected = False


class StepRunner:
    """Runs step bodies by signature on one device; ``graphs`` selects the
    captured-graph path (CUDA only).

    :meth:`dispatch` packs, uploads and launches a step and returns
    without waiting for the device; :meth:`collect` waits for that step's
    event and returns its readback. Up to two steps of a signature may be
    in flight: each takes the other pinned staging and readback buffer
    of the pair, so repacking step N+1 never touches step N's queued
    upload, and step N+1's readback never lands where the host is still
    to read step N's. A dispatch may *carry* device tensors into named
    inputs (copied device to device after the upload, before the step
    runs): the overlap pipeline feeds step N's sampled tokens to step
    N+1 without a round trip through the host. On the CPU a dispatch
    runs the body synchronously and collect returns its result."""

    def __init__(self, device: torch.device, graphs: bool):
        if graphs and device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, not {device}")
        self.device = device
        self.graphs = graphs
        self._steps: Dict[Hashable, _Step] = {}
        self._pool = self._side = None
        if graphs:
            with torch.cuda.device(device):
                self._pool = torch.cuda.graph_pool_handle()
                self._side = torch.cuda.Stream(device)  # warm-ups run here

    def __contains__(self, sig: Hashable) -> bool:
        return sig in self._steps

    def run(
        self, sig: Hashable, arrays: Mapping[str, np.ndarray], body: StepBody
    ) -> Tuple[np.ndarray, object]:
        """One step of signature ``sig``, dispatched and collected: pack
        and upload ``arrays``, run ``body`` on their views (on the graph
        path: replay the signature's graph, captured at its first step)
        and bring the readback to the host. Returns (readback as a numpy
        int32 array, the body's extra output, which on the graph path the
        next replay overwrites)."""
        return self.collect(self.dispatch(sig, arrays, body))

    def dispatch(
        self,
        sig: Hashable,
        arrays: Mapping[str, np.ndarray],
        body: StepBody,
        carry: Optional[Mapping[str, torch.Tensor]] = None,
    ) -> InFlight:
        """Launch one step of ``sig`` without waiting for it. ``carry``
        maps input names to device tensors that replace those inputs'
        uploaded values."""
        if self.device.type == "cuda":
            with torch.cuda.device(self.device):
                return self._dispatch(sig, arrays, body, carry)
        return self._dispatch(sig, arrays, body, carry)

    def _dispatch(self, sig, arrays, body, carry) -> InFlight:
        step = self._steps.get(sig)
        if step is None:
            step = self._steps[sig] = _Step(StepLayout(arrays), self.device)
        i = step.flip
        prev = step.owner[i]
        if prev is not None and not prev.collected:
            raise RuntimeError(
                f"step {sig!r}: a third step dispatched while two are in flight")
        step.flip = 1 - i
        step.layout.pack(step.host_np[i], arrays)
        if self.device.type != "cuda":
            # the step runs now and its handle keeps the result
            for name, src in (carry or {}).items():
                step.views[name].copy_(src)
            readback, extra = body(step.views)
            handle = InFlight(step, i, None, readback, extra, result=readback.numpy().copy())
            step.owner[i] = handle
            return handle
        step.dev.copy_(step.host[i], non_blocking=True)
        for name, src in (carry or {}).items():
            step.views[name].copy_(src)
        if self.graphs:
            if step.graph is None:
                self._capture(step, body)
            step.graph.replay()
            da.count_replay(step.launches)
            readback, extra = step.outputs
        else:
            readback, extra = body(step.views)
        if step.readback[i] is None:
            step.readback[i] = torch.empty(readback.shape, dtype=readback.dtype,
                                           pin_memory=True)
        step.readback[i].copy_(readback, non_blocking=True)
        event = step.events[i]
        event.record()
        handle = InFlight(step, i, event, readback, extra)
        step.owner[i] = handle
        return handle

    def collect(self, handle: InFlight) -> Tuple[np.ndarray, object]:
        """Wait for a dispatched step and return (its readback as a numpy
        int32 array, its extra output)."""
        if handle.collected:
            raise RuntimeError("a dispatched step was collected twice")
        handle.collected = True
        if handle.result is None:
            handle.event.synchronize()
            handle.result = handle.step.readback[handle.slot].numpy().copy()
        return handle.result, handle.extra

    def _capture(self, step: _Step, body: StepBody) -> None:
        inputs = step.views
        stream = torch.cuda.current_stream(self.device)
        self._side.wait_stream(stream)
        with torch.cuda.stream(self._side):
            # warm-up: the same inputs, so its cache writes are the ones
            # the replay makes again
            body(inputs)
        stream.wait_stream(self._side)
        graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        gc.collect()  # dead graphs are destroyed here, outside the capture
        gc.disable()
        try:
            with da.capturing() as captured, torch.cuda.graph(
                    graph, pool=self._pool, capture_error_mode="thread_local"):
                outputs = body(inputs)
        finally:
            if collecting:
                gc.enable()
        step.launches = captured
        step.graph, step.outputs = graph, outputs
