"""Data loading: a host dataset -> batches on the device (port of
``flexflow_tpu/runtime/dataloader.py``).

Reference: SingleDataLoader (python/flexflow_dataloader.h:34). The
dataset stays in host memory as CPU tensors (numpy arrays, bfloat16 ones
included, cross bit for bit: ``runtime/convert.py``); each batch is a
row gather into pinned host memory when the target is a GPU, copied
``non_blocking`` to the device. The gather is the native library's
threaded row copy (``_native.batch_gather``, the JAX package's too),
straight into the host buffer viewed as numpy; a bfloat16 dataset goes
through as its two-byte bit patterns (an int16 view), bit for bit. With
``FF_NATIVE_DISABLE=1``, or where the library does not load, the gather
is ``index_select``; ``_native.CALLS["batch_gather"]`` shows which path
answered. A bounded background thread
prefetches the next batches while the current step runs; it issues its
copies on the device's default stream, the stream the steps run on, so
a batch is on the device before a step reads it without a cross-stream
wait. PyTorch's pinned-memory cache keeps a buffer until its copy has
ended, so every batch takes a fresh one. The shuffled order of an epoch
is ``np.random.RandomState(seed + epoch).permutation``, as in the JAX
package.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, List, Sequence

import numpy as np
import torch

from ..core.device import resolve_device
from .convert import to_tensor

_native_gather = None  # cached: the function, or False after a failed import


def _get_native_gather():
    global _native_gather
    if _native_gather is None:
        try:
            from .._native import batch_gather as f

            _native_gather = f
        except Exception:
            _native_gather = False
    return _native_gather or None


def _as_numpy(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor's memory as numpy (bfloat16 as its int16 bits)."""
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


class SingleDataLoader:
    """Batches one array; reference: SingleDataLoader (flexflow_cffi.py:2433)."""

    def __init__(self, full_array, batch_size: int, shuffle: bool = False, seed: int = 0,
                 device=None):
        self.data = to_tensor(full_array).cpu().contiguous()
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.device = resolve_device(device)
        self.num_samples = self.data.shape[0]
        self.num_batches = self.num_samples // batch_size
        self._epoch = 0

    def _order(self) -> np.ndarray:
        if not self.shuffle:
            return np.arange(self.num_samples)
        rs = np.random.RandomState(self.seed + self._epoch)
        return rs.permutation(self.num_samples)

    def reset(self):
        self._epoch = 0

    def next_epoch(self):
        self._epoch += 1

    def _gather(self, idx: np.ndarray) -> torch.Tensor:
        """One batch's rows in host memory, pinned when a GPU reads it."""
        pinned = self.device.type == "cuda"
        out = torch.empty((len(idx),) + tuple(self.data.shape[1:]), dtype=self.data.dtype,
                          pin_memory=pinned)
        native = _get_native_gather()
        if native is not None:
            try:
                native(_as_numpy(self.data), _as_numpy(out), idx)
                return out
            except Exception:
                pass
        return torch.index_select(self.data, 0, torch.from_numpy(idx), out=out)

    def batches(self) -> Iterator[torch.Tensor]:
        order = self._order()
        for b in range(self.num_batches):
            batch = self._gather(order[b * self.batch_size:(b + 1) * self.batch_size])
            yield batch.to(self.device, non_blocking=True)


class DataLoader:
    """Zips input + label loaders with background prefetch.

    Reference: FFModel.create_data_loader + the fit loop's per-batch
    next_batch index launches (flexflow_cffi.py:2178,2044).
    """

    def __init__(
        self,
        xs: Sequence,
        y,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        device=None,
        prefetch: int = 2,
    ):
        n = y.shape[0]
        if any(x.shape[0] != n for x in xs):
            raise ValueError("input/label sample counts differ")
        self.loaders: List[SingleDataLoader] = [
            SingleDataLoader(x, batch_size, shuffle, seed, device) for x in xs
        ]
        self.label_loader = SingleDataLoader(y, batch_size, shuffle, seed, device)
        self.num_batches = self.label_loader.num_batches
        self.prefetch = max(1, prefetch)

    def epoch(self) -> Iterator:
        """Yield (inputs, label) device batches for one epoch, prefetched
        on a worker thread so the host gather and the copy overlap the
        steps."""
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            """Bounded put that keeps checking stop so an abandoned epoch
            (consumer broke out of the generator) can't wedge the thread
            on a full queue."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            iters = [ld.batches() for ld in self.loaders] + [self.label_loader.batches()]
            try:
                for _ in range(self.num_batches):
                    if stop.is_set():
                        return
                    vals = [next(it) for it in iters]
                    if not put((vals[:-1], vals[-1])):
                        return
                put(None)
            except Exception as e:  # surface worker errors to the consumer
                put(e)

        t = threading.Thread(target=producer, daemon=True, name="dataloader-prefetch")
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            t.join()
        for ld in self.loaders:
            ld.next_epoch()
        self.label_loader.next_epoch()
