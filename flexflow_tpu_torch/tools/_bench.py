"""The training-bench helpers the card's profiling and evidence tools
share (the port's copies of ``bench.py``'s ``train_flops_per_token``,
``peak_flops_per_device`` and ``_bench_one``).

``bench_one`` times the same unit as the JAX bench: a window of
``train_batch_repeated`` steps on one batch (on the card one captured
CUDA graph of the step, replayed once a step), here between CUDA events
rather than behind a scalar readback. ``peak_flops_per_device`` is the
card's own dense bf16 peak (the H100's 989 TFLOP/s from
``search/calibration.py::chip_spec_for``); a CUDA device it does not
know raises, since no TPU figure may stand in for a card's.
"""
from __future__ import annotations

import time

import numpy as np

# BERT-Base and BERT-Large (the OSDI'22 AE configurations the JAX
# package's evidence runner measures)
BERT_BASE = {"layers": 12, "hidden": 768, "heads": 12, "ff": 3072}
BERT_LARGE = {"layers": 24, "hidden": 1024, "heads": 16, "ff": 4096}


def train_flops_per_token(n_params: int, num_layers: int, seq_length: int,
                          hidden_size: int) -> float:
    """6N (forward + backward matmul FLOPs a token) plus the attention
    score and value matmuls, 12 L S H (the PaLM appendix's accounting)."""
    return 6.0 * n_params + 12.0 * num_layers * seq_length * hidden_size


def peak_flops_per_device(device_kind: str, backend: str) -> float:
    """Dense bf16 FLOP/s of one device: the card's from ``chip_spec_for``
    (an H100's 989e12), a nominal 1e12 on the CPU (its MFU means
    nothing). Any other CUDA device raises."""
    from ..search.calibration import chip_spec_for

    if backend == "cpu":
        return 1e12
    if "h100" not in device_kind.lower():
        raise ValueError(f"no peak FLOP/s known for the CUDA device {device_kind!r}")
    return chip_spec_for(device_kind).bf16_flops


def bert_config(payload: dict, seq: int = 128):
    """The bf16 encoder of a lever payload (``layers``, ``hidden``,
    ``heads``, ``ff``) over raw [batch, seq, hidden] inputs."""
    from ..core.types import DataType
    from ..models import TransformerConfig

    return TransformerConfig(num_layers=payload["layers"], hidden_size=payload["hidden"],
                             num_heads=payload["heads"], ff_size=payload["ff"],
                             seq_length=seq, dtype=DataType.BFLOAT16)


def build_bert(cfg, batch: int, searched: bool, device):
    """BERT in ``cfg`` trained by SGD on a mean-squared error, data
    parallel or through the Unity search (``search_budget=5``)."""
    from ..config import FFConfig
    from ..core.types import LossType
    from ..models import build_transformer
    from ..runtime import SGDOptimizer

    config = FFConfig(batch_size=batch, only_data_parallel=not searched,
                      search_budget=5 if searched else 0)
    model = build_transformer(config, cfg, device=device)
    model.compile(optimizer=SGDOptimizer(lr=0.01), loss_type=LossType.MEAN_SQUARED_ERROR)
    return model


def bench_inputs(batch: int, cfg, device):
    """The bench's one batch: ``RandomState(0)`` normals as input and
    target, in the model's dtype, on the device."""
    from ..runtime.convert import to_tensor

    rs = np.random.RandomState(0)
    shape = (batch, cfg.seq_length, cfg.hidden_size)
    x = to_tensor(rs.randn(*shape).astype(np.float32), device).to(cfg.dtype.torch)
    y = to_tensor(rs.randn(*shape).astype(np.float32), device).to(cfg.dtype.torch)
    return x, y


def bench_one(ex, batch: int, cfg, iters: int) -> float:
    """Steady-state seconds a step of a compiled executor: a warm-up
    window (the capture, on the card) then the best of three timed
    windows of ``iters`` steps, timed between CUDA events on the card
    (host clock on the CPU)."""
    import torch

    from ..generation import prng

    x, y = bench_inputs(batch, cfg, ex.device)
    rng = prng.key(0)
    cuda = ex.device.type == "cuda"
    ex.train_batch_repeated([x], y, rng, num_steps=iters)
    if cuda:
        torch.cuda.synchronize(ex.device)
    best = float("inf")
    for _ in range(3):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            ex.train_batch_repeated([x], y, rng, num_steps=iters)
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) * 1e-3)
        else:
            t0 = time.perf_counter()
            ex.train_batch_repeated([x], y, rng, num_steps=iters)
            best = min(best, time.perf_counter() - t0)
    return best / iters


def param_count(ex) -> int:
    return sum(int(p.numel()) for g in ex.params.values() for p in g.values())
