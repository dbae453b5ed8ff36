"""The DataLoader's gather on the card: the native threaded row copy
against ``index_select``, in turns.

    PYTHONPATH=. python3 flexflow_tpu_torch/tools/loader_probe.py [--seed N] [--epochs 3]

Builds the CUDA kernels, then fp32 BERT-Base (12 x 768, seq 128, batch
32, SGD 0.01, MSE) fed by a shuffled DataLoader of 8 batches (as the
trainer phase of ``chip_smoke.py``). First the gather alone: each path's
host ms for one batch of the input and one of the label into pinned
memory, the best of 20. Then training epochs, the paths in turns (native,
index_select, index_select, native, ...), after one warm-up epoch of
each: ms a step of every epoch on the host clock (each loss read back).
Prints the card's name and power limit first and a JSON line last.
Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--epochs", type=int, default=3, help="timed epochs of each path")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    import chip_smoke as cs
    import flexflow_tpu_torch._native as native
    from flexflow_tpu_torch.config import FFConfig
    from flexflow_tpu_torch.core.types import DataType, LossType
    from flexflow_tpu_torch.models import build_transformer
    from flexflow_tpu_torch.ops.kernels import _build
    from flexflow_tpu_torch.runtime import SGDOptimizer
    from flexflow_tpu_torch.runtime import dataloader as dl

    if not torch.cuda.is_available():
        print("loader_probe: no CUDA device is available", file=sys.stderr)
        return 2
    card = cs.card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.load_library()
    native_gather = dl._get_native_gather()
    if native_gather is None:
        raise AssertionError("loader_probe: the native library did not load")

    def use(path: str) -> None:
        dl._native_gather = native_gather if path == "native" else False

    cfg = cs.bert_base(DataType.FLOAT)
    batch = 32
    model = build_transformer(FFConfig(batch_size=batch, seed=args.seed), cfg)
    model.compile(optimizer=SGDOptimizer(lr=0.01), loss_type=LossType.MEAN_SQUARED_ERROR)
    ex = model.executor
    n = 8 * batch
    rs = np.random.RandomState(args.seed + 5)
    hx = torch.from_numpy(rs.randn(n, cfg.seq_length, cfg.hidden_size).astype(np.float32))
    hy = torch.from_numpy(rs.randn(n, cfg.seq_length, cfg.hidden_size).astype(np.float32))
    loader = model.create_data_loader(hx, hy, batch_size=batch, shuffle=True, seed=args.seed)

    # the gather alone: one batch of input and label into pinned memory
    gather_ms = {}
    idx = np.random.RandomState(args.seed).permutation(n)[:batch]
    for path in ("native", "index_select"):
        use(path)
        best = float("inf")
        for _ in range(20):
            t0 = time.perf_counter()
            loader.loaders[0]._gather(idx)
            loader.label_loader._gather(idx)
            best = min(best, time.perf_counter() - t0)
        gather_ms[path] = 1e3 * best

    def epoch() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for ins, lab in loader.epoch():
            float(ex.train_batch(ins, lab)["loss"])
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / 8

    warm = {}
    for path in ("native", "index_select"):
        use(path)
        warm[path] = epoch()
    timed = {"native": [], "index_select": []}
    order = []
    for i in range(args.epochs):
        order += ["native", "index_select"] if i % 2 == 0 else ["index_select", "native"]
    native.reset_call_counts()
    for path in order:
        use(path)
        timed[path].append(epoch())
    use("native")
    out = {"card": card, "gather_ms_best_of_20": gather_ms, "warm_up_epoch_ms_per_step": warm,
           "order": order, "ms_per_step": timed, "native_calls": native.CALLS["batch_gather"]}
    print(f"{card}: DataLoader gather of one batch (input + label, 2 x 12.6 MB into pinned "
          f"memory), best of 20: native {gather_ms['native']:.3f} ms, index_select "
          f"{gather_ms['index_select']:.3f} ms; fp32 BERT-Base ms a step, warm-up epochs "
          f"native {warm['native']:.3f}, index_select {warm['index_select']:.3f}; in turns "
          + "; ".join(f"{p} " + ", ".join(f"{x:.3f}" for x in timed[p]) for p in timed))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
