"""Metrics (port of ``flexflow_tpu/runtime/metrics.py``): per-batch sums
computed on the device; the host accumulates them in ``PerfMetrics``."""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import torch

from ..core.types import MetricsType


@dataclasses.dataclass
class PerfMetrics:
    """Accumulated training metrics (reference: PerfMetrics struct)."""

    train_all: int = 0
    train_correct: int = 0
    cce_loss: float = 0.0
    sparse_cce_loss: float = 0.0
    mse_loss: float = 0.0
    rmse_loss: float = 0.0
    mae_loss: float = 0.0

    def update(self, other: Dict[str, float]):
        self.train_all += int(other.get("count", 0))
        self.train_correct += int(other.get("correct", 0))
        for k in ("cce_loss", "sparse_cce_loss", "mse_loss", "rmse_loss", "mae_loss"):
            if k in other:
                setattr(self, k, getattr(self, k) + float(other[k]))

    @property
    def accuracy(self) -> float:
        return self.train_correct / max(1, self.train_all)


def compute_metrics(
    metrics: Sequence[MetricsType], preds: torch.Tensor, labels: torch.Tensor
) -> Dict[str, torch.Tensor]:
    """Batch metric sums (tensors on the batch's device)."""
    out: Dict[str, torch.Tensor] = {"count": torch.tensor(preds.shape[0])}
    pf = preds.float()
    for m in metrics:
        if m == MetricsType.ACCURACY:
            if labels.dim() == preds.dim() and labels.shape[-1] == preds.shape[-1]:
                correct = pf.argmax(-1) == labels.argmax(-1)
            else:
                lab = labels[..., 0] if labels.dim() == preds.dim() else labels
                correct = pf.argmax(-1) == lab.long()
            out["correct"] = correct.sum()
        elif m == MetricsType.CATEGORICAL_CROSSENTROPY:
            out["cce_loss"] = -(labels.float() * torch.log(pf.clamp(1e-8, 1.0))).sum()
        elif m == MetricsType.SPARSE_CATEGORICAL_CROSSENTROPY:
            lab = labels[..., 0] if labels.dim() == preds.dim() else labels
            ll = torch.log(pf.clamp(1e-8, 1.0)).gather(-1, lab.long()[..., None])
            out["sparse_cce_loss"] = -ll.sum()
        elif m == MetricsType.MEAN_SQUARED_ERROR:
            out["mse_loss"] = (pf - labels.float()).square().sum()
        elif m == MetricsType.ROOT_MEAN_SQUARED_ERROR:
            out["rmse_loss"] = (pf - labels.float()).square().mean().sqrt() * preds.shape[0]
        elif m == MetricsType.MEAN_ABSOLUTE_ERROR:
            out["mae_loss"] = (pf - labels.float()).abs().sum()
    return out
