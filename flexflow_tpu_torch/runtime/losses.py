"""Loss functions (port of ``flexflow_tpu/runtime/losses.py``): scalar
losses, mean over the batch, computed in fp32; autograd makes the
output gradients."""
from __future__ import annotations

from typing import Callable

import torch

from ..core.types import LossType


def categorical_crossentropy(probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Labels are one-hot/probability distributions [B, C]; the input is
    a softmax output."""
    p = probs.float().clamp(1e-8, 1.0)
    return -(labels.float() * torch.log(p)).sum(dim=-1).mean()


def sparse_categorical_crossentropy(probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Labels are int class ids [B] (or [B, 1]); the input is a softmax output."""
    if labels.dim() == probs.dim():
        labels = labels[..., 0]
    p = probs.float().clamp(1e-8, 1.0)
    return -torch.log(p).gather(-1, labels.long()[..., None]).mean()


def mean_squared_error(preds: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (preds.float() - labels.float()).square().mean()


def sum_squared_error(preds: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (preds.float() - labels.float()).square().sum()


def identity_loss(preds: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Reference: LOSS_IDENTITY — the model's output *is* the loss."""
    return preds.float().mean()


def get_loss_fn(loss_type: LossType) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    return {
        LossType.CATEGORICAL_CROSSENTROPY: categorical_crossentropy,
        LossType.SPARSE_CATEGORICAL_CROSSENTROPY: sparse_categorical_crossentropy,
        LossType.MEAN_SQUARED_ERROR: mean_squared_error,
        LossType.MEAN_SQUARED_ERROR_AVG_REDUCE: mean_squared_error,
        LossType.MEAN_SQUARED_ERROR_SUM_REDUCE: sum_squared_error,
        LossType.IDENTITY: identity_loss,
    }[loss_type]
