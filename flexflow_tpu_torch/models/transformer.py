"""Transformer configuration (port of the ``TransformerConfig`` dataclass
in ``flexflow_tpu/models/transformer.py``; the graph builders stay with
the training slice)."""
from __future__ import annotations

import dataclasses

from ..core.types import DataType


@dataclasses.dataclass
class TransformerConfig:
    num_layers: int = 12
    hidden_size: int = 768
    num_heads: int = 12
    ff_size: int = 3072
    seq_length: int = 512
    vocab_size: int = 0  # 0 -> raw float inputs like the reference example
    num_classes: int = 0  # 0 -> LM head over vocab (or identity if no vocab)
    dropout: float = 0.0
    causal: bool = False
    dtype: DataType = DataType.FLOAT
