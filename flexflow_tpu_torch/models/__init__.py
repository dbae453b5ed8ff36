"""Model configurations and builders."""
from .transformer import (
    BERT_BASE,
    BERT_LARGE,
    TransformerConfig,
    attention_encoder_layer,
    build_transformer,
)

__all__ = [
    "BERT_BASE",
    "BERT_LARGE",
    "TransformerConfig",
    "attention_encoder_layer",
    "build_transformer",
]
