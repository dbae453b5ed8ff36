"""Model configurations and builders."""
from .transformer import (
    BERT_BASE,
    BERT_LARGE,
    TransformerConfig,
    attention_decoder_layer,
    attention_encoder_layer,
    build_transformer,
    build_transformer_seq2seq,
)

__all__ = [
    "BERT_BASE",
    "BERT_LARGE",
    "TransformerConfig",
    "attention_decoder_layer",
    "attention_encoder_layer",
    "build_transformer",
    "build_transformer_seq2seq",
]
