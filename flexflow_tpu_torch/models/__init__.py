"""Model configurations and builders."""
from .moe import build_moe_mlp
from .nmt import build_nmt
from .recommender import build_candle_uno, build_dlrm, build_mlp_unify, build_xdl
from .transformer import (
    BERT_BASE,
    BERT_LARGE,
    TransformerConfig,
    attention_decoder_layer,
    attention_encoder_layer,
    build_transformer,
    build_transformer_seq2seq,
)
from .vision import build_alexnet, build_inception_v3, build_resnet50, build_resnext50

__all__ = [
    "BERT_BASE",
    "BERT_LARGE",
    "TransformerConfig",
    "attention_decoder_layer",
    "attention_encoder_layer",
    "build_alexnet",
    "build_candle_uno",
    "build_dlrm",
    "build_inception_v3",
    "build_mlp_unify",
    "build_moe_mlp",
    "build_nmt",
    "build_resnet50",
    "build_resnext50",
    "build_transformer",
    "build_transformer_seq2seq",
    "build_xdl",
]
