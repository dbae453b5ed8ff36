"""Transformer / BERT model family (port of
``flexflow_tpu/models/transformer.py``: the configuration, the encoder
block and the encoder-stack builder over raw [batch, seq, hidden]
inputs).

Token embeddings, the classification and LM heads (Embedding, Split,
Reshape, Softmax), dropout and the seq2seq builder wait for their ops.
"""
from __future__ import annotations

import dataclasses

from ..config import FFConfig
from ..core.types import ActiMode, DataType


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


# BERT-Large (scripts/osdi22ae/bert.sh target config)
BERT_LARGE = TransformerConfig(num_layers=24, hidden_size=1024, num_heads=16, ff_size=4096)
BERT_BASE = TransformerConfig(num_layers=12, hidden_size=768, num_heads=12, ff_size=3072)


def attention_encoder_layer(model, t, cfg: TransformerConfig, idx: int):
    """One encoder block (reference: create_attention_encoder,
    transformer.cc — attention + 2 dense; here with pre-LN residuals)."""
    h = model.layer_norm(t, name=f"l{idx}_ln1")
    attn = model.multihead_attention(
        h, h, h, cfg.hidden_size, cfg.num_heads,
        dropout=cfg.dropout, causal=cfg.causal, name=f"l{idx}_attn",
    )
    t = model.add(t, attn, name=f"l{idx}_res1")
    h = model.layer_norm(t, name=f"l{idx}_ln2")
    h = model.dense(h, cfg.ff_size, ActiMode.GELU, name=f"l{idx}_ff1")
    h = model.dense(h, cfg.hidden_size, name=f"l{idx}_ff2")
    return model.add(t, h, name=f"l{idx}_res2")


def build_transformer(config: FFConfig, cfg: TransformerConfig = BERT_BASE, device=None):
    """The encoder stack over raw [batch, seq, hidden] float inputs, a
    final LayerNorm and a dense layer back to hidden (the reference
    example's shape). ``device`` is passed to :class:`FFModel`."""
    from ..model import FFModel

    if cfg.vocab_size > 0 or cfg.num_classes > 0:
        raise NotImplementedError(
            "token embeddings and classification/LM heads are not ported; "
            "use vocab_size=0 and num_classes=0"
        )
    if cfg.dropout > 0:
        raise NotImplementedError("dropout is not ported; use dropout=0")
    model = FFModel(config, device=device)
    b, s, e = config.batch_size, cfg.seq_length, cfg.hidden_size
    t = model.create_tensor((b, s, e), cfg.dtype, name="embeddings")
    for i in range(cfg.num_layers):
        t = attention_encoder_layer(model, t, cfg, i)
    t = model.layer_norm(t, name="final_ln")
    model.dense(t, e, name="out_proj")
    return model
