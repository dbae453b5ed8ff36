"""Transformer / BERT model family (port of
``flexflow_tpu/models/transformer.py``: the configuration, the encoder
and decoder blocks, the encoder stack with its token embedding, its
classification or LM head and dropout, and the encoder-decoder
transformer).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

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
    if cfg.dropout > 0:
        h = model.dropout(h, cfg.dropout, name=f"l{idx}_drop")
    h = model.dense(h, cfg.hidden_size, name=f"l{idx}_ff2")
    return model.add(t, h, name=f"l{idx}_res2")


def attention_decoder_layer(model, t, enc, cfg: TransformerConfig, idx: int):
    """One decoder block: causal self-attention, cross-attention over the
    encoder output (its own sequence length), FFN, pre-LN residuals
    throughout."""
    h = model.layer_norm(t, name=f"d{idx}_ln1")
    attn = model.multihead_attention(
        h, h, h, cfg.hidden_size, cfg.num_heads,
        dropout=cfg.dropout, causal=True, name=f"d{idx}_self_attn",
    )
    t = model.add(t, attn, name=f"d{idx}_res1")
    h = model.layer_norm(t, name=f"d{idx}_ln2")
    cross = model.multihead_attention(
        h, enc, enc, cfg.hidden_size, cfg.num_heads,
        dropout=cfg.dropout, name=f"d{idx}_cross_attn",
    )
    t = model.add(t, cross, name=f"d{idx}_res2")
    h = model.layer_norm(t, name=f"d{idx}_ln3")
    h = model.dense(h, cfg.ff_size, ActiMode.GELU, name=f"d{idx}_ff1")
    if cfg.dropout > 0:
        h = model.dropout(h, cfg.dropout, name=f"d{idx}_drop")
    h = model.dense(h, cfg.hidden_size, name=f"d{idx}_ff2")
    return model.add(t, h, name=f"d{idx}_res3")


def build_transformer_seq2seq(
    config: FFConfig,
    cfg: TransformerConfig = BERT_BASE,
    num_decoder_layers: Optional[int] = None,
    src_seq_length: Optional[int] = None,
    device=None,
):
    """Encoder-decoder transformer (the machine-translation shape): the
    encoder stack over [batch, src_seq, hidden] source embeddings, the
    decoder stack over [batch, seq, hidden] target embeddings with causal
    self-attention and cross-attention over the final encoder output,
    then an LM head and softmax over ``vocab_size`` (or a dense layer
    back to hidden). ``device`` is passed to :class:`FFModel`."""
    from ..model import FFModel

    model = FFModel(config, device=device)
    b, s, e = config.batch_size, cfg.seq_length, cfg.hidden_size
    s_src = src_seq_length or s
    n_dec = num_decoder_layers if num_decoder_layers is not None else cfg.num_layers
    src = model.create_tensor((b, s_src, e), cfg.dtype, name="src_embeddings")
    tgt = model.create_tensor((b, s, e), cfg.dtype, name="tgt_embeddings")
    t = src
    for i in range(cfg.num_layers):
        t = attention_encoder_layer(model, t, cfg, i)
    enc = model.layer_norm(t, name="enc_final_ln")
    t = tgt
    for i in range(n_dec):
        t = attention_decoder_layer(model, t, enc, cfg, i)
    t = model.layer_norm(t, name="dec_final_ln")
    if cfg.vocab_size > 0:
        t = model.dense(t, cfg.vocab_size, name="lm_head")
        model.softmax(t)
    else:
        model.dense(t, e, name="out_proj")
    return model


def build_transformer(config: FFConfig, cfg: TransformerConfig = BERT_BASE, device=None):
    """The encoder stack over int32 tokens (``vocab_size`` > 0: a token
    embedding) or raw [batch, seq, hidden] floats, a final LayerNorm, then
    a head: with ``num_classes`` the BERT-CLS head (the first position,
    split off and squeezed, a dense layer and softmax), else with
    ``vocab_size`` an LM head and softmax, else a dense layer back to
    hidden (the reference example's shape). ``device`` is passed to
    :class:`FFModel`."""
    from ..model import FFModel

    model = FFModel(config, device=device)
    b, s, e = config.batch_size, cfg.seq_length, cfg.hidden_size
    if cfg.vocab_size > 0:
        tokens = model.create_tensor((b, s), DataType.INT32, name="tokens")
        t = model.embedding(tokens, cfg.vocab_size, e, datatype=cfg.dtype, name="tok_embed")
    else:
        t = model.create_tensor((b, s, e), cfg.dtype, name="embeddings")
    for i in range(cfg.num_layers):
        t = attention_encoder_layer(model, t, cfg, i)
    t = model.layer_norm(t, name="final_ln")
    if cfg.num_classes > 0:
        t = model.split(t, [1, cfg.seq_length - 1], axis=1, name="cls_split")[0]
        t = model.reshape(t, (b, e), name="cls_squeeze")
        t = model.dense(t, cfg.num_classes, name="cls_head")
        t = model.softmax(t)
    elif cfg.vocab_size > 0:
        t = model.dense(t, cfg.vocab_size, name="lm_head")
        t = model.softmax(t)
    else:
        t = model.dense(t, e, name="out_proj")
    return model
