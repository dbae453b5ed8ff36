"""NMT: LSTM sequence-to-sequence translation model (port of
``flexflow_tpu/models/nmt.py``, with its names, defaults and layer names).

Reference: nmt/ (3980 LoC) — the legacy standalone LSTM/RNN NMT app
(embed -> stacked LSTM encoder -> stacked LSTM decoder -> per-token
softmax over the target vocabulary, GRAD_NCCL gradient sync). Built here
on the FFModel graph with the recurrent ops plus global dot-product
attention (Luong-style) composed from batch_matmul/softmax/concat —
attention is graph-level (two batch matmuls, a softmax, a concat and a
dense layer). The model runs on the GPU unless ``device="cpu"``.
"""
from __future__ import annotations

from ..config import FFConfig
from ..core.types import DataType
from ..model import FFModel


def build_nmt(
    config: FFConfig,
    src_vocab: int = 32000,
    tgt_vocab: int = 32000,
    embed_dim: int = 256,
    hidden_size: int = 256,
    num_layers: int = 2,
    src_len: int = 32,
    tgt_len: int = 32,
    attention: bool = True,
    device=None,
) -> FFModel:
    """Teacher-forced training graph: inputs are (src_tokens [B, S],
    tgt_in_tokens [B, T]); the label is tgt_out tokens [B, T] (the target
    sentence shifted by one)."""
    model = FFModel(config, device=device)
    b = config.batch_size
    src = model.create_tensor([b, src_len], dtype=DataType.INT32, name="src_tokens")
    tgt = model.create_tensor([b, tgt_len], dtype=DataType.INT32, name="tgt_in_tokens")

    # encoder: embedding + LSTM stack
    enc = model.embedding(src, src_vocab, embed_dim, name="src_embed")
    enc_states = []
    for l in range(num_layers):
        enc, h, c = model.lstm(enc, hidden_size, name=f"enc_lstm{l}")
        enc_states.append((h, c))

    # decoder: embedding + LSTM stack initialized from encoder finals
    dec = model.embedding(tgt, tgt_vocab, embed_dim, name="tgt_embed")
    for l in range(num_layers):
        h, c = enc_states[l]
        dec, _, _ = model.lstm(dec, hidden_size, initial_h=h, initial_c=c, name=f"dec_lstm{l}")

    if attention:
        # Luong global attention: scores[B,T,S] = dec @ enc^T
        enc_t = model.transpose(enc, (0, 2, 1), name="enc_T")
        scores = model.batch_matmul(dec, enc_t, name="attn_scores")
        attn = model.softmax(scores, axis=-1, name="attn_weights")
        context = model.batch_matmul(attn, enc, name="attn_context")
        dec = model.concat([dec, context], axis=-1, name="attn_concat")
        dec = model.dense(dec, hidden_size, activation="tanh", name="attn_proj")

    logits = model.dense(dec, tgt_vocab, name="tgt_proj")
    model.softmax(logits, axis=-1, name="tgt_probs")
    return model
