"""Decoder-only transformer for the generation engine (port of
``flexflow_tpu/generation/decoder.py``): a dictionary of parameter
tensors + four forwards that provably agree.

The layer recipe is the JAX package's: pre-LN residual blocks, a GELU
FFN (the tanh approximation, ``jax.nn.gelu``'s default), the
ops/attention.py weight layouts ([E, H, D] projections, [H, D, E]
output), a learned absolute position embedding, and a token embedding
front end with an LM head.

* :func:`forward_full` — full-context causal forward, [B, S] -> logits
  [B, S, V]. The parity oracle.
* :func:`prefill` — forward_full that also returns every layer's K/V
  ([L, B, S, H, D]) for the engine to scatter into the block cache.
* :func:`decode_step` — one token per sequence against the cache (writes
  the token's K/V, then decode-mode attention), [B] -> logits [B, V].
* :func:`verify_step` — a W-token append window per sequence against the
  cache, [B, W] -> logits [B, W, V]; W sequential decode_steps in one
  call, with identical logits.

``decode_step`` and ``verify_step`` write K/V into ``cache_k``/``cache_v``
IN PLACE (the JAX forwards return new arrays); they return the same
tensors so the call shape matches the JAX package.

Tensor parallelism (``sharding.py``): every forward takes ``tp``, the
calling rank's :class:`~.sharding.RankContext`, or None on one device.
With ``tp`` the parameters and the caches are the rank's slices (H/N
heads; the FFN's F/N columns when it is sharded) and each layer runs two
sum all-reduces: after the head-split output projection and after the
row-split FFN down projection (none there when the FFN stays whole). The
down projection's bias and the residuals are added once, after the
reduce, so every rank holds the same activations, logits and samples.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..models.transformer import TransformerConfig
from ..ops.attention import append_attention_core, decode_attention_core, masked_attention
from .cache import slot_mapping

# a decoder is a plain dictionary of tensors, laid out like the JAX pytree
DecoderParams = Dict[str, Any]


def _glorot(gen: torch.Generator, shape) -> torch.Tensor:
    fan_in, fan_out = shape[0], shape[-1]
    if len(shape) == 3:  # [E, H, D] / [H, D, E] projections
        fan_in = shape[0] if shape[0] > shape[2] else shape[0] * shape[1]
        fan_out = shape[1] * shape[2] if shape[0] > shape[2] else shape[2]
    lim = (6.0 / (fan_in + fan_out)) ** 0.5
    u = torch.rand(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return u * (2 * lim) - lim


def init_decoder_params(
    gen: torch.Generator,
    cfg: TransformerConfig,
    max_positions: Optional[int] = None,
) -> DecoderParams:
    """Initialize the decoder's parameters for ``cfg`` (``vocab_size`` >
    0) from ``gen``, with the JAX package's distributions (its bits
    differ: compare the two packages on weights converted with
    :func:`~flexflow_tpu_torch.generation.convert.decoder_params_from_numpy`).
    Tensors are made on the generator's device."""
    if cfg.vocab_size <= 0:
        raise ValueError("generation decoder needs cfg.vocab_size > 0")
    e, h = cfg.hidden_size, cfg.num_heads
    d = e // h
    f, v = cfg.ff_size, cfg.vocab_size
    p = max_positions or cfg.seq_length

    def ones(n):
        return torch.ones((n,), dtype=torch.float32, device=gen.device)

    def zeros(n):
        return torch.zeros((n,), dtype=torch.float32, device=gen.device)

    params: DecoderParams = {
        "tok_embed": _glorot(gen, (v, e)),
        "pos_embed": 0.02 * torch.randn((p, e), generator=gen, device=gen.device),
        "final_ln_g": ones(e),
        "final_ln_b": zeros(e),
        "lm_head": _glorot(gen, (e, v)),
        "layers": [],
    }
    for _ in range(cfg.num_layers):
        params["layers"].append(
            {
                "ln1_g": ones(e),
                "ln1_b": zeros(e),
                "wq": _glorot(gen, (e, h, d)),
                "wk": _glorot(gen, (e, h, d)),
                "wv": _glorot(gen, (e, h, d)),
                "wo": _glorot(gen, (h, d, e)),
                "ln2_g": ones(e),
                "ln2_b": zeros(e),
                "ff1": _glorot(gen, (e, f)),
                "ff1_b": zeros(f),
                "ff2": _glorot(gen, (f, e)),
                "ff2_b": zeros(e),
            }
        )
    return params


def params_to(params: DecoderParams, device) -> DecoderParams:
    """The same parameter dictionary with every tensor on ``device``."""
    out = {k: v.to(device) for k, v in params.items() if k != "layers"}
    out["layers"] = [{k: t.to(device) for k, t in layer.items()} for layer in params["layers"]]
    return out


def _ln(x, g, b, eps=1e-5):
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * g + b


def _embed(params, tokens, positions):
    return params["tok_embed"][tokens.long()] + params["pos_embed"][positions.long()]


def _ffn(layer, x, tp=None):
    h = _ln(x, layer["ln2_g"], layer["ln2_b"])
    h = F.gelu(h @ layer["ff1"] + layer["ff1_b"], approximate="tanh")
    if tp is not None and tp.ffn_sharded:
        # the row-split down projection's partial sums, reduced before
        # the bias (added once)
        return x + tp.all_reduce(h @ layer["ff2"]) + layer["ff2_b"]
    return x + h @ layer["ff2"] + layer["ff2_b"]


def _heads(x, w):
    """x [..., E] @ w [E, H, D] -> [..., H, D]."""
    e, h, d = w.shape
    return (x @ w.reshape(e, h * d)).reshape(*x.shape[:-1], h, d)


def _merge(ctx, wo, tp=None):
    """ctx [..., H, D] @ wo [H, D, E] -> [..., E]; with ``tp``, the
    ranks' partial sums over their heads, reduced."""
    h, d, e = wo.shape
    out = ctx.reshape(*ctx.shape[:-2], h * d) @ wo.reshape(h * d, e)
    return out if tp is None else tp.all_reduce(out)


def _write_kv(cache, layer_idx, slots, kv):
    """Scatter ``kv`` [N, H, D] into layer ``layer_idx``'s flat slots
    (in place). Duplicate slots only ever hit scratch block 0, whose
    content is never read unmasked."""
    flat = cache[layer_idx].view(-1, *cache.shape[3:])
    flat[slots.long()] = kv.to(flat.dtype)


def forward_full(
    params: DecoderParams,
    tokens: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
    tp=None,
) -> torch.Tensor:
    """Full-context causal forward: [B, S] int -> logits [B, S, V].
    ``lengths`` masks padded key positions (bucketed prompts)."""
    logits, _, _ = _forward(params, tokens, lengths, keep_kv=False, tp=tp)
    return logits


def _forward(params, tokens, lengths, keep_kv, tp=None):
    b, s = tokens.shape
    pos = torch.arange(s, device=tokens.device)[None, :]
    x = _embed(params, tokens, pos)
    lens = lengths if lengths is not None else torch.full((b,), s, device=tokens.device)
    ks, vs = [], []
    for layer in params["layers"]:
        h = _ln(x, layer["ln1_g"], layer["ln1_b"])
        q = _heads(h, layer["wq"])
        k = _heads(h, layer["wk"])
        v = _heads(h, layer["wv"])
        if keep_kv:
            ks.append(k)
            vs.append(v)
        ctx = masked_attention(q, k, v, lens, causal=True)
        x = x + _merge(ctx, layer["wo"], tp)
        x = _ffn(layer, x, tp)
    x = _ln(x, params["final_ln_g"], params["final_ln_b"])
    return x @ params["lm_head"], ks, vs


def prefill(
    params: DecoderParams,
    tokens: torch.Tensor,
    lengths: torch.Tensor,
    tp=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Prefill forward: logits [B, S, V] plus every layer's K/V
    ([L, B, S, H, D] each; with ``tp``, the rank's heads) for the engine
    to write into the cache."""
    logits, ks, vs = _forward(params, tokens, lengths, keep_kv=True, tp=tp)
    return logits, torch.stack(ks), torch.stack(vs)


def decode_step(
    params: DecoderParams,
    tokens: torch.Tensor,
    positions: torch.Tensor,
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    block_tables: torch.Tensor,
    context_lens: torch.Tensor,
    backend: str = "auto",
    tp=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step for every batch slot.

    tokens/positions: [B] int32 (the token being decoded and its cache
    position); cache_k/cache_v: [L, num_blocks, block_size, H, D];
    block_tables: [B, max_blocks] int32; context_lens: [B] int32 — valid
    cache positions INCLUDING this token (``positions + 1`` for live
    slots, 0 for inactive ones, whose writes land in scratch block 0).
    Returns (logits [B, V], cache_k, cache_v); the token's K/V is written
    into the caches in place. ``backend`` is
    :func:`~flexflow_tpu_torch.ops.attention.decode_attention_core`'s.
    """
    bs = cache_k.shape[2]
    x = _embed(params, tokens, positions)  # [B, E]
    slots = slot_mapping(block_tables, positions, bs)
    for li, layer in enumerate(params["layers"]):
        h = _ln(x, layer["ln1_g"], layer["ln1_b"])
        q = _heads(h, layer["wq"])
        k = _heads(h, layer["wk"])
        v = _heads(h, layer["wv"])
        # write this token's K/V, then attend over the updated cache so
        # the token sees itself (context_lens includes it)
        _write_kv(cache_k, li, slots, k)
        _write_kv(cache_v, li, slots, v)
        ctx = decode_attention_core(
            q, cache_k[li], cache_v[li], block_tables, context_lens, backend=backend,
            shard=tp,
        )
        x = x + _merge(ctx, layer["wo"], tp)
        x = _ffn(layer, x, tp)
    x = _ln(x, params["final_ln_g"], params["final_ln_b"])
    return x @ params["lm_head"], cache_k, cache_v


def verify_step(
    params: DecoderParams,
    tokens: torch.Tensor,
    positions: torch.Tensor,
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    block_tables: torch.Tensor,
    backend: str = "auto",
    tp=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One chunked-append (speculative verification) step for every
    batch slot.

    tokens/positions: [B, W] int32 — the window being scored and each
    window token's cache position. ``positions < 0`` marks padding
    window slots: their K/V scatter to scratch block 0 and their logits
    rows are meaningless. Returns (logits [B, W, V], cache_k, cache_v)
    with all W tokens' K/V written in place.
    """
    bs = cache_k.shape[2]
    safe_pos = positions.clamp_min(0)
    x = _embed(params, tokens, safe_pos)  # [B, W, E]
    slots = slot_mapping(block_tables, safe_pos, bs)
    slots = torch.where(positions >= 0, slots, torch.zeros_like(slots))  # padding -> scratch
    flat_slots = slots.reshape(-1)
    for li, layer in enumerate(params["layers"]):
        h = _ln(x, layer["ln1_g"], layer["ln1_b"])
        q = _heads(h, layer["wq"])
        k = _heads(h, layer["wk"])
        v = _heads(h, layer["wv"])
        # write the whole window's K/V, then attend with per-query
        # position masks (each token sees itself and everything before)
        _write_kv(cache_k, li, flat_slots, k.reshape(-1, *k.shape[2:]))
        _write_kv(cache_v, li, flat_slots, v.reshape(-1, *v.shape[2:]))
        ctx = append_attention_core(
            q, cache_k[li], cache_v[li], block_tables, positions, backend=backend,
            shard=tp,
        )
        x = x + _merge(ctx, layer["wo"], tp)
        x = _ffn(layer, x, tp)
    x = _ln(x, params["final_ln_g"], params["final_ln_b"])
    return x @ params["lm_head"], cache_k, cache_v
