"""Speculative acceptance: exact verification of drafted windows (port of
``flexflow_tpu/generation/speculative/sampling.py``).

Leviathan et al. 2023: score k drafted tokens with ONE target forward,
accept the longest prefix the target agrees with, and emit one extra
token from the target's own distribution at the first disagreement (the
correction) or after a fully-accepted window (the bonus) — so every window
emits between 1 and k+1 tokens and the output distribution is EXACTLY
the target model's.

* **Greedy** (``temperature <= 0``): a draft is accepted iff it equals
  the target argmax, so a speculative greedy stream is token-for-token
  the non-speculative one, whatever the drafter proposes.
* **Temperature/top-k sampling**: rejection sampling against a
  point-mass proposal (both drafters propose deterministically): draft
  ``d`` with target probability ``p(d)`` is accepted with probability
  ``p(d)``; on the first rejection the emitted token is drawn from the
  normalised residual (``p`` with ``d`` excluded); after a fully-accepted
  window the bonus token is drawn from ``p``.

Constrained decoding composes with both regimes without touching this
module: the engine adds the same grammar rows to the logits at every
window position before acceptance, so the masked target is still a
distribution over the grammar's support and the identities above hold
over it; a banned draft has ``p(d) = 0`` and is rejected with certainty
(the scheduler also cuts drafts to their longest legal prefix first).

Keys are the JAX package's, bit for bit (threefry, ``prng.py``): the
token at generated-token count ``n`` consumes keys derived only from
``key_n = fold_in(key(seed), n)`` — the accept coin ``uniform(fold_in(
key_n, 1))``, the residual draw ``gumbel(fold_in(key_n, 2), (V,))`` and
the bonus draw ``gumbel(key_n, (V,))``, the raw key — which makes a
zero-draft verify step sample *identically* to the engine's decode step
(the same Gumbel trick on the same key, through the engine's own
``topk_scaled_logits``). Keys are ``prng.Key`` pairs of int64 tensors,
batched over their leading axes.

Every function is a composition of device tensor ops with no host sync,
so the engine's verify step captures it into its CUDA graph.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .. import prng
from ..engine import topk_scaled_logits


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` over the last axis, written as JAX writes it."""
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def residual_distribution(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Normalised rejection residual ``max(p - q, 0)`` over the last
    axis. Degenerate case (q covers p everywhere, so rejection has
    probability zero): fall back to ``p`` instead of NaN."""
    res = (p - q).clamp_min(0.0)
    total = res.sum(dim=-1, keepdim=True)
    return torch.where(total > 1e-12, res / total.clamp_min(1e-30), p)


def rejection_sample(
    p: torch.Tensor, q: torch.Tensor, draft: torch.Tensor, key: prng.Key
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One general-proposal rejection-sampling step: accept ``draft``
    with probability ``min(1, p[draft] / q[draft])``, else sample from the
    normalised residual. ``p``/``q``: [..., V] target and proposal
    probabilities; ``draft`` [...] and ``key`` [...] over the same leading
    axes (none for one step). Returns (token, accepted) — the marginal of
    ``token`` is exactly ``p`` for ANY proposal ``q``."""
    idx = draft.long()[..., None]
    p_d = torch.gather(p, -1, idx)[..., 0]
    q_d = torch.gather(q, -1, idx)[..., 0].clamp_min(1e-30)
    u = prng.uniform(prng.fold_in(key, 1), ())
    accepted = u < (p_d / q_d).clamp_max(1.0)
    res = residual_distribution(p, q)
    gumbel = prng.gumbel(prng.fold_in(key, 2), (p.shape[-1],))
    resampled = torch.argmax(torch.log(res.clamp_min(1e-30)) + gumbel, dim=-1)
    return torch.where(accepted, draft.long(), resampled).to(torch.int32), accepted


def speculative_accept(
    logits: torch.Tensor,
    draft_tokens: torch.Tensor,
    n_draft: torch.Tensor,
    temps: torch.Tensor,
    top_ks: torch.Tensor,
    keys: prng.Key,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Vectorised window acceptance for the engine's verify step.

    logits: [B, W, V] target logits over the window (index ``j`` scores
    the token at emitted-count offset ``j``); draft_tokens: [B, W-1]
    (point-mass proposals; entries past ``n_draft`` ignored); n_draft:
    [B] in [0, W-1]; temps/top_ks: [B]; keys: [B, W], one per
    emitted-count offset (``engine.derive_window_keys``).

    Returns (out_tokens [B, W] int32, n_emitted [B] int32):
    ``out_tokens[b, :a+1]`` are the emitted tokens where ``a`` is the
    accepted-prefix length — accepted drafts followed by the correction
    (first rejection) or bonus (full acceptance) token; entries past
    ``n_emitted`` are garbage. ``n_draft == 0`` degenerates to exactly
    the engine's non-speculative sampling of one token with ``keys[:, 0]``.
    """
    b, w, v = logits.shape
    kd = w - 1
    greedy = temps <= 0.0
    offs = torch.arange(w, device=logits.device)[None, :]
    # the engine's own sampling transform, broadcast over the window —
    # sharing it keeps zero-draft verify bit-identical to decode
    masked = topk_scaled_logits(logits, temps[:, None].expand(b, w), top_ks[:, None].expand(b, w))
    p = _softmax(masked)  # [B, W, V] target sampling distribution
    g = torch.argmax(logits, dim=-1)  # [B, W] greedy chain

    # -- acceptance of each draft (point-mass proposal) ------------------
    d = draft_tokens.long()  # [B, kd]
    p_d = torch.gather(p[:, :kd], -1, d[..., None])[..., 0]  # [B, kd]
    draft_keys = (keys[0][:, :kd], keys[1][:, :kd])  # the keys of the drafted offsets
    u = prng.uniform(prng.fold_in(draft_keys, 1), ())  # [B, kd]
    acc = torch.where(greedy[:, None], d == g[:, :kd], u < p_d)
    acc = acc & (offs[:, :kd] < n_draft[:, None])
    a = torch.cumprod(acc.to(torch.int32), dim=1).sum(dim=1)  # [B]

    # -- correction / bonus token at every offset (selected at j == a) ---
    # residual draw (rejection at offset j < n_draft): p_j minus the
    # drafted token's mass, renormalised
    q = torch.zeros_like(p[:, :kd]).scatter_(-1, d[..., None], p_d[..., None])
    res = residual_distribution(p[:, :kd], q)
    res_gumbel = prng.gumbel(prng.fold_in(draft_keys, 2), (v,))
    r_res = torch.argmax(torch.log(res.clamp_min(1e-30)) + res_gumbel, dim=-1)  # [B, kd]
    zero = torch.zeros((b, 1), dtype=torch.int64, device=logits.device)
    r_res = torch.cat([r_res, zero], dim=1)
    # bonus draw (offset j == n_draft, nothing proposed): sample from p_j
    # with the RAW key — byte-identical to the engine's decode sampling
    r_bonus = torch.argmax(masked + prng.gumbel(keys, (v,)), dim=-1)  # [B, W]
    corr = torch.where(offs < n_draft[:, None], r_res, r_bonus)
    corr = torch.where(greedy[:, None], g, corr)

    # -- emitted tokens: accepted drafts then the correction/bonus -------
    out = torch.where(offs < a[:, None], torch.cat([d, zero], dim=1), corr)
    out = torch.where(greedy[:, None], g, out)  # accepted greedy drafts ARE g
    return out.to(torch.int32), (a + 1).to(torch.int32)
