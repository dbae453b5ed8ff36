"""Drafters: cheap token proposers for speculative decoding (port of
``flexflow_tpu/generation/speculative/drafter.py``).

A drafter guesses the next ``k`` tokens of a sequence; the target model
verifies the whole guess in one fixed-shape step (``engine.verify``).
Because verification is exact (``sampling.py``), a drafter can NEVER
change what tokens come out — only how many engine steps they take. Both
drafters propose deterministically (point-mass proposals): a proposal is
a pure function of the sequence prefix, so replay after preemption is
deterministic.

* :class:`NgramDrafter` — model-free prompt-lookup decoding: find the most
  recent earlier occurrence of the sequence's trailing n-gram and propose
  the tokens that followed it. Zero extra FLOPs.
* :class:`DraftModelDrafter` — a small decoder (the same parameter
  dictionary layout as the target) greedily proposes ``k`` tokens through
  its padded full forward, one shape per prompt bucket. It runs eagerly,
  token by token, on its parameters' device.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch

from ..decoder import DecoderParams, forward_full
from ..engine import default_buckets


@dataclasses.dataclass(frozen=True)
class SpeculationConfig:
    """Per-request speculation policy.

    ``k`` is the MAXIMUM drafted tokens per window (clamped to the
    engine's verify window); the scheduler adapts the live k inside
    [1, k] when ``adaptive`` — shrinking while the acceptance EMA sits
    below ``low_acceptance``, regrowing above ``high_acceptance`` — and
    additionally caps any single window on cache pressure.
    """

    enabled: bool = True
    k: int = 4
    method: str = "ngram"  # "ngram" | "draft_model"
    max_ngram: int = 3
    min_ngram: int = 1
    adaptive: bool = True
    low_acceptance: float = 0.3
    high_acceptance: float = 0.8
    ema_alpha: float = 0.5

    def __post_init__(self):
        if self.k < 1:
            raise ValueError("speculation k must be >= 1")
        if self.method not in ("ngram", "draft_model"):
            raise ValueError(f"unknown speculation method {self.method!r}")
        if not 1 <= self.min_ngram <= self.max_ngram:
            raise ValueError("need 1 <= min_ngram <= max_ngram")


class Drafter:
    """Interface: propose up to ``k`` next tokens for ``prefix``.

    ``propose`` must be a pure function of ``prefix`` (no hidden state,
    no randomness) so preempt-and-recompute replays identically. It may
    return fewer than ``k`` tokens — including none, which degrades that
    window to a plain (still exact) decode step.
    """

    def propose(self, prefix: Sequence[int], k: int) -> List[int]:
        raise NotImplementedError


class NgramDrafter(Drafter):
    """Prompt-lookup decoding: match the prefix's trailing n-gram
    (longest first, ``max_ngram`` down to ``min_ngram``) against the
    MOST RECENT earlier occurrence in the prefix and propose the tokens
    that followed it. ``max_lookback`` bounds the scan to the prefix's
    trailing window (still a pure function of the prefix)."""

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1, max_lookback: int = 512):
        if not 1 <= min_ngram <= max_ngram:
            raise ValueError("need 1 <= min_ngram <= max_ngram")
        if max_lookback < min_ngram + 1:
            raise ValueError("max_lookback must cover at least one n-gram + continuation")
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram
        self.max_lookback = max_lookback

    def propose(self, prefix: Sequence[int], k: int) -> List[int]:
        seq = list(prefix)[-self.max_lookback:]
        n = len(seq)
        if k <= 0 or n < self.min_ngram + 1:
            return []
        for size in range(min(self.max_ngram, n - 1), self.min_ngram - 1, -1):
            pattern = seq[n - size:]
            # most recent earlier occurrence: scan right-to-left; the
            # match must end BEFORE the final position so a continuation
            # exists
            for start in range(n - size - 1, -1, -1):
                if seq[start:start + size] == pattern:
                    cont = seq[start + size:start + size + k]
                    if cont:
                        return [int(t) for t in cont]
        return []


class DraftModelDrafter(Drafter):
    """Greedy proposals from a small draft decoder: its full forward over
    the (bucket-padded) prefix once per proposed token — k small-model
    forwards to save up to k large-model steps."""

    def __init__(
        self,
        params: DecoderParams,
        max_seq_len: int,
        buckets: Optional[Sequence[int]] = None,
    ):
        self.params = params
        self.max_seq_len = max_seq_len
        self.buckets = tuple(sorted(buckets or default_buckets(max_seq_len)))
        self.device = params["tok_embed"].device

    def _last_logits(self, seq: List[int]) -> torch.Tensor:
        bucket = next((b for b in self.buckets if len(seq) <= b), self.buckets[-1])
        tokens = torch.zeros((1, bucket), dtype=torch.int32)
        tokens[0, : len(seq)] = torch.tensor(seq, dtype=torch.int32)
        lengths = torch.full((1,), len(seq), dtype=torch.int32, device=self.device)
        return forward_full(self.params, tokens.to(self.device), lengths)[0, len(seq) - 1]

    def propose(self, prefix: Sequence[int], k: int) -> List[int]:
        seq = list(prefix)
        out: List[int] = []
        while len(out) < k and len(seq) < self.max_seq_len and len(seq) <= self.buckets[-1]:
            out.append(int(torch.argmax(self._last_logits(seq))))
            seq.append(out[-1])
        return out


def build_drafter(
    config: SpeculationConfig,
    draft_params: Optional[DecoderParams] = None,
    max_seq_len: int = 0,
) -> Drafter:
    """Drafter factory for a request's SpeculationConfig."""
    if config.method == "ngram":
        return NgramDrafter(max_ngram=config.max_ngram, min_ngram=config.min_ngram)
    if draft_params is None:
        raise ValueError(
            "speculation method 'draft_model' needs draft params "
            "(ContinuousBatchingScheduler(draft_params=...))"
        )
    return DraftModelDrafter(draft_params, max_seq_len)
