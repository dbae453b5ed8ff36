"""Generation engine: prefill/decode split over the block KV cache (port
of the core of ``flexflow_tpu/generation/engine.py``).

The engine runs a FIXED family of step shapes, as the JAX engine's
compiled programs do:

* **prefill** — one shape per *prompt-length bucket* (the prompt padded
  up to the bucket; per-sequence length masking keeps logits identical
  to the unpadded forward);
* **decode** — ONE shape: always ``max_batch_slots`` sequences (inactive
  slots masked to scratch block 0), always the same block-table width.

PyTorch runs eagerly, so nothing is traced; ``trace_counts`` counts the
distinct input-shape signatures each step kind has run — what a
compiled program (or a captured CUDA graph) would be keyed on — so the
"steady-state decode never changes shape" property stays assertable.
``step_counts`` counts the engine steps issued.

Sampling (greedy / temperature / top-k) runs on the step's device.
A sampled row's Gumbel noise is JAX's: ``gumbel(fold_in(key(seed),
count), (V,))`` with threefry2x32 ported bit for bit (``prng.py``), keyed
by the request's seed and its generated-token count (:func:`derive_keys`,
as the JAX engine derives its keys). So a seeded temperature/top-k
stream is the JAX engine's stream from the same weights, and a request
preempted and recomputed resumes its exact stream. Greedy decoding is
token-identical to the JAX engine.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.types import DataType
from ..models.transformer import TransformerConfig
from .cache import BlockAllocator, CacheConfig, KVCache, slot_mapping
from . import prng
from .decoder import DecoderParams, decode_step, params_to, prefill

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling configuration.

    ``temperature <= 0`` means greedy (argmax); ``top_k <= 0`` disables
    the top-k filter. ``seed`` makes the request's sampling stream
    deterministic — preemption-by-recompute replays the same stream.
    Seeds are folded as 32-bit values: values outside [0, 2**32)
    truncate.
    """

    max_new_tokens: int = 16
    temperature: float = 0.0
    top_k: int = 0
    eos_id: Optional[int] = None
    seed: int = 0


def default_buckets(max_seq_len: int, start: int = 16) -> Tuple[int, ...]:
    """Doubling prompt-length buckets: start, 2*start, ... up to (and
    including) max_seq_len."""
    buckets: List[int] = []
    b = min(start, max_seq_len)
    while b < max_seq_len:
        buckets.append(b)
        b *= 2
    buckets.append(max_seq_len)
    return tuple(buckets)


def topk_scaled_logits(logits, temps, top_ks):
    """Temperature-scaled, top-k-masked logits.

    logits [..., V]; temps/top_ks shaped logits.shape[:-1]. temp <= 0
    rows are scaled by 1 (greedy callers argmax the RAW logits); top_k
    <= 0 disables the top-k filter. The threshold is the k-th largest
    scaled logit from a sort, and every logit ``>=`` it survives, so ties
    at the threshold all stay (the JAX package's rule).
    """
    v = logits.shape[-1]
    safe_t = torch.where(temps <= 0.0, torch.ones_like(temps), temps)
    scaled = logits / safe_t[..., None]
    k = torch.where(top_ks <= 0, torch.full_like(top_ks, v), top_ks.clamp(1, v)).long()
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    thresh = torch.gather(sorted_desc, -1, k[..., None] - 1)
    return torch.where(scaled >= thresh, scaled, torch.full_like(scaled, NEG_INF))


def _sample(logits, temps, top_ks, noise):
    """Vectorised sampling: greedy where temp <= 0, else temperature +
    optional top-k with Gumbel-max. logits [B, V]; temps/top_ks [B];
    ``noise`` [B, V] Gumbel noise (ignored on greedy rows)."""
    greedy = temps <= 0.0
    masked = topk_scaled_logits(logits, temps, top_ks)
    sampled = torch.argmax(masked + noise, dim=-1)
    return torch.where(greedy, torch.argmax(logits, dim=-1), sampled).to(torch.int32)


def derive_keys(seeds: torch.Tensor, counts: torch.Tensor) -> prng.Key:
    """Per-slot sampling keys ``fold_in(key(seed), count)`` from [B]
    seeds (folded as 32-bit values) and [B] generated-token counts: the
    JAX engine's ``derive_keys``, bit for bit."""
    return prng.fold_in(prng.key(seeds), counts)


class GenerationEngine:
    """Owns the cache, the allocator, and the fixed-shape step family.
    The continuous-batching scheduler drives it; ``generate`` is a
    convenience wrapper that spins up a private scheduler.

    ``device`` None means CUDA, and raises where no GPU is present;
    ``device="cpu"`` runs the plain PyTorch path. ``params`` are moved to
    the engine's device."""

    def __init__(
        self,
        params: DecoderParams,
        cfg: TransformerConfig,
        cache_config: Optional[CacheConfig] = None,
        *,
        cache_budget_bytes: Optional[int] = None,
        max_batch_slots: int = 4,
        prompt_buckets: Optional[Sequence[int]] = None,
        max_seq_len: Optional[int] = None,
        block_size: int = 16,
        device=None,
    ):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.max_seq_len = max_seq_len or cfg.seq_length
        self.max_batch_slots = max_batch_slots
        self.params = params_to(params, self.device)
        if cache_config is None:
            head_dim = cfg.hidden_size // cfg.num_heads
            if cache_budget_bytes is not None:
                cache_config = CacheConfig.from_budget(
                    cache_budget_bytes,
                    num_layers=cfg.num_layers,
                    num_heads=cfg.num_heads,
                    head_dim=head_dim,
                    block_size=block_size,
                )
            else:
                # enough for every slot to reach max_seq_len, plus scratch
                cache_config = CacheConfig.for_slots(
                    num_layers=cfg.num_layers,
                    num_heads=cfg.num_heads,
                    head_dim=head_dim,
                    max_seq_len=self.max_seq_len,
                    max_batch_slots=max_batch_slots,
                    block_size=block_size,
                )
        self.cache_config = cache_config
        self.cache = KVCache.create(cache_config, device=self.device)
        self.allocator = BlockAllocator(cache_config)
        self.max_blocks_per_seq = cache_config.blocks_for(self.max_seq_len)
        self.buckets = tuple(sorted(prompt_buckets or default_buckets(self.max_seq_len)))
        if self.buckets[-1] > self.max_seq_len:
            raise ValueError(
                f"bucket {self.buckets[-1]} exceeds max_seq_len {self.max_seq_len}"
            )
        if self.buckets[-1] < self.max_seq_len:
            # preemption-by-recompute re-prefills prompt + generated,
            # which can reach max_seq_len - 1: a bucket must hold it
            self.buckets = self.buckets + (self.max_seq_len,)
        # distinct input-shape signatures run per step kind (see module doc)
        self.trace_counts: Dict[str, int] = {}
        self._signatures: set = set()
        # engine steps actually issued
        self.step_counts: Dict[str, int] = {"prefill": 0, "decode": 0}
        # host-clock seconds per step kind, each step ending in a device sync
        self.step_seconds: Dict[str, float] = {"prefill": 0.0, "decode": 0.0}
        # per-slot finiteness of the last step's logits (the NaN blame
        # vector); shaped [1] after prefill_one
        self.last_finite = np.ones((max_batch_slots,), bool)

    # ------------------------------------------------------------ geometry
    def bucket_for(self, prompt_len: int) -> int:
        for b in self.buckets:
            if prompt_len <= b:
                return b
        raise ValueError(
            f"prompt length {prompt_len} exceeds the largest bucket {self.buckets[-1]}"
        )

    def recompiles(self) -> Dict[str, int]:
        """Shape signatures beyond the first, per step kind."""
        return {k: v - 1 for k, v in self.trace_counts.items() if v > 1}

    def _note_shape(self, kind: str, *shape) -> None:
        sig = (kind, shape)
        if sig not in self._signatures:
            self._signatures.add(sig)
            self.trace_counts[kind] = self.trace_counts.get(kind, 0) + 1

    def _tensor(self, x, dtype: DataType = DataType.INT32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=dtype.torch).to(self.device)

    def _noise(self, temps: np.ndarray, seeds: np.ndarray, counts: np.ndarray) -> torch.Tensor:
        """[B, V] Gumbel noise on the engine's device: JAX's
        ``gumbel(fold_in(key(seed), count), (V,))`` for each sampled
        slot, zeros for greedy ones (greedy rows never read their noise,
        so a greedy-only step draws nothing)."""
        v = self.cfg.vocab_size
        noise = torch.zeros((len(temps), v), dtype=torch.float32, device=self.device)
        rows = np.flatnonzero(temps > 0.0)
        if len(rows):
            keys = derive_keys(
                self._tensor(np.asarray(seeds)[rows].astype(np.int64), DataType.INT64),
                self._tensor(np.asarray(counts)[rows], DataType.INT64),
            )
            noise[torch.from_numpy(rows).to(self.device)] = prng.gumbel(keys, (v,))
        return noise

    # --------------------------------------------------------------- steps
    def _prefill_impl(self, tokens, length, block_table, temp, top_k, noise):
        s = tokens.shape[1]
        self._note_shape(f"prefill[{s}]", s)
        cache_k, cache_v = self.cache.k, self.cache.v
        bs = cache_k.shape[2]
        lengths = torch.full((1,), length, dtype=torch.int32, device=self.device)
        logits, ks, vs = prefill(self.params, tokens, lengths)
        positions = torch.arange(s, dtype=torch.int32, device=self.device)
        slots = slot_mapping(block_table, positions, bs)
        slots = torch.where(positions < length, slots, torch.zeros_like(slots)).long()
        for li in range(cache_k.shape[0]):  # padding -> scratch block 0
            cache_k[li].view(-1, *cache_k.shape[3:])[slots] = ks[li, 0]
            cache_v[li].view(-1, *cache_v.shape[3:])[slots] = vs[li, 0]
        last = logits[0, length - 1]
        ok = torch.isfinite(last).all()
        token = _sample(last[None], temp, top_k, noise)[0]
        return token, ok

    def prefill_one(
        self,
        prompt: Sequence[int],
        block_table: Sequence[int],
        sampling: SamplingParams,
        sample_index: int = 0,
    ) -> int:
        """Prefill one sequence into its allocated blocks and sample its
        first generated token. ``block_table`` is the sequence's block ids
        (padded internally to the engine's fixed table width);
        ``sample_index`` is the request's generated-token count, which
        indexes its sampling noise stream."""
        self.step_counts["prefill"] += 1
        t0 = time.perf_counter()
        n = len(prompt)
        bucket = self.bucket_for(n)
        tokens = np.zeros((1, bucket), np.int32)
        tokens[0, :n] = prompt
        table = np.zeros((self.max_blocks_per_seq,), np.int32)
        table[: len(block_table)] = block_table
        temps = np.asarray([sampling.temperature], np.float32)
        token, ok = self._prefill_impl(
            self._tensor(tokens),
            n,
            self._tensor(table),
            self._tensor(temps, DataType.FLOAT),
            self._tensor([sampling.top_k]),
            self._noise(temps, np.asarray([sampling.seed]), np.asarray([sample_index])),
        )
        self.last_finite = np.asarray([bool(ok)])
        out = int(token)  # device sync
        self.step_seconds["prefill"] += time.perf_counter() - t0
        return out

    def _decode_impl(self, tokens, positions, block_tables, context_lens, temps, top_ks, noise):
        self._note_shape("decode", *tokens.shape, *block_tables.shape)
        logits, _, _ = decode_step(
            self.params, tokens, positions, self.cache.k, self.cache.v,
            block_tables, context_lens,
        )
        ok = torch.isfinite(logits).all(dim=-1)
        return _sample(logits, temps, top_ks, noise), ok

    def decode_inputs(
        self, tokens: np.ndarray, positions: np.ndarray, block_tables: np.ndarray,
        active: np.ndarray,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """The decode step's device inputs (tokens, positions, tables,
        context_lens) from slot-indexed host arrays: inactive slots get
        token 0, position 0, context length 0 and an all-scratch table,
        so they write only to block 0 and attend to nothing."""
        masked = np.where(active, tokens, 0).astype(np.int32)
        context_lens = np.where(active, positions + 1, 0).astype(np.int32)
        safe_pos = np.where(active, positions, 0).astype(np.int32)
        # scratch-mask inactive slots' tables too: an inactive slot with
        # a REAL table would otherwise write its position-0 K/V into that
        # table's first block
        tables = np.where(active[:, None], block_tables, 0).astype(np.int32)
        return (
            self._tensor(masked), self._tensor(safe_pos),
            self._tensor(tables), self._tensor(context_lens),
        )

    def decode(
        self,
        tokens: np.ndarray,
        positions: np.ndarray,
        block_tables: np.ndarray,
        active: np.ndarray,
        temps: np.ndarray,
        top_ks: np.ndarray,
        seeds: np.ndarray,
        counts: np.ndarray,
    ) -> np.ndarray:
        """One decode step across all ``max_batch_slots`` slots. Arrays
        are slot-indexed; inactive slots (active[i] False) write to
        scratch and return garbage tokens the scheduler ignores. After
        the call ``last_finite[i]`` says whether slot i's logits were
        finite. ``seeds``/``counts`` index each sampled slot's noise."""
        self.step_counts["decode"] += 1
        t0 = time.perf_counter()
        out, ok = self._decode_impl(
            *self.decode_inputs(tokens, positions, block_tables, active),
            self._tensor(temps, DataType.FLOAT),
            self._tensor(top_ks),
            self._noise(np.where(active, temps, 0.0), seeds, counts),
        )
        self.last_finite = ok.cpu().numpy()
        result = out.cpu().numpy()  # device sync
        self.step_seconds["decode"] += time.perf_counter() - t0
        return result

    def generate(
        self,
        prompts: Sequence[Sequence[int]],
        sampling: Optional[SamplingParams] = None,
        **scheduler_kwargs,
    ) -> List[List[int]]:
        """Convenience: run ``prompts`` through a private continuous-
        batching scheduler to completion; returns generated tokens per
        prompt (prompt excluded)."""
        from .scheduler import ContinuousBatchingScheduler

        sampling = sampling or SamplingParams()
        sched = ContinuousBatchingScheduler(self, **scheduler_kwargs)
        handles = [sched.submit(list(p), sampling) for p in prompts]
        while any(not h.done() for h in handles):
            if not sched.step():
                break
        return [h.result(timeout=0) for h in handles]
