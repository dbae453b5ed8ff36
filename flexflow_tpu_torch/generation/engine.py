"""Generation engine: prefill/decode split over the block KV cache, and
speculative verification (port of the core of
``flexflow_tpu/generation/engine.py``).

The engine runs a FIXED family of step shapes, as the JAX engine's
compiled programs do:

* **prefill** — one shape per *prompt-length bucket* (the prompt padded
  up to the bucket; per-sequence length masking keeps logits identical
  to the unpadded forward; the length rides on the device);
* **decode** — ONE shape: always ``max_batch_slots`` sequences (inactive
  slots masked to scratch block 0), always the same block-table width;
* **verify** — ONE shape: ``max_batch_slots`` windows of ``spec_window``
  tokens (the last committed token and up to ``max_spec_tokens`` drafts),
  scored in one forward and accepted on the device.

Each step kind is a body of device tensors (``_prefill_body``,
``_decode_body``, ``_verify_body``) run by a
:class:`~flexflow_tpu_torch.generation.step_graphs.StepRunner`: one packed
upload of the step's inputs, the body, one readback of its tokens and
finiteness flags. On a CUDA engine the body is captured as a CUDA graph
the first time its input signature runs and replayed after that — the
counterpart of a jit trace and its compiled program — unless the engine
is built with ``eager_steps=True``; on the CPU the bodies run eagerly.
``trace_counts`` counts the distinct signatures each step kind has run
(on the graph path, its captures), so the "steady-state decode never
changes shape" property stays assertable. ``step_counts`` counts the
engine steps issued.

Sampling (greedy / temperature / top-k) runs inside the step. Every
slot's Gumbel noise is JAX's: ``gumbel(fold_in(key(seed), count), (V,))``
with threefry2x32 ported bit for bit (``prng.py``), keyed by the
request's seed and its generated-token count (:func:`derive_keys`, as the
JAX engine derives its keys inside its programs); greedy rows ignore it.
So a seeded temperature/top-k stream is the JAX engine's stream from the
same weights, and a request preempted and recomputed resumes its exact
stream. Greedy decoding is token-identical to the JAX engine.

A captured graph holds the addresses of the KV cache tensors: nothing may
reallocate ``cache.k``/``cache.v`` (``KVCache.reset`` zeroes them in
place).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from ..models.transformer import TransformerConfig
from ..ops.kernels.decode_attention import MAX_WINDOW
from .cache import BlockAllocator, CacheConfig, KVCache, slot_mapping
from . import prng
from .decoder import DecoderParams, decode_step, params_to, prefill, verify_step
from .step_graphs import StepBody, StepRunner

NEG_INF = -1e30
MASK32 = 0xFFFFFFFF


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
    at the threshold all stay (the JAX package's rule). Speculative
    acceptance (``speculative/sampling.py``) takes this same transform, so
    a zero-draft verify step samples exactly as a decode step does.
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


def derive_window_keys(seeds: torch.Tensor, counts: torch.Tensor, window: int) -> prng.Key:
    """[B, window] keys for a speculative window: key j of slot b is
    ``fold_in(key(seeds[b]), counts[b] + j)``, the key of the token at
    generated-token count ``counts[b] + j`` — the JAX engine's
    ``derive_window_keys``, bit for bit."""
    offs = torch.arange(window, dtype=torch.int64, device=counts.device)
    return prng.fold_in(prng.key(seeds[:, None]), counts[:, None].long() + offs)


class GenerationEngine:
    """Owns the cache, the allocator, and the fixed-shape step family.
    The continuous-batching scheduler drives it; ``generate`` is a
    convenience wrapper that spins up a private scheduler.

    ``device`` None means CUDA, and raises where no GPU is present;
    ``device="cpu"`` runs the plain PyTorch path. ``params`` are moved to
    the engine's device. On CUDA every step replays a captured graph;
    ``eager_steps=True`` runs the same step bodies eagerly instead (the
    A/B and exactness reference for the graphs). ``max_spec_tokens``
    fixes the verify window, ``max_spec_tokens + 1`` tokens, at most the
    paged kernel's ``MAX_WINDOW``."""

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
        max_spec_tokens: int = 4,
        device=None,
        eager_steps: bool = False,
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
        if not 1 <= max_spec_tokens < MAX_WINDOW:
            raise ValueError(
                f"max_spec_tokens must be in 1..{MAX_WINDOW - 1}: the verify window of "
                f"max_spec_tokens + 1 tokens is at most the paged kernel's {MAX_WINDOW}"
            )
        # speculative verification window: 1 committed token + up to
        # max_spec_tokens drafts, ONE fixed shape whatever per-request
        # adaptive k does
        self.max_spec_tokens = max_spec_tokens
        self.spec_window = max_spec_tokens + 1
        # distinct input-shape signatures run per step kind (see module doc)
        self.trace_counts: Dict[str, int] = {}
        # engine steps actually issued
        self.step_counts: Dict[str, int] = {"prefill": 0, "decode": 0, "verify": 0}
        # host-clock seconds per step kind, each step ending in a device sync
        self.step_seconds: Dict[str, float] = {"prefill": 0.0, "decode": 0.0, "verify": 0.0}
        # per-slot finiteness of the last step's logits (the NaN blame
        # vector); shaped [1] after prefill_one
        self.last_finite = np.ones((max_batch_slots,), bool)
        # the last step's logits on the device: [V] after prefill_one,
        # [B, V] after decode, [B, W, V] after verify; on the graph path a
        # later replay of the same step kind overwrites them
        self.last_logits: Optional[torch.Tensor] = None
        self.graphs = self.device.type == "cuda" and not eager_steps
        self._steps = StepRunner(self.device, self.graphs)

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

    def _run(self, kind: str, shape: Tuple[int, ...], arrays, body: StepBody) -> np.ndarray:
        """One step of ``kind`` whose input signature is ``shape``:
        counts a signature the first time it runs, keeps the step's
        logits in ``last_logits`` and returns its readback."""
        sig = (kind, shape)
        if sig not in self._steps:
            self.trace_counts[kind] = self.trace_counts.get(kind, 0) + 1
        readback, self.last_logits = self._steps.run(sig, arrays, body)
        return readback

    # --------------------------------------------------------- step bodies
    def _prefill_body(self, x: Dict[str, torch.Tensor]):
        tokens, length = x["tokens"], x["length"]
        s = tokens.shape[1]
        cache_k, cache_v = self.cache.k, self.cache.v
        bs = cache_k.shape[2]
        logits, ks, vs = prefill(self.params, tokens, length)
        positions = torch.arange(s, dtype=torch.int32, device=tokens.device)
        slots = slot_mapping(x["table"], positions, bs)
        slots = torch.where(positions < length, slots, torch.zeros_like(slots)).long()
        for li in range(cache_k.shape[0]):  # padding -> scratch block 0
            cache_k[li].view(-1, *cache_k.shape[3:])[slots] = ks[li, 0]
            cache_v[li].view(-1, *cache_v.shape[3:])[slots] = vs[li, 0]
        last = logits[0].index_select(0, (length - 1).long())  # [1, V], device-indexed
        ok = torch.isfinite(last).all(dim=-1)
        noise = prng.gumbel(derive_keys(x["seed"], x["count"]), (last.shape[-1],))
        token = _sample(last, x["temp"], x["top_k"], noise)
        return torch.cat([token, ok.to(torch.int32)]), last[0]

    def _decode_body(self, x: Dict[str, torch.Tensor]):
        logits, _, _ = decode_step(
            self.params, x["tokens"], x["positions"], self.cache.k, self.cache.v,
            x["tables"], x["context_lens"],
        )
        ok = torch.isfinite(logits).all(dim=-1)
        # every slot's noise, keyed by (seed, count) on the device: greedy
        # and inactive rows ignore theirs
        noise = prng.gumbel(derive_keys(x["seeds"], x["counts"]), (logits.shape[-1],))
        out = _sample(logits, x["temps"], x["top_ks"], noise)
        return torch.cat([out, ok.to(torch.int32)]), logits

    def _verify_body(self, x: Dict[str, torch.Tensor]):
        """Score a [B, W] window (committed token + drafts) in one forward
        and accept/emit on the device. ``n_draft[b]`` counts the slot's
        real drafts (0..W-1); -1 marks an inactive slot (everything
        masked to scratch, 0 emitted)."""
        from .speculative.sampling import speculative_accept

        window, n_draft = x["window"], x["n_draft"]
        w = window.shape[1]
        keys = derive_window_keys(x["seeds"], x["counts"], w)
        offs = torch.arange(w, dtype=torch.int32, device=window.device)[None, :]
        # window token j sits at cache position start + j; slots past the
        # drafts (and whole inactive rows) are padding -> position -1
        positions = torch.where(offs <= n_draft[:, None], x["start"][:, None] + offs, -1)
        logits, _, _ = verify_step(
            self.params, window, positions, self.cache.k, self.cache.v, x["tables"]
        )
        # blame vector: finiteness over each slot's REAL window positions
        # only — padded positions may hold garbage that must not indict
        # the request
        valid = offs <= n_draft.clamp_min(0)[:, None]
        ok = (torch.isfinite(logits) | ~valid[:, :, None]).flatten(1).all(dim=1)
        out, n_emitted = speculative_accept(
            logits, window[:, 1:], n_draft.clamp_min(0), x["temps"], x["top_ks"], keys
        )
        n_emitted = torch.where(n_draft >= 0, n_emitted, 0)
        return torch.cat([out.flatten(), n_emitted, ok.to(torch.int32)]), logits

    # --------------------------------------------------------------- steps
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
        token, ok = self._run(f"prefill[{bucket}]", (bucket,), {
            "tokens": tokens,
            "length": np.asarray([n], np.int32),
            "table": table,
            "temp": np.asarray([sampling.temperature], np.float32),
            "top_k": np.asarray([sampling.top_k], np.int32),
            "seed": np.asarray([sampling.seed & MASK32], np.uint32),
            "count": np.asarray([sample_index], np.int32),
        }, self._prefill_body)
        self.last_finite = np.asarray([bool(ok)])
        self.step_seconds["prefill"] += time.perf_counter() - t0
        return int(token)

    def decode_arrays(
        self, tokens: np.ndarray, positions: np.ndarray, block_tables: np.ndarray,
        active: np.ndarray,
    ) -> Dict[str, np.ndarray]:
        """The decode step's model inputs (tokens, positions, tables,
        context_lens) from slot-indexed host arrays: inactive slots get
        token 0, position 0, context length 0 and an all-scratch table,
        so they write only to block 0 and attend to nothing."""
        # scratch-mask inactive slots' tables too: an inactive slot with
        # a REAL table would otherwise write its position-0 K/V into that
        # table's first block
        return {
            "tokens": np.where(active, tokens, 0).astype(np.int32),
            "positions": np.where(active, positions, 0).astype(np.int32),
            "tables": np.where(active[:, None], block_tables, 0).astype(np.int32),
            "context_lens": np.where(active, positions + 1, 0).astype(np.int32),
        }

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
        finite. ``seeds``/``counts`` key each slot's sampling noise."""
        self.step_counts["decode"] += 1
        t0 = time.perf_counter()
        arrays = self.decode_arrays(tokens, positions, block_tables, active)
        arrays.update(
            temps=np.asarray(temps, np.float32),
            top_ks=np.asarray(top_ks, np.int32),
            seeds=np.asarray(seeds).astype(np.uint32),
            counts=np.asarray(counts, np.int32),
        )
        b, mb = arrays["tables"].shape
        readback = self._run("decode", (b, mb), arrays, self._decode_body)
        self.last_finite = readback[b:].astype(bool)
        self.step_seconds["decode"] += time.perf_counter() - t0
        return readback[:b]

    def verify(
        self,
        window_tokens: np.ndarray,
        start: np.ndarray,
        n_draft: np.ndarray,
        block_tables: np.ndarray,
        temps: np.ndarray,
        top_ks: np.ndarray,
        seeds: np.ndarray,
        counts: np.ndarray,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """One speculative verification step across all slots.

        ``window_tokens`` [B, spec_window]: per slot, the last committed
        token followed by its drafts (then padding); ``start`` [B]: the
        committed token's cache position (the slot's ``cached_len``);
        ``n_draft`` [B]: real drafts per slot, -1 for inactive slots;
        ``seeds``/``counts`` [B]: per-slot sampling seed and generated-
        token count, from which the [B, spec_window] per-emitted-count keys
        derive on the device (:func:`derive_window_keys`). Returns
        (out_tokens [B, spec_window], n_emitted [B]) — the scheduler keeps
        ``out_tokens[i, :n_emitted[i]]`` (further truncated by EOS /
        budget). ONE fixed shape: per-request adaptive k only changes
        ``n_draft`` values, never the shape."""
        b, w = self.max_batch_slots, self.spec_window
        if window_tokens.shape != (b, w):
            raise ValueError(f"verify window {window_tokens.shape}, the engine's is {(b, w)}")
        self.step_counts["verify"] += 1
        t0 = time.perf_counter()
        arrays = {
            "window": np.asarray(window_tokens, np.int32),
            "start": np.asarray(start, np.int32),
            "n_draft": np.asarray(n_draft, np.int32),
            "tables": np.asarray(block_tables, np.int32),
            "temps": np.asarray(temps, np.float32),
            "top_ks": np.asarray(top_ks, np.int32),
            "seeds": np.asarray(seeds).astype(np.uint32),
            "counts": np.asarray(counts, np.int32),
        }
        readback = self._run("verify", (b, w, arrays["tables"].shape[1]), arrays,
                             self._verify_body)
        self.last_finite = readback[b * w + b:].astype(bool)
        self.step_seconds["verify"] += time.perf_counter() - t0
        return readback[: b * w].reshape(b, w), readback[b * w: b * w + b]

    def generate(
        self,
        prompts: Sequence[Sequence[int]],
        sampling: Optional[SamplingParams] = None,
        speculation=None,
        **scheduler_kwargs,
    ) -> List[List[int]]:
        """Convenience: run ``prompts`` through a private continuous-
        batching scheduler to completion; returns generated tokens per
        prompt (prompt excluded). ``speculation`` (a
        :class:`~flexflow_tpu_torch.generation.speculative.SpeculationConfig`)
        turns on speculative decoding for every prompt."""
        from .scheduler import ContinuousBatchingScheduler

        sampling = sampling or SamplingParams()
        sched = ContinuousBatchingScheduler(self, **scheduler_kwargs)
        handles = [sched.submit(list(p), sampling, speculation=speculation) for p in prompts]
        while any(not h.done() for h in handles):
            if not sched.step():
                break
        return [h.result(timeout=0) for h in handles]
