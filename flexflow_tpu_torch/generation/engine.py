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
  scored in one forward and accepted on the device;
* **prefix prefill** — one shape per *suffix bucket*: a prompt whose
  leading full blocks are in the cross-request prefix cache
  (``prefix.py``) computes only its suffix, a ``[1, W]`` window through
  the verify forward (the paged append kernel, once per layer) over the
  shared blocks; the start and the real length ride on the device.

Each step kind is a body of device tensors (``_prefill_body``,
``_decode_body``, ``_verify_body``, ``_prefix_prefill_body``) run by a
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
place; the prefix cache's block copies, swap-in writes and swap-out
reads — admission-time, outside the graphs — index them in place).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from ..models.transformer import TransformerConfig
from ..obs.capacity import ServingFlops, chip_spec_for
from .cache import BlockAllocator, CacheConfig, KVCache, slot_mapping
from . import prng
from .decoder import DecoderParams, decode_step, params_to, prefill, verify_step
from .prefix import PrefixCache, PrefixEntry
from .step_graphs import StepBody, StepRunner

NEG_INF = -1e30
MASK32 = 0xFFFFFFFF


@dataclasses.dataclass
class PrefixPlan:
    """Admission-time reuse decision for one prompt
    (:meth:`GenerationEngine.prefix_plan`): the cached entries to share,
    the boundary entry to copy when the prompt is fully covered (its last
    position must still be recomputed for logits, and that write lands
    inside the last matched block), the token count reuse covers, and how
    many shared entries are already device-resident (the rest swap in
    from the host tier)."""

    entries: List[PrefixEntry]
    cow: Optional[PrefixEntry]
    reuse_tokens: int
    n_resident: int


EMPTY_PREFIX_PLAN = PrefixPlan([], None, 0, 0)


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
    (any count >= 1) fixes the verify window, ``max_spec_tokens + 1``
    tokens.

    ``prefix_cache`` (on by default, as in the JAX engine) shares cached
    prompt blocks across requests (``prefix.py``); ``host_cache_bytes``
    bounds its host tier (default: the device cache's size);
    ``expected_prefix_sharing`` discounts the default cache sizing by the
    share of positions expected to be shared."""

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
        prefix_cache: bool = True,
        host_cache_bytes: Optional[int] = None,
        expected_prefix_sharing: float = 0.0,
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
                # enough for every slot to reach max_seq_len (discounted
                # by expected prefix sharing), plus scratch
                cache_config = CacheConfig.for_slots(
                    num_layers=cfg.num_layers,
                    num_heads=cfg.num_heads,
                    head_dim=head_dim,
                    max_seq_len=self.max_seq_len,
                    max_batch_slots=max_batch_slots,
                    block_size=block_size,
                    expected_prefix_sharing=expected_prefix_sharing,
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
        if max_spec_tokens < 1:
            raise ValueError("max_spec_tokens must be >= 1")
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
        # the serving roofline prefix_plan weighs a swap-in against a
        # recompute with (the device's preset peaks)
        self.flops_model = ServingFlops.from_config(cfg, chip=chip_spec_for(self.device))
        # cross-request prefix caching (prefix.py): radix index +
        # refcounted copy-on-write blocks + host-RAM offload tier; its
        # block programs run at admission only, outside the step graphs
        self.prefix_cache = PrefixCache(
            self.allocator, cache_config,
            enabled=prefix_cache, host_budget_bytes=host_cache_bytes,
        )

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

    def _prefix_prefill_body(self, x: Dict[str, torch.Tensor]):
        """Suffix-only prefill against a cached prefix: the [1, W] suffix
        window attends over the table (shared prefix blocks, then the
        sequence's own) through the verify forward, writes the suffix
        K/V, and samples the first generated token from the logits at the
        last REAL suffix position (``n_real - 1``, read on the device)."""
        tokens, start, n_real = x["tokens"], x["start"], x["n_real"]
        offs = torch.arange(tokens.shape[1], dtype=torch.int32, device=tokens.device)
        positions = torch.where(offs < n_real, start + offs, -1)[None, :]
        logits, _, _ = verify_step(
            self.params, tokens, positions, self.cache.k, self.cache.v, x["table"][None]
        )
        last = logits[0].index_select(0, (n_real - 1).long())  # [1, V], device-indexed
        ok = torch.isfinite(last).all(dim=-1)
        noise = prng.gumbel(derive_keys(x["seed"], x["count"]), (last.shape[-1],))
        token = _sample(last, x["temp"], x["top_k"], noise)
        return torch.cat([token, ok.to(torch.int32)]), last[0]

    # ------------------------------------------------------ block programs
    # admission-time copies over whole blocks of every layer, in place:
    # the step graphs hold the cache tensors' addresses
    def _copy_block(self, src: int, dst: int) -> None:
        """COW: duplicate one block's K/V across all layers."""
        for t in (self.cache.k, self.cache.v):
            t[:, dst].copy_(t[:, src])

    def _read_block(self, src: int) -> Tuple[np.ndarray, np.ndarray]:
        """Host-tier swap-out read: one block's K and V ([L, bs, H, D]
        each), brought to the host in one copy."""
        kv = torch.stack((self.cache.k[:, src], self.cache.v[:, src])).cpu().numpy()
        return kv[0], kv[1]

    def _write_block(self, dst: int, host_k: np.ndarray, host_v: np.ndarray) -> None:
        """Host-tier swap-in write: one block's K/V back into ``dst``."""
        for t, h in ((self.cache.k, host_k), (self.cache.v, host_v)):
            t[:, dst].copy_(torch.from_numpy(h))

    # --------------------------------------------------------------- steps
    def prefill_one(
        self,
        prompt: Sequence[int],
        block_table: Sequence[int],
        sampling: SamplingParams,
        sample_index: int = 0,
        prefix_len: int = 0,
    ) -> int:
        """Prefill one sequence into its allocated blocks and sample its
        first generated token. ``block_table`` is the sequence's block ids
        (padded internally to the engine's fixed table width);
        ``sample_index`` is the request's generated-token count, which
        indexes its sampling noise stream. ``prefix_len`` > 0 means
        positions [0, prefix_len) are already cached (shared prefix blocks
        at the front of the table): only the suffix is computed, a
        ``prefix_prefill[W]`` step per suffix bucket W, counted as a
        prefill step."""
        self.step_counts["prefill"] += 1
        t0 = time.perf_counter()
        computed = prompt[prefix_len:]
        n = len(computed)
        bucket = self.bucket_for(n)
        tokens = np.zeros((1, bucket), np.int32)
        tokens[0, :n] = computed
        table = np.zeros((self.max_blocks_per_seq,), np.int32)
        table[: len(block_table)] = block_table
        arrays = {"tokens": tokens, "table": table}
        if prefix_len > 0:
            kind, body = f"prefix_prefill[{bucket}]", self._prefix_prefill_body
            arrays.update(start=np.asarray([prefix_len], np.int32),
                          n_real=np.asarray([n], np.int32))
        else:
            kind, body = f"prefill[{bucket}]", self._prefill_body
            arrays.update(length=np.asarray([n], np.int32))
        arrays.update(
            temp=np.asarray([sampling.temperature], np.float32),
            top_k=np.asarray([sampling.top_k], np.int32),
            seed=np.asarray([sampling.seed & MASK32], np.uint32),
            count=np.asarray([sample_index], np.int32),
        )
        token, ok = self._run(kind, (bucket,), arrays, body)
        self.last_finite = np.asarray([bool(ok)])
        self.step_seconds["prefill"] += time.perf_counter() - t0
        return int(token)

    # ------------------------------------------------------ prefix caching
    def prefix_plan(self, prompt: Sequence[int]) -> PrefixPlan:
        """Match ``prompt`` against the radix index and decide what to
        reuse. Offloaded entries in the matched run are used only when the
        host->device transfer beats recomputing the same positions on the
        device's roofline; otherwise the run truncates at the first
        offloaded entry."""
        pc = self.prefix_cache
        run = pc.match(prompt)  # empty when disabled or len(prompt) < 2
        if not run:
            return EMPTY_PREFIX_PLAN
        bs = self.cache_config.block_size
        reuse = min(len(run) * bs, len(prompt) - 1)
        n_shared = reuse // bs
        cow = run[n_shared] if (reuse % bs and len(run) > n_shared) else None
        entries = run[:n_shared]
        off_idx = [i for i, e in enumerate(entries) if not e.resident]
        cow_off = cow is not None and not cow.resident
        if off_idx or cow_off:
            n_off = len(off_idx) + (1 if cow_off else 0)
            first = off_idx[0] if off_idx else n_shared
            # the recompute alternative: truncate at the first offloaded
            # entry and prefill positions [first*bs, reuse) instead
            start = first * bs
            n_tok = reuse - start
            ctx = (reuse * (reuse + 1) - start * (start + 1)) // 2
            recompute_s = self.flops_model.roofline_s(
                self.flops_model.verify_flops(n_tok, ctx),
                self.flops_model.verify_bytes(n_tok, ctx),
            )
            if pc.swap_in_cost_s(n_off) >= recompute_s:
                pc.recompute_fallbacks += 1
                entries = entries[:first]
                reuse = first * bs
                cow = None
        n_resident = sum(1 for e in entries if e.resident)
        return PrefixPlan(entries, cow, reuse, n_resident)

    def prepare_prefix(
        self,
        prompt: Sequence[int],
        plan: PrefixPlan,
        new_blocks: List[int],
    ) -> Optional[Tuple[List[int], set, List[PrefixEntry], int]]:
        """Assemble one admission's block table from a plan: shared
        entries first (swapping offloaded ones back in), then the private
        blocks (COW boundary copy, suffix, growth room). Returns (table,
        shared_idx, held entries, prefix_len), or None when a failed
        swap-in could not be replaced from the allocator — everything is
        handed back and the caller retries admission later. A failed or
        corrupted swap-in truncates reuse at that entry and the rest is
        recomputed, which the exactness invariant makes invisible in the
        token stream."""
        pc = self.prefix_cache
        bs = self.cache_config.block_size
        entries = list(plan.entries)
        cow = plan.cow
        reuse = plan.reuse_tokens
        pc.acquire(entries)
        if cow is not None:
            # hold the boundary entry too: the reclaim below must not
            # evict the COW source out from under the copy
            pc.acquire([cow])
        pool = list(new_blocks)
        shared: List[int] = []
        kept: List[PrefixEntry] = []
        failed_at: Optional[int] = None
        for i, e in enumerate(entries):
            if e.resident:
                shared.append(e.block)
                kept.append(e)
                continue
            if not pool:
                failed_at = i  # stale plan: no swap target left
                break
            dst = pool.pop(0)
            if self._swap_in(e, dst):
                shared.append(e.block)
                kept.append(e)
            else:
                pool.insert(0, dst)
                failed_at = i
                break
        need_total = self.cache_config.blocks_for(len(prompt) + 1)
        if failed_at is not None:
            pc.release(entries[failed_at:])
            reuse = len(kept) * bs
            if cow is not None:
                pc.release([cow])
                cow = None
        # re-balance the private pool against the full table: the plan's
        # resident count can go stale between planning and assembly (a
        # reclaim may evict a planned-resident entry, whose swap-in then
        # takes a pool block budgeted for the suffix, and a short table
        # would map suffix positions to the scratch block). Top the pool
        # back up, or hand everything back and let the caller retry.
        short = need_total - len(shared) - len(pool)
        if short > 0:
            extra = self.allocator.allocate(short)
            if extra is None and self.reclaim_cached(short):
                extra = self.allocator.allocate(short)
            if extra is None:
                if cow is not None:
                    pc.release([cow])
                pc.release(kept)
                self.allocator.free(pool)
                return None
            pool.extend(extra)
        if cow is not None:
            # the boundary block: the copy target doubles as the plain
            # private block when the COW source is unusable (corrupt
            # offloaded content) — only prefix_len changes
            if pool and self._cow_copy(cow, pool[0]):
                pc.cow_copies_total += 1
            else:
                reuse = len(kept) * bs
            pc.release([cow])
        table = shared + pool
        if len(table) > need_total:
            surplus = table[need_total:]
            del table[need_total:]
            self.allocator.free(surplus)
        return table, set(range(len(shared))), kept, reuse

    def _write_host_copy(self, entry: PrefixEntry, dst: int) -> bool:
        """Write an offloaded entry's CRC-verified host copy into device
        block ``dst``; False (a failed swap-in, recomputed instead) when
        the copy is corrupt or gone."""
        pc = self.prefix_cache
        buf = pc.take_host_copy(entry)
        if buf is None:
            pc.swap_in_failures += 1
            pc.recompute_fallbacks += 1
            return False
        self._write_block(dst, *buf)
        return True

    def _swap_in(self, entry: PrefixEntry, dst: int) -> bool:
        """Bring one offloaded entry's K/V back to device block ``dst``:
        the entry is resident again."""
        if not self._write_host_copy(entry, dst):
            return False
        self.prefix_cache.note_swapped_in(entry, dst)
        return True

    def _cow_copy(self, src: PrefixEntry, dst: int) -> bool:
        """A private copy of ``src``'s block at ``dst`` — from the device
        (resident) or the host tier (offloaded). The source entry is
        untouched: its content stays shared."""
        if src.resident:
            self._copy_block(src.block, dst)
            return True
        if not self._write_host_copy(src, dst):
            return False
        self.prefix_cache.swaps_in_total += 1
        return True

    def register_prefix(
        self,
        prompt: Sequence[int],
        table: List[int],
        shared_idx: set,
        entries: List[PrefixEntry],
        prefix_len: int = 0,
    ) -> None:
        """Post-prefill registration: the prompt's freshly written full
        blocks join the radix index (ownership moves to the index; the
        sequence keeps a ref). Called only after the finiteness check, so
        poisoned K/V never becomes shared content; reuse counts here, so
        a failed prefill never inflates them."""
        pc = self.prefix_cache
        if not pc.enabled:
            return
        pc.lookups += 1
        if prefix_len > 0:
            pc.hits += 1
            pc.tokens_reused_total += prefix_len
            pc.blocks_reused_total += len(entries)
        pc.register_chain(prompt, table, shared_idx, entries, len(prompt))

    def stash_prefix(self, state) -> None:
        """Preemption stash: register the victim's full blocks below
        ``cached_len`` (prompt AND generated content), so its recompute
        re-admission — and any request sharing the prefix — matches them
        instead of recomputing."""
        if not self.prefix_cache.enabled:
            return
        req = state.req
        tokens = list(req.original_prompt) + list(req.generated)
        upto = min(state.cached_len, len(tokens))
        self.prefix_cache.register_chain(
            tokens, state.blocks, state.shared_idx, state.shared_entries, upto
        )

    def release_admission(
        self, table: List[int], shared_idx: set, entries: List[PrefixEntry]
    ) -> None:
        """Undo one admission's block bookkeeping (failed or non-finite
        prefill): private blocks back to the allocator, shared refs
        dropped (the content stays cached)."""
        self.allocator.free([b for i, b in enumerate(table) if i not in shared_idx])
        self.prefix_cache.release(entries)

    def reclaim_cached(self, n_blocks: int) -> int:
        """Free device blocks held by unreferenced cached prefixes (LRU;
        content offloads to the host tier when its budget allows): the
        allocator's last resort before preemption."""
        if not self.prefix_cache.enabled:
            return 0
        return self.prefix_cache.reclaim(max(1, n_blocks), self._read_block)

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
