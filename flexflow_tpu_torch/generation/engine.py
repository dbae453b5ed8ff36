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
reallocate ``cache.k``/``cache.v`` (:meth:`GenerationEngine.reset` zeroes
them in place; the prefix cache's block copies, swap-in writes and
swap-out reads — admission-time, outside the graphs — index them in
place).

The overlap pipeline splits one decode step into
:meth:`GenerationEngine.decode_async` (pack, upload and launch, no wait;
the previous step's sampled tokens carried on the device as this step's
token input) and :meth:`GenerationEngine.consume_decode` (wait for the
step's event, read its tokens and finiteness flags back). The cache is
updated in place, so a discarded in-flight step needs no rollback: its
K/V writes sit at positions past every slot's context, and the
sequential re-run rewrites them from the same inputs. ``last_logits`` of
a pipelined step are overwritten by the next replay: nothing may hold
them across a dispatch.

Fault sites (``runtime/faults.py``): ``generation.prefill``,
``generation.decode_step`` and ``generation.verify`` fire at the top of
their steps; the prefill site sees the prompt alone, as in the JAX
engine. ``generation.prefix_lookup`` fires before each radix lookup (a
fault degrades it to a miss) and ``generation.kv_offload`` around each
host-tier block swap, ``("in", 1)`` before a swap-in write (a fault
recomputes instead) and ``("out", 1)`` before a swap-out read (a fault
drops the block instead of offloading it), where the JAX engine fires
them. The decode and verify bodies add a per-slot logit bias, a
persistent device tensor of zeros that the graphs read; a fault plan's
``nan`` mode writes NaN into it in place for one step, which makes the
poison indistinguishable from model-produced NaN to the finiteness flags.

Tensor-parallel serving (``sharding.py``, ``parallel/distributed.py``):
``tp_degree=N`` (or ``mesh=`` / ``mesh_devices=``, as in the JAX engine)
splits the decoder and the cache over N ranks by KV heads. This engine is
rank 0: it keeps all host state (allocator, tables, prefix index,
sampling, ledger, programs) and starts ranks 1..N-1 itself, each a
``spawn`` process holding an engine of its own shard
(:func:`_rank_engine`). Everything that touches the cache is one call on
the group: rank 0 sends the op and its host inputs to every rank, then
runs the same op on its own shard (the step bodies with their two sum
all-reduces a layer, the block programs, the handoff's packs and imports,
``reset``). Reads of blocks gather every rank's heads to rank 0 (the
handoff's wire keeps full-head blocks, as in the JAX package); writes
send each rank its own heads. Every rank samples alike from the same
logits, and only rank 0's tokens are read. A tp > 1 engine runs its step
bodies eagerly (a CUDA graph cannot capture a gloo collective), and its
``generation.collective`` fault site fires on rank 0 before each decode
and verify step's command is sent. :meth:`GenerationEngine.close` stops
the ranks (a finalizer does it for an engine never closed).

Constrained decoding (``constrained/``): every step kind adds a grammar
mask to its logits before sampling, as the JAX engine's programs do —
[V] at prefill and suffix prefill (after the finiteness flag, which must
see the model's logits), [B, V] at decode and [B, W, V] at verify (after
the bias). Each mask is a persistent device tensor of zeros that the
graphs read, so an unconstrained step uploads nothing and a constrained
one captures nothing new. A constrained step writes its rows (0 / NEG,
finite) before its launch and zeroes them after it, both in stream order,
so no later replay reads a stale row. Nothing may reallocate the mask
tensors either: :meth:`GenerationEngine.reset` zeroes them in place.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from ..models.transformer import TransformerConfig
from ..obs.capacity import ProgramRegistry, ServingFlops, chip_spec_for
from ..obs.truth import PredictionLedger
from ..runtime import faults
from .cache import BlockAllocator, CacheConfig, KVCache, slot_mapping
from . import prng
from .sharding import RankContext, ServingLayout
from .decoder import DecoderParams, decode_step, params_to, prefill, verify_step
from .prefix import (
    KVHandoffPayload,
    PackedBlock,
    PrefixCache,
    PrefixEntry,
    from_host,
    to_host,
)
from .step_graphs import InFlight, StepBody, StepRunner

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


class InFlightDecode:
    """One dispatched-but-unconsumed decode step (the overlap pipeline's
    frontier unit): the step runner's handle, whose ``readback_dev``
    holds the sampled tokens the next step may carry, the host-clock
    stamps of its dispatch, its live-slot and live-context counts (its
    FLOPs) and whether it captured a new graph. Created by
    :meth:`GenerationEngine.decode_async`, consumed exactly once by
    :meth:`GenerationEngine.consume_decode`. ``t_started`` is restamped
    when the previous in-flight step completes: with a one-deep pipeline
    this step only starts executing then."""

    __slots__ = ("handle", "t0", "t_disp", "t_started", "n_active", "n_slots", "ctx_sum",
                 "traced", "consumed", "seq")

    def __init__(self, handle: InFlight, t0: float, t_disp: float, n_active: int,
                 n_slots: int, ctx_sum: int, traced: bool, seq: int = 0):
        self.handle = handle
        self.seq = seq  # the engine's decode dispatch number (the ranks' carry key)
        self.t0 = t0
        self.t_disp = t_disp
        self.t_started = t_disp
        self.n_active = n_active
        self.n_slots = n_slots
        self.ctx_sum = ctx_sum  # live context positions attended, all slots
        self.traced = traced  # this step met a new signature (a capture)
        self.consumed = False

    @property
    def tokens_dev(self) -> torch.Tensor:
        """The step's sampled tokens [B] on the device (the readback's
        head)."""
        return self.handle.readback_dev[: self.n_slots]


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
    share of positions expected to be shared.

    ``donate`` is a recovery policy flag with the JAX engine's default:
    false on the CPU, true on an accelerator. With it set, a failed step
    is not retried or bisected: the supervisor resets the engine and
    replays the journal (the JAX engine's steps then donate their cache
    buffers, so a failed step has consumed its inputs).

    Tensor parallelism, three ways in, as in the JAX engine: ``mesh=`` an
    explicit :class:`~flexflow_tpu_torch.parallel.mesh.ServingMesh` (its
    ranks' devices and transport), ``tp_degree=N`` a pinned degree (on the
    first N GPUs from ``device``, or N CPU ranks for ``device="cpu"``), or
    ``mesh_devices=N`` the devices to serve on, the degree chosen by the
    serving-layout search (``search/serving_strategy.py``). All None is the
    single-device engine; ``tp_degree=1`` is that engine too, bit for bit.
    Every collective and every wait on a rank is bounded by
    ``parallel/distributed.py``'s ``DEFAULT_TIMEOUT_S``."""

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
        donate: Optional[bool] = None,
        mesh=None,
        tp_degree: Optional[int] = None,
        mesh_devices: Optional[int] = None,
        _rank: Optional[RankContext] = None,
    ):
        self.cfg = cfg
        self.max_seq_len = max_seq_len or cfg.seq_length
        self.max_batch_slots = max_batch_slots
        # ------------------------------------------------- serving mesh
        # the layout (rank 0 of a group, or any engine given mesh
        # arguments), the search's choice, the group of ranks (rank 0 with
        # tp > 1) and this rank's context for the decoder (None on one
        # device); a worker rank is built with its context (_rank)
        self.layout: Optional[ServingLayout] = None
        self.serving_strategy = None
        self._group = None
        self._tp = _rank
        if _rank is None and (mesh is not None or tp_degree is not None
                              or mesh_devices is not None):
            self.device = self._plan_layout(mesh, tp_degree, mesh_devices, device)
        else:
            self.device = resolve_device(device)
        if _rank is not None:
            self.tp_degree = self.mesh_devices = _rank.tp_degree
        else:
            self.tp_degree = self.layout.tp_degree if self.layout else 1
            self.mesh_devices = self.layout.mesh.size if self.layout else 1
        full_params = params
        if _rank is None and self.tp_degree > 1:
            params = self.layout.shard_params(params, 0)
        self.params = params_to(params, self.device)
        if cache_config is None:
            head_dim = cfg.hidden_size // cfg.num_heads
            if cache_budget_bytes is not None:
                # a per-device budget: each rank holds H / tp heads of
                # every block, so the same budget buys tp x the blocks
                cache_config = CacheConfig.from_budget(
                    cache_budget_bytes,
                    num_layers=cfg.num_layers,
                    num_heads=cfg.num_heads,
                    head_dim=head_dim,
                    block_size=block_size,
                    kv_shards=self.tp_degree,
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
        self.cache = KVCache.create(cache_config, device=self.device, kv_shards=self.tp_degree)
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
        # host-clock seconds spent inside the engine's step calls, per step
        # kind: a sequential step from its call to its readback; a pipelined
        # decode step only its dispatch and its wait at consume, so the host
        # work it overlaps is left out (not a step time: the overlap's step
        # time is wall time over steps)
        self.step_seconds: Dict[str, float] = {"prefill": 0.0, "decode": 0.0, "verify": 0.0}
        # each step kind's host-clock split: dispatch (pack, upload, launch),
        # execute (from when the device could start the step, its dispatch
        # or its in-flight predecessor's completion, to its completion
        # event) and readback (copying the tokens out). MFU divides by the
        # execute seconds; the truth ledger pairs them with its predictions
        self.phase_time_s: Dict[str, Dict[str, float]] = {
            k: {"dispatch": 0.0, "execute": 0.0, "readback": 0.0}
            for k in ("prefill", "decode", "verify")
        }
        # the last step's (phase, t0, t1) perf_counter spans, for the
        # scheduler's step-anatomy profiler (its loop thread only)
        self.last_step_spans: List[Tuple[str, float, float]] = []
        # per-slot finiteness of the last step's logits (the NaN blame
        # vector); shaped [1] after prefill_one
        self.last_finite = np.ones((max_batch_slots,), bool)
        # the last step's logits on the device: [V] after prefill_one,
        # [B, V] after decode, [B, W, V] after verify; on the graph path a
        # later replay of the same step kind overwrites them
        self.last_logits: Optional[torch.Tensor] = None
        # recovery (generation/recovery.py): reset() count, and the failed-
        # step policy (see the class doc)
        self.resets = 0
        self.donate = bool(self.device.type != "cpu" if donate is None else donate)
        # the fault plan's NaN-poison carrier: outside chaos runs inject
        # returns this very host array, and the device bias stays zero
        self._zero_bias = np.zeros((max_batch_slots,), np.float32)
        self._bias = torch.zeros((max_batch_slots,), dtype=torch.float32, device=self.device)
        # grammar masks (see the module doc): [V] for both prefill kinds,
        # [B, V] for decode, [B, W, V] for verify (built at the first
        # verify, as the JAX engine builds its verify zeros lazily)
        v = cfg.vocab_size
        self._mask1 = torch.zeros((v,), dtype=torch.float32, device=self.device)
        self._mask_dec = torch.zeros((max_batch_slots, v), dtype=torch.float32,
                                     device=self.device)
        self._mask_ver: Optional[torch.Tensor] = None
        # bytes of grammar-mask rows written to the device, and the steps
        # that wrote any
        self.mask_bytes_staged = 0
        self.masked_step_count = 0
        # a CUDA graph cannot capture a gloo collective: a tp > 1 engine
        # runs its step bodies eagerly, on either transport
        self.graphs = self.device.type == "cuda" and not eager_steps and self.tp_degree == 1
        self._steps = StepRunner(self.device, self.graphs)
        # the serving roofline (the device's preset peaks): prefix_plan
        # weighs a swap-in against a recompute with it, MFU divides by its
        # peak, and the truth ledger predicts each step from it
        # over the mesh's aggregate chip (peaks x the degree), as the JAX
        # engine's mesh_device_kind: a tp-way engine's MFU divides by the
        # mesh's peak
        self.flops_model = ServingFlops.from_config(
            cfg, dtype=cache_config.dtype, chip=chip_spec_for(self.device, self.tp_degree)
        )
        # useful model FLOPs per step kind (true prompt lengths and live
        # context only), accrued on success next to the time they pair with
        self.flops_by_kind: Dict[str, float] = {"prefill": 0.0, "decode": 0.0, "verify": 0.0}
        # step programs: each signature's inputs, capture count and capture
        # wall time; a new signature of a known program carries blame
        # (GET /v2/debug/programs)
        self.programs = ProgramRegistry()
        # predicted-vs-measured step times (GET /v2/debug/predictions);
        # drift alarms only on a GPU: on the CPU the roofline models a
        # chip that is not there
        self.ledger = PredictionLedger()
        self._roofline_alarm = self.device.type != "cpu"
        # host-tier block writes so far: the JAX engine compiles its block
        # writer at the first, whose swap-in it keeps out of the ledger
        self._block_writes = 0
        # cross-request prefix caching (prefix.py): radix index +
        # refcounted copy-on-write blocks + host-RAM offload tier; its
        # block programs run at admission only, outside the step graphs
        self.prefix_cache = PrefixCache(
            self.allocator, cache_config,
            enabled=prefix_cache, host_budget_bytes=host_cache_bytes,
        )
        # decode dispatches so far: a worker rank keys the sampled tokens a
        # later pipelined step carries by this number
        self._decode_seq = 0
        self._carried: Dict[int, torch.Tensor] = {}
        if _rank is None and self.tp_degree > 1:
            self._start_ranks(full_params, dict(
                max_batch_slots=max_batch_slots, prompt_buckets=self.buckets,
                max_seq_len=self.max_seq_len, max_spec_tokens=max_spec_tokens,
                donate=self.donate))
        self._register_strategy_predictions()

    # ------------------------------------------------------ serving mesh
    def _plan_layout(self, mesh, tp_degree, mesh_devices, device) -> torch.device:
        """Build the serving layout and the search's choice from the mesh
        arguments (the JAX engine's rules); returns rank 0's device."""
        from ..parallel.mesh import available_devices
        from ..search.serving_strategy import choose_serving_strategy

        cfg = self.cfg
        if mesh is not None:
            if device is not None and resolve_device(device) != mesh.devices[0]:
                raise ValueError(
                    f"device {device} is not the mesh's rank 0 device {mesh.devices[0]}")
            dev = resolve_device(mesh.devices[0])
            self.layout = ServingLayout.build(cfg.num_heads, mesh.size, mesh=mesh)
            n_dev = mesh.size
        else:
            dev = resolve_device(device)
            n_dev = mesh_devices or tp_degree
        self.serving_strategy = choose_serving_strategy(
            cfg, mesh_devices=n_dev, max_batch_slots=self.max_batch_slots,
            prefill_len=self.max_seq_len,
            pinned_tp=self.layout.tp_degree if self.layout is not None else tp_degree,
        )
        if self.layout is None:
            tp = self.serving_strategy.tp_degree
            if dev.type == "cpu":
                devices = [dev] * tp  # CPU ranks are processes
            else:
                devices = available_devices()[dev.index or 0:]
            self.layout = ServingLayout.build(cfg.num_heads, tp, devices=devices)
            dev = self.layout.mesh.devices[0]
        return dev

    def _start_ranks(self, full_params, engine_kwargs) -> None:
        """Start ranks 1..N-1, each with its shard of the parameters (on
        the host) and this engine's geometry, and join their group."""
        from ..parallel import distributed

        layout = self.layout
        if self.device.type == "cuda":
            # build the kernels here, before any rank starts: two processes
            # never build the same library at once
            from ..ops.kernels._build import load_library

            load_library()
        ffn = layout.ffn_sharded(self.cfg.ff_size)
        worker_kwargs = [
            dict(rank=r, tp_degree=self.tp_degree, ffn_sharded=ffn,
                 params=_host_tree(layout.shard_params(full_params, r)),
                 cfg=self.cfg, cache_config=self.cache_config,
                 device=str(layout.mesh.devices[r]), **engine_kwargs)
            for r in range(1, self.tp_degree)
        ]
        self._group = distributed.start_group(
            layout.mesh.devices, layout.mesh.backend, _rank_engine, worker_kwargs)
        self._tp = RankContext(0, self.tp_degree, ffn, self._group)

    def close(self) -> None:
        """Stop and join the tensor-parallel ranks (nothing on one
        device); idempotent."""
        if self._group is not None:
            self._group.close()
            self._group = None

    def _on_ranks(self, op: str, *args, worker_op: Optional[str] = None, worker_args=None):
        """Run ``getattr(self, op)(*args)`` on every rank: send it to the
        workers (``worker_op`` / ``worker_args`` in place of ``op`` /
        ``args`` where given), run it here, then collect their answers.
        Returns this rank's result. On one device it is the local call."""
        local = getattr(self, op)
        g = self._group
        if g is None:
            return local(*args)
        with g.lock:
            g.send(worker_op or op, *(args if worker_args is None else worker_args))
            try:
                out = local(*args)
            except BaseException:
                # the workers' answers to this command must not be read as
                # the next one's
                with contextlib.suppress(Exception):
                    g.replies()
                raise
            g.replies()
        return out

    def rank_info(self) -> List[Dict]:
        """Each rank's view, rank 0 first: the heads of its cache and of
        its ``wq``, its FFN columns, its paged-kernel launches
        (``decode_attention.LAUNCHES``, counted in that rank's process),
        its collectives and the host seconds inside its all-reduces, and
        its peak device memory."""
        g = self._group
        if g is None:
            return [self._rank_info()]
        with g.lock:
            return [self._rank_info()] + g.call("_rank_info")

    def _rank_info(self) -> Dict:
        from ..ops.kernels import decode_attention as da

        cuda = self.device.type == "cuda"
        return {
            "rank": 0 if self._tp is None else self._tp.rank,
            "cache_heads": int(self.cache.k.shape[3]),
            "wq_heads": int(self.params["layers"][0]["wq"].shape[1]),
            "ff1_cols": int(self.params["layers"][0]["ff1"].shape[1]),
            "launches": dict(da.LAUNCHES),
            "collectives": dict(self._tp.group.counts) if self._tp is not None else {},
            "all_reduce_s": self._tp.group.seconds["all_reduce"] if self._tp is not None else 0.0,
            "max_memory_allocated": (torch.cuda.max_memory_allocated(self.device)
                                     if cuda else 0),
        }

    def reset_rank_counters(self) -> None:
        """Zero the paged-kernel launch counts and the collective counts
        on every rank (and the peak memory statistic on a GPU)."""
        self._on_ranks("_rank_reset_counters")

    def _rank_reset_counters(self) -> None:
        from ..ops.kernels import decode_attention as da

        da.reset_launch_counts()
        if self._tp is not None:
            self._tp.group.reset_counters()
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)

    def _register_strategy_predictions(self) -> None:
        """Put the chosen serving layout's predicted step times into the
        truth ledger (keys ``serving_strategy:prefill`` / ``:decode``), so
        drift telemetry covers the layout decision: measured steps pair
        against the search's estimate. ``alarm=False``: the strategy
        simulator ranks layouts and is expected to miss wall seconds."""
        ch = self.serving_strategy
        if ch is None:
            return
        prov = (
            f"predict_strategy_time over TP candidates "
            f"{[c['tp_degree'] for c in ch.candidates]} on "
            f"{ch.device_kind}"
        )
        self.ledger.predict(
            "serving_strategy:prefill", ch.prefill_s,
            label=f"serving layout tp={ch.tp_degree} (prefill)",
            provenance=prov, alarm=False,
        )
        self.ledger.predict(
            "serving_strategy:decode", ch.decode_s,
            label=f"serving layout tp={ch.tp_degree} (decode)",
            provenance=prov, alarm=False,
        )

    # ------------------------------------------------------------ geometry
    def bucket_for(self, prompt_len: int) -> int:
        for b in self.buckets:
            if prompt_len <= b:
                return b
        raise ValueError(
            f"prompt length {prompt_len} exceeds the largest bucket {self.buckets[-1]}"
        )

    def reset(self) -> None:
        """Tear down device-side generation state after a crash or a
        stalled step: zero the KV cache IN PLACE (the captured graphs hold
        its addresses), restore the allocator's free list and drop the
        prefix index. Graphs and ``trace_counts`` survive, so recovery
        captures nothing again; the scheduler journal-replays every live
        stream into the fresh cache. A tensor-parallel engine zeroes every
        rank's shard."""
        self._on_ranks("_rank_reset")
        self.allocator.reset()
        # the prefix index is bound to the zeroed cache: drop every entry
        # wholesale (replay then recomputes, which is byte-exact)
        self.prefix_cache.reset()
        self.last_finite = np.ones((self.max_batch_slots,), bool)
        self.resets += 1

    def _rank_reset(self) -> None:
        """This rank's device state: the cache, the bias, the masks (in
        place: graphs hold their addresses)."""
        self.cache.reset()
        self._bias.zero_()
        for m in (self._mask1, self._mask_dec, self._mask_ver):
            if m is not None:
                m.zero_()

    def recompiles(self) -> Dict[str, int]:
        """Shape signatures beyond the first, per step kind."""
        return {k: v - 1 for k, v in self.trace_counts.items() if v > 1}

    def serving_strategy_block(self) -> Dict:
        """The ``serving_strategy`` metadata block (engine metadata,
        ``GET /v2/models/{name}``, ``obsreport summary``): mesh geometry,
        the chosen layout and every scored TP candidate."""
        block: Dict = {"tp_degree": self.tp_degree, "mesh_devices": self.mesh_devices}
        if self.layout is not None:
            block["layout"] = self.layout.describe()
            block["transport"] = self.layout.mesh.backend
            block["devices"] = [str(d) for d in self.layout.mesh.devices]
            block["graphs"] = self.graphs  # false at tp > 1: eager steps
        if self.serving_strategy is not None:
            block["search"] = self.serving_strategy.describe()
        return block

    def total_flops(self) -> float:
        """Cumulative useful model FLOPs across all step kinds."""
        return sum(self.flops_by_kind.values())

    @property
    def device_time_s(self) -> Dict[str, float]:
        """Per kind, dispatch + execute + readback seconds."""
        return {k: sum(v.values()) for k, v in self.phase_time_s.items()}

    def total_device_time_s(self) -> float:
        return sum(self.device_time_s.values())

    def total_execute_time_s(self) -> float:
        """Cumulative execute seconds, the MFU denominator."""
        return sum(v["execute"] for v in self.phase_time_s.values())

    def mfu(self) -> float:
        """Serving model-FLOPs utilization: useful FLOPs over execute
        seconds against the chip preset's fp32 peak (0 before any step)."""
        t = self.total_execute_time_s()
        if t <= 0:
            return 0.0
        return self.total_flops() / t / self.flops_model.peak_flops

    def _new_signature(self, kind: str, sig, arrays) -> bool:
        """Count ``sig`` in ``trace_counts`` and register it with the
        program registry the first time it runs (on the graph path: the
        step that captures it). Returns whether it was new."""
        if sig in self._steps:
            return False
        self.trace_counts[kind] = self.trace_counts.get(kind, 0) + 1
        self.programs.note_trace(kind, arrays)
        return True

    def _account(self, kind: str, name: str, flops: float, traced: bool, elapsed: float,
                 execute_s: float, predicted_s: float) -> None:
        """Post-success accounting of one step: FLOPs accrue next to the
        time they pair with; a step that captured its program stamps its
        wall time into the registry instead of feeding the truth ledger
        (a capture is not a steady step). A steady full prefill or decode
        step also pairs with the layout search's estimate, as in the JAX
        engine."""
        self.flops_by_kind[kind] += flops
        if traced:
            self.programs.set_compile_time(name, elapsed)
            return
        self.ledger.observe(
            name, predicted_s, execute_s,
            label=f"{name} ({self.flops_model.chip.name})",
            provenance="serving roofline (ServingFlops x chip peak)",
            alarm=self._roofline_alarm,
        )
        if self.serving_strategy is not None:
            if name == "decode":
                self.ledger.measure("serving_strategy:decode", execute_s)
            elif name.startswith("prefill["):
                self.ledger.measure("serving_strategy:prefill", execute_s)

    def _run(self, kind: str, shape: Tuple[int, ...], arrays, body: StepBody,
             phase: str, t0: float, bias=None, mask_name: str = "1",
             mask=None) -> Tuple[np.ndarray, bool, float, float]:
        """One sequential step of ``kind`` whose input signature is
        ``shape``, run by the body method ``body`` with the step inputs
        ``bias`` / ``mask`` (:meth:`_step_inputs`) and started at
        host time ``t0``: counts a new signature, keeps the step's logits
        in ``last_logits``, stamps its dispatch / execute / readback split
        under ``phase`` and its spans. Returns (readback, whether it met a
        new signature, elapsed seconds, execute seconds)."""
        sig = (kind, shape)
        traced = self._new_signature(kind, sig, arrays)
        handle = self._dispatch_step(sig, arrays, body, bias, mask_name, mask)
        t_disp = time.perf_counter()
        readback, self.last_logits = self._steps.collect(handle)
        t_exec = time.perf_counter()
        ph = self.phase_time_s[phase]
        ph["dispatch"] += t_disp - t0
        ph["execute"] += t_exec - t_disp
        # collect's wait and its copy out of the pinned buffer are one
        # call: the readback span is the rest of the step's bookkeeping
        t_read = time.perf_counter()
        ph["readback"] += t_read - t_exec
        self.last_step_spans = [
            ("dispatch", t0, t_disp),
            ("block", t_disp, t_exec),
            ("execute", t_disp, t_exec),
            ("readback", t_exec, t_read),
        ]
        return readback, traced, t_read - t0, t_exec - t_disp

    @contextlib.contextmanager
    def _step_inputs(self, bias: Optional[np.ndarray], mask_dev: torch.Tensor, mask):
        """Around one step's launch: write a fault plan's poisoned bias
        into the device bias and the step's grammar-mask rows into
        ``mask_dev`` (in place: the graphs read both), then zero what was
        written once the step is launched, in stream order. ``bias`` is
        None or the untouched zero bias when there is no poison; ``mask``
        is None (no constrained row) or a dict {index into ``mask_dev``'s
        leading dims: [V] row}. One host-to-device copy covers the span of
        rows written. A mask that cannot be staged raises."""
        poisoned = bias is not None and bias is not self._zero_bias
        if poisoned:
            self._bias.copy_(torch.from_numpy(np.asarray(bias, np.float32)))
        span = None
        try:
            span = self._stage_mask(mask_dev, mask)
            yield
        finally:
            if poisoned:
                self._bias.zero_()
            if span is not None:
                mask_dev.view(-1, mask_dev.shape[-1])[span[0]:span[1]].zero_()

    def _stage_mask(self, dev: torch.Tensor, mask) -> Optional[Tuple[int, int]]:
        """Write ``mask``'s rows into ``dev`` (viewed [R, V]) with one copy
        of their span; returns the span, or None when nothing was
        written."""
        if not mask:
            return None
        v = dev.shape[-1]
        lead = tuple(dev.shape[:-1]) or (1,)
        rows = {int(np.ravel_multi_index(np.atleast_1d(k), lead)): r for k, r in mask.items()}
        lo, hi = min(rows), max(rows) + 1
        host = np.zeros((hi - lo, v), np.float32)
        for i, r in rows.items():
            if np.shape(r) != (v,):
                raise ValueError(f"grammar mask row of shape {np.shape(r)}, the vocabulary is {v}")
            host[i - lo] = r
        dev.view(-1, v)[lo:hi].copy_(torch.from_numpy(host))
        self.mask_bytes_staged += host.nbytes
        self.masked_step_count += 1
        return lo, hi

    def _mask_tensor(self, name: str) -> torch.Tensor:
        """The grammar-mask tensor a step kind reads: ``"1"`` ([V], both
        prefill kinds), ``"dec"`` ([B, V]) or ``"ver"`` ([B, W, V], made
        at the first verify, as the JAX engine makes its verify zeros)."""
        if name == "1":
            return self._mask1
        if name == "dec":
            return self._mask_dec
        if self._mask_ver is None:
            self._mask_ver = torch.zeros(
                (self.max_batch_slots, self.spec_window, self.cfg.vocab_size),
                dtype=torch.float32, device=self.device)
        return self._mask_ver

    def _rank_step(self, body: StepBody, sig, arrays, bias, mask_name: str, mask,
                   carry: Optional[Dict[str, torch.Tensor]] = None) -> InFlight:
        """Dispatch one step of ``sig`` on this rank: the step inputs
        written (:meth:`_step_inputs`), then the body method ``body``."""
        with self._step_inputs(bias, self._mask_tensor(mask_name), mask):
            return self._steps.dispatch(sig, arrays, body, carry=carry)

    def _dispatch_step(self, sig, arrays, body: StepBody, bias, mask_name: str, mask,
                       carry: Optional[InFlightDecode] = None, seq: Optional[int] = None
                       ) -> InFlight:
        """Dispatch one step on every rank (rank 0's handle is returned):
        the workers get the op with its host inputs (the body by name),
        the poisoned bias
        (None when there is none), the grammar rows, and for a decode step
        its dispatch number and the number of the step whose tokens it
        carries (each rank carries its own sampled tokens, which equal rank
        0's)."""
        carry_dev = None if carry is None else {"tokens": carry.tokens_dev}
        if self._group is None:
            return self._rank_step(body, sig, arrays, bias, mask_name, mask, carry_dev)
        poison = None if bias is None or bias is self._zero_bias else np.asarray(bias, np.float32)
        return self._on_ranks(
            "_rank_step", body, sig, arrays, poison, mask_name, mask, carry_dev,
            worker_op="_worker_step",
            worker_args=(body.__name__, sig, arrays, poison, mask_name, mask, seq,
                         None if carry is None else carry.seq))

    def _worker_step(self, body_name: str, sig, arrays, bias, mask_name: str, mask,
                     seq: Optional[int], carry_seq: Optional[int]) -> None:
        """A worker rank's side of :meth:`_dispatch_step`: run the step
        (the body method named ``body_name``) to its end; keep a decode
        step's sampled tokens for the step that carries them."""
        carry = None if carry_seq is None else {"tokens": self._carried[carry_seq]}
        handle = self._rank_step(getattr(self, body_name), sig, arrays, bias, mask_name, mask,
                                 carry)
        self._steps.collect(handle)
        if seq is not None:
            self._carried[seq] = handle.readback_dev[: self.max_batch_slots]
            for old in [k for k in self._carried if k < seq - 1]:
                del self._carried[old]

    # --------------------------------------------------------- step bodies
    def _prefill_body(self, x: Dict[str, torch.Tensor]):
        tokens, length = x["tokens"], x["length"]
        s = tokens.shape[1]
        cache_k, cache_v = self.cache.k, self.cache.v
        bs = cache_k.shape[2]
        logits, ks, vs = prefill(self.params, tokens, length, tp=self._tp)
        positions = torch.arange(s, dtype=torch.int32, device=tokens.device)
        slots = slot_mapping(x["table"], positions, bs)
        slots = torch.where(positions < length, slots, torch.zeros_like(slots)).long()
        for li in range(cache_k.shape[0]):  # padding -> scratch block 0, cast to the cache's dtype
            cache_k[li].view(-1, *cache_k.shape[3:])[slots] = ks[li, 0].to(cache_k.dtype)
            cache_v[li].view(-1, *cache_v.shape[3:])[slots] = vs[li, 0].to(cache_v.dtype)
        last = logits[0].index_select(0, (length - 1).long())  # [1, V], device-indexed
        ok = torch.isfinite(last).all(dim=-1)  # blame: a poisoned prompt
        last = last + self._mask1  # the grammar mask: finite, after the flag
        noise = prng.gumbel(derive_keys(x["seed"], x["count"]), (last.shape[-1],))
        token = _sample(last, x["temp"], x["top_k"], noise)
        return torch.cat([token, ok.to(torch.int32)]), last[0]

    def _decode_body(self, x: Dict[str, torch.Tensor]):
        logits, _, _ = decode_step(
            self.params, x["tokens"], x["positions"], self.cache.k, self.cache.v,
            x["tables"], x["context_lens"], tp=self._tp,
        )
        # the fault plan's per-slot NaN poison (zeros outside chaos runs),
        # added before the finiteness reduce, then the grammar rows
        # (finite: the flags trip on NaN, never on a banned token)
        logits = logits + self._bias[:, None] + self._mask_dec
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
            self.params, window, positions, self.cache.k, self.cache.v, x["tables"], tp=self._tp
        )
        # the grammar rows per window position: draft and target score the
        # same masked logits, so acceptance stays exact
        logits = logits + self._bias[:, None, None] + self._mask_ver
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
            self.params, tokens, positions, self.cache.k, self.cache.v, x["table"][None],
            tp=self._tp,
        )
        last = logits[0].index_select(0, (n_real - 1).long())  # [1, V], device-indexed
        ok = torch.isfinite(last).all(dim=-1)  # blame: a poisoned prompt
        last = last + self._mask1  # the grammar mask (see _prefill_body)
        noise = prng.gumbel(derive_keys(x["seed"], x["count"]), (last.shape[-1],))
        token = _sample(last, x["temp"], x["top_k"], noise)
        return torch.cat([token, ok.to(torch.int32)]), last[0]

    # ------------------------------------------------------ block programs
    # admission-time copies over whole blocks of every layer, in place:
    # the step graphs hold the cache tensors' addresses. Each runs on
    # every rank's shard.
    def _copy_block(self, src: int, dst: int) -> None:
        """COW: duplicate one block's K/V across all layers."""
        self._on_ranks("_rank_copy_block", src, dst)

    def _rank_copy_block(self, src: int, dst: int) -> None:
        for t in (self.cache.k, self.cache.v):
            t[:, dst].copy_(t[:, src])

    def _read_block(self, src: int) -> Tuple[np.ndarray, np.ndarray]:
        """Host-tier swap-out read: one block's K and V ([L, bs, H, D]
        each, every rank's heads), brought to the host in one copy
        (``prefix.to_host``'s bytes: a bfloat16 cache's as uint16 bits)."""
        kv = self._on_ranks("_rank_read_blocks", [src])
        return np.ascontiguousarray(kv[0][:, 0]), np.ascontiguousarray(kv[1][:, 0])

    def _rank_read_blocks(self, ids: Sequence[int]) -> Optional[np.ndarray]:
        """Blocks ``ids``' K and V, [2, L, n, bs, H, D], on the host
        (``to_host``'s bytes) on rank 0: one gather from the cache, and on
        a group the ranks' heads gathered to rank 0 and joined; None on
        the other ranks."""
        idx = torch.tensor(list(ids), dtype=torch.long).to(self.device)
        kv = torch.stack((self.cache.k.index_select(1, idx), self.cache.v.index_select(1, idx)))
        if self._tp is not None:
            from ..parallel.distributed import gather_to_root

            parts = gather_to_root(kv, self._tp.group)
            if parts is None:
                return None
            kv = torch.cat(parts, dim=4)
        return to_host(kv)

    def _write_block(self, dst: int, host_k: np.ndarray, host_v: np.ndarray) -> None:
        """Host-tier swap-in write: one block's K/V back into ``dst``."""
        self._write_blocks([dst], host_k[:, None], host_v[:, None])
        self._block_writes += 1

    def _write_blocks(self, ids: Sequence[int], host_k: np.ndarray, host_v: np.ndarray) -> None:
        """Write full-head K and V ([L, n, bs, H, D] host arrays, a
        bfloat16 cache's as uint16 bits) into blocks ``ids`` on every
        rank, each rank its own heads."""
        dt = self.cache.k.dtype
        kv = torch.stack((from_host(host_k, dt), from_host(host_v, dt)))
        self._on_ranks("_rank_write_blocks", list(ids), kv,
                       worker_args=(list(ids), None))

    def _rank_write_blocks(self, ids: List[int], kv: Optional[torch.Tensor]) -> None:
        """This rank's heads of ``kv`` ([2, L, n, bs, H, D] on rank 0;
        None on the others, which get theirs scattered from rank 0) into
        blocks ``ids``: one upload and one indexed write into ``cache.k``
        and ``cache.v`` each, in place, on the current stream."""
        k, v = self.cache.k, self.cache.v
        if self._tp is not None:
            from ..parallel.distributed import scatter_from_root

            hl = k.shape[3]
            parts = None if kv is None else [
                kv.narrow(4, r * hl, hl) for r in range(self._tp.tp_degree)]
            kv = scatter_from_root(parts, (2, k.shape[0], len(ids)) + tuple(k.shape[2:]),
                                   k.dtype, self._tp.group)
        kv = kv.to(self.device)
        idx = torch.tensor(ids, dtype=torch.long).to(self.device)
        k.index_copy_(1, idx, kv[0])
        v.index_copy_(1, idx, kv[1])

    # ------------------------------------------------- prefill->decode wire
    def pack_kv_blocks(self, table: Sequence[int], n_positions: int) -> KVHandoffPayload:
        """Pack the blocks covering positions ``[0, n_positions)`` into
        the prefill->decode wire format: one gather of the table's blocks
        from ``cache.k``/``cache.v`` and one copy to the host
        (:func:`~.prefix.to_host`'s bytes, a bfloat16 cache's as uint16
        bits), each block CRC-stamped at packing time."""
        n = self.cache_config.blocks_for(n_positions)
        kv = self._on_ranks("_rank_read_blocks", list(table[:n]))
        blocks = [
            PackedBlock(np.ascontiguousarray(kv[0][:, i]), np.ascontiguousarray(kv[1][:, i]))
            for i in range(n)
        ]
        return KVHandoffPayload(n_positions, self.cache_config.block_size, blocks)

    def import_kv_block(self, dst: int, host_k: np.ndarray, host_v: np.ndarray) -> None:
        """Commit one wire block into this engine's cache at ``dst``."""
        self.import_kv_blocks([dst], [PackedBlock(host_k, host_v)])

    def import_kv_blocks(self, dsts: Sequence[int], blocks: Sequence[PackedBlock]) -> None:
        """Commit one payload's wire blocks (CRC-verified by the caller):
        one upload of K and V and one indexed write into ``cache.k`` and
        ``cache.v`` each, in place (the step graphs hold the cache
        tensors' addresses). The writes run on the current stream, ahead
        of any later step that reads the blocks. The wire's full-head
        blocks are re-split over a tensor-parallel engine's ranks."""
        self._write_blocks(list(dsts), np.stack([b.host_k for b in blocks], axis=1),
                           np.stack([b.host_v for b in blocks], axis=1))

    # --------------------------------------------------------------- steps
    def prefill_one(
        self,
        prompt: Sequence[int],
        block_table: Sequence[int],
        sampling: SamplingParams,
        sample_index: int = 0,
        prefix_len: int = 0,
        mask=None,
    ) -> int:
        """Prefill one sequence into its allocated blocks and sample its
        first generated token. ``block_table`` is the sequence's block ids
        (padded internally to the engine's fixed table width);
        ``sample_index`` is the request's generated-token count, which
        indexes its sampling noise stream. ``prefix_len`` > 0 means
        positions [0, prefix_len) are already cached (shared prefix blocks
        at the front of the table): only the suffix is computed, a
        ``prefix_prefill[W]`` step per suffix bucket W, counted as a
        prefill step. ``mask`` is an optional [V] grammar row (0 / NEG)
        added to the sampled position's logits."""
        faults.inject(faults.GENERATION_PREFILL, prompt)
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
        (token, ok), traced, elapsed, execute_s = self._run(
            kind, (bucket,), arrays, body, "prefill", t0,
            mask_name="1", mask=None if mask is None else {0: mask})
        self.last_finite = np.asarray([bool(ok)])
        self.step_seconds["prefill"] += time.perf_counter() - t0
        fm = self.flops_model
        if prefix_len > 0:
            # useful work: the suffix tokens, each over its causal context;
            # the prediction covers the executed (padded) window
            ctx = (len(prompt) * (len(prompt) + 1) - prefix_len * (prefix_len + 1)) // 2
            flops = fm.verify_flops(n, ctx)
            predicted = fm.roofline_s(fm.verify_flops(bucket, ctx), fm.verify_bytes(bucket, ctx))
        else:
            flops = fm.prefill_flops(n)
            predicted = fm.roofline_s(fm.prefill_flops(bucket), fm.prefill_bytes(bucket))
        self._account("prefill", kind, flops, traced, elapsed, execute_s, predicted)
        return int(token)

    # ------------------------------------------------------ prefix caching
    def prefix_plan(self, prompt: Sequence[int]) -> PrefixPlan:
        """Match ``prompt`` against the radix index and decide what to
        reuse. Offloaded entries in the matched run are used only when the
        host->device transfer beats recomputing the same positions on the
        device's roofline; otherwise the run truncates at the first
        offloaded entry. A failed lookup (the ``generation.prefix_lookup``
        site) degrades to a miss: full recompute, the same tokens."""
        pc = self.prefix_cache
        if not pc.enabled or len(prompt) < 2:
            return EMPTY_PREFIX_PLAN
        try:
            faults.inject(faults.GENERATION_PREFIX_LOOKUP, list(prompt))
            run = pc.match(prompt)
        except Exception:
            pc.recompute_fallbacks += 1
            return EMPTY_PREFIX_PLAN
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
        the ``generation.kv_offload`` site raises or the copy is corrupt
        or gone."""
        pc = self.prefix_cache
        try:
            faults.inject(faults.GENERATION_KV_OFFLOAD, ("in", 1))
            buf = pc.take_host_copy(entry)
            if buf is None:  # corrupted or already dropped
                raise ValueError("host-tier block failed CRC verification")
            self._write_block(dst, *buf)
        except Exception:
            pc.swap_in_failures += 1
            pc.recompute_fallbacks += 1
            return False
        return True

    def _swap_in(self, entry: PrefixEntry, dst: int) -> bool:
        """Bring one offloaded entry's K/V back to device block ``dst``:
        the entry is resident again. The (predicted, measured) transfer
        time joins the truth ledger as ``kv_swap_in``, except for the
        engine's first block write (the JAX engine's compile)."""
        pc = self.prefix_cache
        predicted = pc.swap_in_cost_s(1)
        writes_before = self._block_writes
        t0 = time.perf_counter()
        if not self._write_host_copy(entry, dst):
            return False
        pc.note_swapped_in(entry, dst)
        elapsed = time.perf_counter() - t0
        if writes_before:
            self.ledger.observe(
                "kv_swap_in", predicted, elapsed,
                label="kv_swap_in (host tier)",
                provenance="host-tier transfer model (link bytes/s)",
                alarm=self._roofline_alarm,
            )
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

        def read(block_id: int):
            faults.inject(faults.GENERATION_KV_OFFLOAD, ("out", 1))
            return self._read_block(block_id)

        return self.prefix_cache.reclaim(max(1, n_blocks), read)

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
        mask=None,
    ) -> np.ndarray:
        """One decode step across all ``max_batch_slots`` slots, dispatched
        and consumed at once (the sequential loop's step). Arrays are
        slot-indexed; inactive slots (active[i] False) write to scratch and
        return garbage tokens the scheduler ignores. After the call
        ``last_finite[i]`` says whether slot i's logits were finite.
        ``seeds``/``counts`` key each slot's sampling noise; ``mask`` holds
        the constrained slots' grammar rows ({slot: [V] row})."""
        step = self.decode_async(tokens, positions, block_tables, active, temps, top_ks, seeds,
                                 counts, mask=mask)
        out = self.consume_decode(step)
        self.last_step_spans.insert(0, ("dispatch", step.t0, step.t_disp))
        return out

    def decode_async(
        self,
        tokens: Optional[np.ndarray],
        positions: np.ndarray,
        block_tables: np.ndarray,
        active: np.ndarray,
        temps: np.ndarray,
        top_ks: np.ndarray,
        seeds: np.ndarray,
        counts: np.ndarray,
        carry: Optional[InFlightDecode] = None,
        mask=None,
    ) -> InFlightDecode:
        """Dispatch one decode step WITHOUT waiting for it: the overlap
        pipeline's front half. :meth:`consume_decode` collects it one
        scheduler iteration later.

        ``carry`` is the previous in-flight step: its sampled tokens are
        this step's token input, copied device to device (``tokens`` is
        then ignored, and the fault site sees None for them, as in the
        JAX engine's carry mode). Inactive slots in carry mode feed
        whatever token the dead slot sampled; their writes land in
        scratch block 0 and their outputs are dropped. On the CPU the
        step runs here, synchronously."""
        if carry is None:
            masked = np.where(active, tokens, 0).astype(np.int32)
        else:
            masked = None
        masked, bias = faults.inject(faults.GENERATION_DECODE_STEP, (masked, self._zero_bias))
        if self.tp_degree > 1:
            # the ranks' collectives can fail or wedge like any device
            # work: chaos plans target them here, before any rank is sent
            # the step
            faults.inject(faults.GENERATION_COLLECTIVE, ("decode", self.tp_degree))
        self.step_counts["decode"] += 1
        t0 = time.perf_counter()
        host_tokens = masked if masked is not None else np.zeros((self.max_batch_slots,), np.int32)
        arrays = self.decode_arrays(host_tokens, positions, block_tables, active)
        arrays.update(
            temps=np.asarray(temps, np.float32),
            top_ks=np.asarray(top_ks, np.int32),
            seeds=np.asarray(seeds).astype(np.uint32),
            counts=np.asarray(counts, np.int32),
        )
        b, mb = arrays["tables"].shape
        sig = ("decode", (b, mb))
        traced = self._new_signature("decode", sig, arrays)
        self._decode_seq += 1
        handle = self._dispatch_step(sig, arrays, self._decode_body, bias, "dec", mask,
                                     carry=carry, seq=self._decode_seq)
        t_disp = time.perf_counter()
        self.phase_time_s["decode"]["dispatch"] += t_disp - t0
        self.step_seconds["decode"] += t_disp - t0
        return InFlightDecode(handle, t0, t_disp, int(np.sum(active)), b,
                              ctx_sum=int(arrays["context_lens"].sum()), traced=traced,
                              seq=self._decode_seq)

    def consume_decode(self, step: InFlightDecode) -> np.ndarray:
        """Wait for an in-flight decode step and read it back: the
        pipeline's back half. Returns its sampled tokens [B] and sets
        ``last_finite`` and ``last_logits`` (the latter overwritten by the
        next replay)."""
        if step.consumed:
            raise RuntimeError("InFlightDecode consumed twice")
        step.consumed = True
        t_block = time.perf_counter()
        readback, logits = self._steps.collect(step.handle)
        t_exec = time.perf_counter()
        b = self.max_batch_slots
        self.last_finite = readback[b:].astype(bool)
        self.last_logits = logits
        tokens = readback[:b]
        t_read = time.perf_counter()
        # host-clock view: from when the device could start this step (its
        # dispatch, or its predecessor's completion) to its observed end
        ph = self.phase_time_s["decode"]
        ph["execute"] += t_exec - step.t_started
        ph["readback"] += t_read - t_exec
        self.step_seconds["decode"] += t_read - t_block
        # two lanes: "execute" from when the device could start the step,
        # "block" only the host's wait inside this call
        self.last_step_spans = [
            ("block", t_block, t_exec),
            ("execute", step.t_started, t_exec),
            ("readback", t_exec, t_read),
        ]
        # the prediction covers the executed work: every slot's projections
        # run in the fixed-shape step; only attention context is live-only
        fm = self.flops_model
        self._account(
            "decode", "decode", fm.decode_flops(step.n_active, step.ctx_sum), step.traced,
            t_read - step.t0, t_exec - step.t_started,
            fm.roofline_s(fm.decode_flops(b, step.ctx_sum), fm.decode_bytes(b, step.ctx_sum)),
        )
        return tokens

    def discard_decode(self, step: InFlightDecode) -> None:
        """Drop an in-flight decode step without reading it: wait for it
        (its error, if any, is swallowed) so its buffers can be reused.
        Its cache writes need no undo (see the module doc)."""
        if step.consumed:
            return
        step.consumed = True
        try:
            self._steps.collect(step.handle)
        except Exception:
            pass

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
        mask=None,
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
        ``n_draft`` values, never the shape. ``mask`` holds the
        constrained slots' grammar rows per window position ({(slot, j):
        [V] row})."""
        b, w = self.max_batch_slots, self.spec_window
        if window_tokens.shape != (b, w):
            raise ValueError(f"verify window {window_tokens.shape}, the engine's is {(b, w)}")
        window = np.asarray(window_tokens, np.int32)
        window, bias = faults.inject(faults.GENERATION_VERIFY, (window, self._zero_bias))
        if self.tp_degree > 1:
            faults.inject(faults.GENERATION_COLLECTIVE, ("verify", self.tp_degree))
        self.step_counts["verify"] += 1
        t0 = time.perf_counter()
        arrays = {
            "window": window,
            "start": np.asarray(start, np.int32),
            "n_draft": np.asarray(n_draft, np.int32),
            "tables": np.asarray(block_tables, np.int32),
            "temps": np.asarray(temps, np.float32),
            "top_ks": np.asarray(top_ks, np.int32),
            "seeds": np.asarray(seeds).astype(np.uint32),
            "counts": np.asarray(counts, np.int32),
        }
        readback, traced, elapsed, execute_s = self._run(
            "verify", (b, w, arrays["tables"].shape[1]), arrays, self._verify_body,
            "verify", t0, bias=bias, mask_name="ver", mask=mask)
        self.last_finite = readback[b * w + b:].astype(bool)
        self.step_seconds["verify"] += time.perf_counter() - t0
        # useful work per live slot: n_draft + 1 window tokens, token j at
        # position start + j attending start + j + 1 positions; the
        # prediction covers all B x W executed window positions
        nd = np.maximum(arrays["n_draft"], 0).astype(np.int64)
        live = arrays["n_draft"] >= 0
        w_tok = np.where(live, nd + 1, 0)
        ctx = int(np.where(live, w_tok * (arrays["start"].astype(np.int64) + 1)
                           + nd * (nd + 1) // 2, 0).sum())
        fm = self.flops_model
        self._account("verify", "verify", fm.verify_flops(int(w_tok.sum()), ctx), traced,
                      elapsed, execute_s,
                      fm.roofline_s(fm.verify_flops(b * w, ctx), fm.verify_bytes(b * w, ctx)))
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


def _rank_engine(group, rank: int, tp_degree: int, ffn_sharded: bool, params, cfg,
                 cache_config, device: str, **kwargs) -> GenerationEngine:
    """A worker rank's engine (the factory ``parallel/distributed.py``
    calls in each spawned rank): its shard of the parameters, a cache of
    its heads, eager steps, no prefix index (the host state is rank
    0's)."""
    return GenerationEngine(
        _from_host_tree(params), cfg, cache_config, device=device, eager_steps=True,
        prefix_cache=False, _rank=RankContext(rank, tp_degree, ffn_sharded, group), **kwargs)


def _host_tree(params: DecoderParams) -> Dict:
    """A parameter dictionary as host arrays (``prefix.to_host``'s bytes):
    a rank's shard crosses to its process by value through the pipe,
    never through shared memory, whose size a container may cap."""
    out = {k: to_host(v) for k, v in params.items() if k != "layers"}
    out["layers"] = [{k: to_host(t) for k, t in layer.items()} for layer in params["layers"]]
    out["dtypes"] = {k: str(v.dtype) for k, v in params.items() if k != "layers"}
    out["layer_dtypes"] = [{k: str(t.dtype) for k, t in layer.items()}
                           for layer in params["layers"]]
    return out


def _from_host_tree(tree: Dict) -> DecoderParams:
    def dt(name):
        return getattr(torch, name.replace("torch.", ""))

    out = {k: from_host(v, dt(tree["dtypes"][k])) for k, v in tree.items()
           if k not in ("layers", "dtypes", "layer_dtypes")}
    out["layers"] = [{k: from_host(a, dt(dts[k])) for k, a in layer.items()}
                     for layer, dts in zip(tree["layers"], tree["layer_dtypes"])]
    return out
