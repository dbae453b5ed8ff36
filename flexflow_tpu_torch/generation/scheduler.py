"""Continuous batching: iteration-level scheduling of generation
requests (Orca, OSDI'22) over the block KV cache (port of the core of
``flexflow_tpu/generation/scheduler.py``).

Every ``step()`` runs ONE decode across the engine's fixed batch slots —
or ONE verify, when a running request speculates — and between steps the
batch recomposes freely —

* **join-mid-flight**: a queued request is admitted (FCFS) the moment a
  slot AND enough cache blocks are free; it prefills and decodes
  alongside sequences that are hundreds of tokens in;
* **prefix reuse**: admission matches the prompt against the engine's
  cross-request prefix cache (``prefix.py``), shares the cached blocks
  (swapping offloaded ones back in, copying the boundary block of a
  fully covered prompt) and prefills only the suffix; the prompt's
  written blocks join the cache after a finite prefill. Unreferenced
  cached blocks are reclaimed (offloaded to the host tier) before a
  request waits or a running one is preempted, and a preempted
  sequence's blocks are stashed in the cache for its re-admission;
* **free-on-finish**: a sequence hitting EOS / max-tokens / its deadline
  releases its blocks in the same step;
* **preempt-by-recompute**: if the cache cannot grow a running sequence,
  the youngest running sequence is evicted — blocks freed, prompt +
  generated-so-far re-queued at the FRONT — and later re-prefilled
  (vLLM's recompute preemption). Sampling noise is indexed by
  generated-token count, so a preempted request's token stream
  continues exactly where it left off;
* **speculation**: a request submitted with a SpeculationConfig drafts up
  to its adaptive k tokens per iteration, and the step verifies every
  slot's window in ONE fixed-shape ``engine.verify`` (a plain request in
  the batch is a zero-draft window, sampled exactly as decode samples).
  Blocks are grown for the whole window; under cache pressure the window
  shrinks before anyone is preempted, and the blocks a partly accepted
  window no longer covers are returned.

The queue is bounded (:class:`QueueFullError`) and requests carry
deadlines (:class:`DeadlineExceededError` before OR during generation),
on an injectable clock so tests run on virtual time. The scheduler is
synchronous: ``step()`` does one iteration and returns.
"""
from __future__ import annotations

import dataclasses
import itertools
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from ..serving.resilience import DeadlineExceededError, QueueFullError, ShuttingDownError
from .decoder import params_to
from .engine import GenerationEngine, SamplingParams
from .speculative.drafter import SpeculationConfig, build_drafter

_END = object()  # token-stream sentinel
_request_ids = itertools.count(1)


class GenerationHandle:
    """Caller's view of one request: a Future of the generated token
    list plus a per-token stream."""

    def __init__(self, request: "Request"):
        self._request = request
        self.future: Future = Future()
        self._tokens: "queue.Queue" = queue.Queue()

    def done(self) -> bool:
        return self.future.done()

    def result(self, timeout: Optional[float] = None) -> List[int]:
        return self.future.result(timeout=timeout)

    def cancel(self) -> None:
        """Ask the scheduler to drop this request at its next step."""
        self._request.cancelled = True

    def tokens(self, timeout: Optional[float] = None):
        """Iterate generated tokens as they are produced. Raises the
        request's failure if it errors mid-stream."""
        while True:
            item = self._tokens.get(timeout=timeout)
            if item is _END:
                return
            if isinstance(item, BaseException):
                raise item
            yield item

    # -------------------------------------------------------- scheduler
    def _emit(self, token: int) -> None:
        self._tokens.put(token)

    def _finish(self, tokens: List[int]) -> None:
        if self.future.done():
            return
        self.future.set_result(tokens)
        self._tokens.put(_END)

    def _fail(self, err: BaseException) -> bool:
        """Returns True only if THIS call failed the handle."""
        if self.future.done():
            return False
        self.future.set_exception(err)
        self._tokens.put(err)
        self._tokens.put(_END)
        return True


class Request:
    """One generation request. ``prompt`` may grow on preemption (the
    generated prefix is folded in for recompute); ``n_generated`` is the
    TOTAL generated count across preemptions, which also indexes the
    request's sampling noise stream. A speculating request carries its
    drafter and its adaptive k (``spec_k``, inside [1, speculation.k])."""

    def __init__(
        self,
        prompt: List[int],
        sampling: SamplingParams,
        deadline: Optional[float] = None,
        speculation: Optional[SpeculationConfig] = None,
        drafter=None,
    ):
        self.id = next(_request_ids)
        self.original_prompt = list(prompt)
        self.prompt = list(prompt)  # prompt + recomputed prefix
        self.sampling = sampling
        self.deadline = deadline  # absolute, scheduler clock
        # effective budget, possibly clamped to the cache room the
        # scheduler can actually give this sequence
        self.max_new = sampling.max_new_tokens
        self.generated: List[int] = []  # tokens generated so far (total)
        self.cancelled = False
        self.preemptions = 0
        self.handle = GenerationHandle(self)
        # speculation state: live k adapts inside [1, config.k]; the
        # drafter is a pure function of the prefix, so preemption needs
        # no drafter checkpointing
        self.speculation = speculation if (speculation and speculation.enabled) else None
        self.drafter = drafter if self.speculation else None
        self.spec_k = speculation.k if self.speculation else 0
        self.acc_ema: Optional[float] = None
        self.spec_proposed = 0
        self.spec_accepted = 0

    @property
    def n_generated(self) -> int:
        return len(self.generated)

    def update_speculation(self, proposed: int, accepted: int) -> None:
        """Fold one verification window into the adaptive-k state."""
        self.spec_proposed += proposed
        self.spec_accepted += accepted
        cfg = self.speculation
        if cfg is None or proposed <= 0:
            return
        rate = accepted / proposed
        self.acc_ema = (
            rate
            if self.acc_ema is None
            else cfg.ema_alpha * rate + (1.0 - cfg.ema_alpha) * self.acc_ema
        )
        if not cfg.adaptive:
            return
        if self.acc_ema < cfg.low_acceptance:
            self.spec_k = max(1, self.spec_k - 1)
        elif self.acc_ema >= cfg.high_acceptance:
            self.spec_k = min(cfg.k, self.spec_k + 1)

    def finished(self) -> bool:
        if self.n_generated >= self.max_new:
            return True
        eos = self.sampling.eos_id
        return eos is not None and bool(self.generated) and self.generated[-1] == eos


class _Running:
    """Slot-resident state for an admitted request."""

    __slots__ = ("req", "slot", "blocks", "cached_len", "admitted_seq", "step_k",
                 "shared_idx", "shared_entries")

    def __init__(self, req: Request, slot: int, blocks: List[int], cached_len: int,
                 admitted_seq: int, shared_idx=None, shared_entries=None):
        self.req = req
        self.slot = slot
        self.blocks = blocks
        self.cached_len = cached_len  # cache positions written so far
        self.admitted_seq = admitted_seq  # admission order, for LIFO preemption
        self.step_k = 0  # drafts planned for THIS step (<= req.spec_k)
        # prefix caching: table positions whose blocks the prefix index
        # owns (refcounted, immutable, freed by the index — never by this
        # sequence) and the entries this sequence holds
        self.shared_idx = shared_idx if shared_idx is not None else set()
        self.shared_entries = shared_entries if shared_entries is not None else []


class ContinuousBatchingScheduler:
    """``speculation`` is the default policy of requests submitted without
    their own; ``draft_params`` back ``method="draft_model"`` drafters
    (moved to the engine's device)."""

    def __init__(
        self,
        engine: GenerationEngine,
        *,
        max_queue: int = 256,
        clock: Callable[[], float] = time.monotonic,
        speculation: Optional[SpeculationConfig] = None,
        draft_params=None,
    ):
        self.engine = engine
        self.max_queue = max_queue
        self.clock = clock
        self.speculation_default = speculation
        self.draft_params = (
            None if draft_params is None else params_to(draft_params, engine.device)
        )
        self._queue: deque = deque()
        self._running: Dict[int, _Running] = {}  # slot -> state
        self._free_slots = list(range(engine.max_batch_slots - 1, -1, -1))
        self._lock = threading.Lock()
        self._admitted_seq = itertools.count()
        self.preemptions = 0
        # admitted / completed / expired / cancelled / rejected / failed,
        # and the speculation windows: spec_windows / spec_proposed /
        # spec_accepted / spec_emitted / drafter_errors
        self.counts: Dict[str, int] = {}

    def _incr(self, name: str, n: int = 1) -> None:
        self.counts[name] = self.counts.get(name, 0) + n

    # ------------------------------------------------------------- submit
    def submit(
        self,
        prompt: Sequence[int],
        sampling: Optional[SamplingParams] = None,
        deadline_s: Optional[float] = None,
        speculation: Optional[SpeculationConfig] = None,
    ) -> GenerationHandle:
        """Enqueue one request (FCFS). Raises QueueFullError when the
        bounded queue is full, DeadlineExceededError for an
        already-expired budget, and ValueError for a prompt that can
        never be served. ``speculation`` turns on (exact) speculative
        decoding for this request; None falls back to the scheduler's
        default policy."""
        sampling = sampling or SamplingParams()
        if not prompt:
            raise ValueError("empty prompt")
        if len(prompt) > self.engine.buckets[-1]:
            raise ValueError(
                f"prompt length {len(prompt)} exceeds max bucket {self.engine.buckets[-1]}"
            )
        room = self.engine.max_seq_len - len(prompt)
        if room < 1:
            raise ValueError(f"prompt fills max_seq_len {self.engine.max_seq_len}")
        if (
            self.engine.cache_config.blocks_for(len(prompt) + 1)
            > self.engine.allocator.num_total
        ):
            raise ValueError("prompt exceeds total cache capacity; can never be admitted")
        if deadline_s is not None and deadline_s <= 0:
            self._incr("expired")
            raise DeadlineExceededError("deadline already expired at submit")
        with self._lock:
            if len(self._queue) >= self.max_queue:
                self._incr("rejected")
                raise QueueFullError(f"generation queue full ({self.max_queue})")
            deadline = None if deadline_s is None else self.clock() + deadline_s
            spec = speculation if speculation is not None else self.speculation_default
            drafter = None
            if spec is not None and spec.enabled:
                # clamp to the engine's verify window so per-request k
                # NEVER changes the step's shape
                if spec.k > self.engine.max_spec_tokens:
                    spec = dataclasses.replace(spec, k=self.engine.max_spec_tokens)
                drafter = build_drafter(
                    spec, draft_params=self.draft_params, max_seq_len=self.engine.max_seq_len,
                )
            req = Request(list(prompt), sampling, deadline=deadline, speculation=spec,
                          drafter=drafter)
            # the sequence can never outgrow max_seq_len NOR the TOTAL
            # cache: a sequence needing more blocks than exist would
            # preempt itself forever at the head of the FCFS queue
            cache_room = (
                self.engine.allocator.num_total * self.engine.cache_config.block_size
                - len(prompt)
            )
            req.max_new = min(sampling.max_new_tokens, room, cache_room)
            self._queue.append(req)
        self._incr("admitted")
        return req.handle

    def has_work(self) -> bool:
        return bool(self._queue) or bool(self._running)

    def cache_report(self) -> Dict:
        """Allocator state, the per-request block residency and the
        prefix cache's snapshot. A running request's private blocks
        (``blocks - shared_blocks``) plus the prefix index's resident
        blocks sum to ``used``: a shared block is counted once, by the
        index."""
        alloc = self.engine.allocator
        cfg = alloc.config
        free = alloc.num_free
        residency = [
            {"request_id": s.req.id, "slot": s.slot, "blocks": len(s.blocks),
             "shared_blocks": len(s.shared_idx), "live_tokens": s.cached_len}
            for s in sorted(self._running.values(), key=lambda s: s.slot)
        ]
        return {
            "config": {"num_blocks": cfg.num_blocks, "block_size": cfg.block_size,
                       "bytes_per_block": cfg.bytes_per_block},
            "blocks": {"total": alloc.num_total, "free": free, "used": alloc.num_total - free},
            "queue_depth": len(self._queue),
            "residency": residency,
            "prefix_cache": self.engine.prefix_cache.snapshot(),
        }

    # ---------------------------------------------------------- internals
    def _release(self, state: _Running) -> None:
        # private blocks go back to the allocator; shared (index-owned)
        # blocks only drop this sequence's reference
        self.engine.release_admission(state.blocks, state.shared_idx, state.shared_entries)
        state.blocks = []
        state.shared_idx = set()
        state.shared_entries = []
        del self._running[state.slot]
        self._free_slots.append(state.slot)

    def _finish(self, state: _Running) -> None:
        self._release(state)
        state.req.handle._finish(list(state.req.generated))
        self._incr("completed")

    def _expire(self) -> None:
        now = self.clock()
        with self._lock:
            keep: deque = deque()
            for req in self._queue:
                if req.cancelled:
                    if req.handle._fail(ShuttingDownError("request cancelled")):
                        self._incr("cancelled")
                elif req.deadline is not None and now >= req.deadline:
                    if req.handle._fail(DeadlineExceededError("deadline expired while queued")):
                        self._incr("expired")
                else:
                    keep.append(req)
            self._queue = keep
        for state in list(self._running.values()):
            req = state.req
            if req.cancelled:
                self._release(state)
                if req.handle._fail(ShuttingDownError("request cancelled")):
                    self._incr("cancelled")
            elif req.deadline is not None and now >= req.deadline:
                self._release(state)
                if req.handle._fail(DeadlineExceededError("deadline expired mid-generation")):
                    self._incr("expired")

    def _preempt_self(self, state: _Running) -> None:
        """Evict ``state`` for recompute: stash its computed blocks in the
        prefix cache, free the rest, fold its generated tokens into the
        prompt, and requeue it at the FRONT."""
        # the stash: its re-admission (and any request sharing the
        # prefix) re-matches the blocks; under continued pressure they
        # offload to the host tier and swap back in
        self.engine.stash_prefix(state)
        self._release(state)
        req = state.req
        req.prompt = req.original_prompt + list(req.generated)
        req.preemptions += 1
        self.preemptions += 1
        with self._lock:
            self._queue.appendleft(req)

    def _preempt_youngest(self, exclude: Optional[_Running] = None) -> bool:
        """Evict the youngest running sequence (vLLM's LIFO recompute
        victim) other than ``exclude``, the sequence trying to grow.
        Returns False when there is none."""
        victims = [s for s in self._running.values() if s is not exclude]
        if not victims:
            return False
        self._preempt_self(max(victims, key=lambda s: s.admitted_seq))
        return True

    def _admit(self) -> bool:
        """FCFS, cache-capacity-aware admission with prefix reuse.
        Returns True if the queue's head was admitted (prefilled) or
        failed."""
        engine = self.engine
        with self._lock:
            if not self._queue or not self._free_slots:
                return False
            req = self._queue[0]
        plan = engine.prefix_plan(req.prompt)
        need = engine.cache_config.blocks_for(len(req.prompt) + 1) - plan.n_resident
        blocks = engine.allocator.allocate(need)
        if blocks is None and engine.reclaim_cached(need - engine.allocator.num_free):
            # unreferenced cached prefixes are reclaimed (offloaded to the
            # host tier) before the head waits
            blocks = engine.allocator.allocate(need)
        if blocks is None:
            return False
        with self._lock:
            self._queue.popleft()
            slot = self._free_slots.pop()
        prep = engine.prepare_prefix(req.prompt, plan, blocks)
        if prep is None:
            # a failed swap-in could not be replaced: everything was
            # handed back; requeue the head and retry next iteration
            self._free_slots.append(slot)
            with self._lock:
                self._queue.appendleft(req)
            return False
        table, shared_idx, entries, prefix_len = prep
        try:
            token = engine.prefill_one(
                req.prompt, table, req.sampling, sample_index=req.n_generated,
                prefix_len=prefix_len,
            )
            if not engine.last_finite[0]:
                raise FloatingPointError(
                    f"request {req.id} produced non-finite logits at prefill")
        except Exception as e:  # the one request fails; the batch goes on
            engine.release_admission(table, shared_idx, entries)
            self._free_slots.append(slot)
            if req.handle._fail(e):
                self._incr("failed")
            return True
        # the prompt's written blocks join the prefix index only after the
        # finiteness check: non-finite K/V never becomes shared content
        engine.register_prefix(req.prompt, table, shared_idx, entries, prefix_len=prefix_len)
        state = _Running(
            req, slot, table, cached_len=len(req.prompt),
            admitted_seq=next(self._admitted_seq),
            shared_idx=shared_idx, shared_entries=entries,
        )
        self._running[slot] = state
        self._emit_token(state, token)
        if req.finished():
            self._finish(state)
        return True

    def _emit_token(self, state: _Running, token: int) -> None:
        state.req.generated.append(int(token))
        state.req.handle._emit(int(token))

    def _plan_speculation(self) -> None:
        """Decide each running sequence's draft count for THIS step: its
        adaptive k, capped by the remaining token budget (never draft past
        max_new), the sequence-length ceiling, and — in _grow — cache
        pressure."""
        for state in self._running.values():
            req = state.req
            if req.drafter is None:
                state.step_k = 0
                continue
            budget = req.max_new - req.n_generated  # >= 1 while running
            pos_room = (self.engine.max_seq_len - 1) - state.cached_len
            state.step_k = max(0, min(req.spec_k, budget - 1, pos_room))

    def _grow(self) -> None:
        """Ensure every running sequence has cache blocks for its next
        window — up to step_k + 1 new positions. Under pressure, first
        shrink the window (cap speculation), then preempt-by-recompute."""
        for state in list(self._running.values()):
            if self._running.get(state.slot) is not state:
                continue  # preempted earlier in this sweep
            while True:
                need = self.engine.cache_config.blocks_for(
                    state.cached_len + state.step_k + 1
                )
                if len(state.blocks) >= need:
                    break
                got = self.engine.allocator.allocate(1)
                if got is None and self.engine.reclaim_cached(1):
                    # evict an unreferenced cached prefix (offloading it
                    # to the host tier) before shrinking anyone's window
                    # or preempting a live sequence
                    got = self.engine.allocator.allocate(1)
                if got is not None:
                    state.blocks.extend(got)
                    continue
                if state.step_k > 0:
                    # cap on cache pressure: give up drafts before
                    # evicting anyone
                    state.step_k -= 1
                    continue
                if not self._preempt_youngest(exclude=state):
                    # nothing left to evict but this sequence itself:
                    # recompute it later when capacity returns
                    self._preempt_self(state)
                    break

    def _collect_slots(self, order):
        """Slot-indexed arrays a batched decode step needs: the seed token
        (last emitted, not yet cached), its cache position, block tables,
        the live mask, and per-slot sampling params (``seeds``/``counts``
        index each slot's sampling noise)."""
        b = self.engine.max_batch_slots
        last = np.zeros((b,), np.int32)
        start = np.zeros((b,), np.int32)
        tables = np.zeros((b, self.engine.max_blocks_per_seq), np.int32)
        active = np.zeros((b,), bool)
        temps = np.zeros((b,), np.float32)
        top_ks = np.zeros((b,), np.int32)
        seeds = np.zeros((b,), np.uint32)
        counts = np.zeros((b,), np.int32)
        for state in order:
            i = state.slot
            req = state.req
            last[i] = req.generated[-1] if req.generated else req.prompt[-1]
            start[i] = state.cached_len  # next cache position
            tables[i, : len(state.blocks)] = state.blocks
            active[i] = True
            temps[i] = req.sampling.temperature
            top_ks[i] = req.sampling.top_k
            seeds[i] = req.sampling.seed & 0xFFFFFFFF
            counts[i] = req.n_generated
        return last, start, tables, active, temps, top_ks, seeds, counts

    def _decode_once(self) -> bool:
        if not self._running:
            return False
        order = sorted(self._running.values(), key=lambda s: s.slot)
        out = self.engine.decode(*self._collect_slots(order))
        self._scatter_decode(order, out)
        return True

    def _scatter_decode(self, order, out) -> int:
        """Scatter one decode step's sampled tokens back onto the slot
        states and finish the sequences that are done. Returns the number
        of tokens emitted."""
        n_live = 0
        finish = []
        for state in order:
            if self._running.get(state.slot) is not state:
                continue  # preempted/expired between collect and scatter
            state.cached_len += 1
            self._emit_token(state, int(out[state.slot]))
            n_live += 1
            if state.req.finished():
                finish.append(state)
        for state in finish:
            self._finish(state)
        return n_live

    def _trim_blocks(self, state: _Running) -> None:
        """Return trailing blocks a partially-accepted window no longer
        covers (their positions hold rejected-draft K/V the next window
        would rewrite anyway). cached_len + 1, not cached_len: the next
        step always writes position cached_len."""
        keep = max(1, self.engine.cache_config.blocks_for(state.cached_len + 1))
        if len(state.blocks) > keep:
            extra = state.blocks[keep:]
            del state.blocks[keep:]
            self.engine.allocator.free(extra)

    def _verify_once(self) -> bool:
        """One speculative verification step across all running slots:
        draft (host), verify the batch x (k+1) window (ONE fixed-shape
        device step), then emit each slot's accepted run — truncated at
        mid-window EOS and the request's budget."""
        if not self._running:
            return False
        b = self.engine.max_batch_slots
        w = self.engine.spec_window
        order = sorted(self._running.values(), key=lambda s: s.slot)
        last, start, tables, _active, temps, top_ks, seeds, counts = self._collect_slots(order)
        window = np.zeros((b, w), np.int32)
        window[:, 0] = last
        n_draft = np.full((b,), -1, np.int32)  # -1 = inactive slot
        for state in order:
            i = state.slot
            req = state.req
            draft: List[int] = []
            if state.step_k > 0 and req.drafter is not None:
                try:
                    # original_prompt, NOT prompt: after a preemption the
                    # recompute prompt already folds in generated tokens
                    draft = list(
                        req.drafter.propose(req.original_prompt + req.generated, state.step_k)
                    )[: state.step_k]
                except Exception:
                    # verification is exact with ANY draft, so a failed
                    # proposal degrades to a plain (zero-draft) window
                    self._incr("drafter_errors")
            window[i, 1: 1 + len(draft)] = draft
            n_draft[i] = len(draft)
        out, n_emitted = self.engine.verify(
            window, start, n_draft, tables, temps, top_ks, seeds, counts
        )
        for state in order:
            if self._running.get(state.slot) is not state:
                continue  # preempted/expired between collect and scatter
            req = state.req
            i = state.slot
            m = int(n_emitted[i])
            toks = [int(t) for t in out[i, :m]]
            # budget truncation: never emit past max_new
            toks = toks[: req.max_new - req.n_generated]
            # mid-window EOS: keep through the FIRST eos, drop the rest
            eos = req.sampling.eos_id
            if eos is not None and eos in toks:
                toks = toks[: toks.index(eos) + 1]
            proposed = int(max(0, n_draft[i]))
            accepted = max(0, m - 1)  # drafts the target agreed with
            req.update_speculation(proposed=proposed, accepted=accepted)
            for t in toks:
                self._emit_token(state, t)
            self._incr("spec_windows")
            self._incr("spec_proposed", proposed)
            self._incr("spec_accepted", accepted)
            self._incr("spec_emitted", len(toks))
            state.cached_len += len(toks)
            self._trim_blocks(state)
            if req.finished():
                self._finish(state)
        return True

    # ---------------------------------------------------------------- step
    def step(self) -> bool:
        """One scheduling iteration: expire, admit (join-mid-flight), plan
        speculation, grow/preempt, then decode — or verify, when any
        running request speculates. Returns True if any work happened."""
        self._expire()
        admitted = 0
        while self._admit():
            admitted += 1
        self._plan_speculation()
        self._grow()
        speculating = any(s.step_k > 0 for s in self._running.values())
        stepped = self._verify_once() if speculating else self._decode_once()
        return stepped or admitted > 0
