"""Continuous batching: iteration-level scheduling of generation
requests (Orca, OSDI'22) over the block KV cache (port of the core of
``flexflow_tpu/generation/scheduler.py``).

Every ``step()`` runs ONE decode across the engine's fixed batch slots,
and between steps the batch recomposes freely —

* **join-mid-flight**: a queued request is admitted (FCFS) the moment a
  slot AND enough cache blocks are free; it prefills and decodes
  alongside sequences that are hundreds of tokens in;
* **free-on-finish**: a sequence hitting EOS / max-tokens / its deadline
  releases its blocks in the same step;
* **preempt-by-recompute**: if the cache cannot grow a running sequence,
  the youngest running sequence is evicted — blocks freed, prompt +
  generated-so-far re-queued at the FRONT — and later re-prefilled
  (vLLM's recompute preemption). Sampling noise is indexed by
  generated-token count, so a preempted request's token stream
  continues exactly where it left off.

The queue is bounded (:class:`QueueFullError`) and requests carry
deadlines (:class:`DeadlineExceededError` before OR during generation),
on an injectable clock so tests run on virtual time. The scheduler is
synchronous: ``step()`` does one iteration and returns.
"""
from __future__ import annotations

import itertools
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from ..serving.resilience import DeadlineExceededError, QueueFullError, ShuttingDownError
from .engine import GenerationEngine, SamplingParams

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
    request's sampling noise stream."""

    def __init__(
        self,
        prompt: List[int],
        sampling: SamplingParams,
        deadline: Optional[float] = None,
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

    @property
    def n_generated(self) -> int:
        return len(self.generated)

    def finished(self) -> bool:
        if self.n_generated >= self.max_new:
            return True
        eos = self.sampling.eos_id
        return eos is not None and bool(self.generated) and self.generated[-1] == eos


class _Running:
    """Slot-resident state for an admitted request."""

    __slots__ = ("req", "slot", "blocks", "cached_len", "admitted_seq")

    def __init__(self, req: Request, slot: int, blocks: List[int], cached_len: int,
                 admitted_seq: int):
        self.req = req
        self.slot = slot
        self.blocks = blocks
        self.cached_len = cached_len  # cache positions written so far
        self.admitted_seq = admitted_seq  # admission order, for LIFO preemption


class ContinuousBatchingScheduler:
    def __init__(
        self,
        engine: GenerationEngine,
        *,
        max_queue: int = 256,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.engine = engine
        self.max_queue = max_queue
        self.clock = clock
        self._queue: deque = deque()
        self._running: Dict[int, _Running] = {}  # slot -> state
        self._free_slots = list(range(engine.max_batch_slots - 1, -1, -1))
        self._lock = threading.Lock()
        self._admitted_seq = itertools.count()
        self.preemptions = 0
        # admitted / completed / expired / cancelled / rejected / failed
        self.counts: Dict[str, int] = {}

    def _incr(self, name: str, n: int = 1) -> None:
        self.counts[name] = self.counts.get(name, 0) + n

    # ------------------------------------------------------------- submit
    def submit(
        self,
        prompt: Sequence[int],
        sampling: Optional[SamplingParams] = None,
        deadline_s: Optional[float] = None,
    ) -> GenerationHandle:
        """Enqueue one request (FCFS). Raises QueueFullError when the
        bounded queue is full, DeadlineExceededError for an
        already-expired budget, and ValueError for a prompt that can
        never be served."""
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
            req = Request(list(prompt), sampling, deadline=deadline)
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

    # ---------------------------------------------------------- internals
    def _release(self, state: _Running) -> None:
        self.engine.allocator.free(state.blocks)
        state.blocks = []
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
        """Evict ``state`` for recompute: free its blocks, fold its
        generated tokens into the prompt, and requeue it at the FRONT."""
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
        """FCFS, cache-capacity-aware admission. Returns True if the
        queue's head was admitted (prefilled) or failed."""
        with self._lock:
            if not self._queue or not self._free_slots:
                return False
            req = self._queue[0]
        need = self.engine.cache_config.blocks_for(len(req.prompt) + 1)
        blocks = self.engine.allocator.allocate(need)
        if blocks is None:
            return False
        with self._lock:
            self._queue.popleft()
            slot = self._free_slots.pop()
        try:
            token = self.engine.prefill_one(
                req.prompt, blocks, req.sampling, sample_index=req.n_generated
            )
        except Exception as e:  # the one request fails; the batch goes on
            self.engine.allocator.free(blocks)
            self._free_slots.append(slot)
            if req.handle._fail(e):
                self._incr("failed")
            return True
        state = _Running(
            req, slot, blocks, cached_len=len(req.prompt),
            admitted_seq=next(self._admitted_seq),
        )
        self._running[slot] = state
        self._emit_token(state, token)
        if req.finished():
            self._finish(state)
        return True

    def _emit_token(self, state: _Running, token: int) -> None:
        state.req.generated.append(int(token))
        state.req.handle._emit(int(token))

    def _grow(self) -> None:
        """Ensure every running sequence has cache blocks for its next
        token; under pressure, preempt-by-recompute."""
        for state in list(self._running.values()):
            if self._running.get(state.slot) is not state:
                continue  # preempted earlier in this sweep
            while True:
                need = self.engine.cache_config.blocks_for(state.cached_len + 1)
                if len(state.blocks) >= need:
                    break
                got = self.engine.allocator.allocate(1)
                if got is not None:
                    state.blocks.extend(got)
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

    # ---------------------------------------------------------------- step
    def step(self) -> bool:
        """One scheduling iteration: expire, admit (join-mid-flight),
        grow/preempt, then decode. Returns True if any work happened."""
        self._expire()
        admitted = 0
        while self._admit():
            admitted += 1
        self._grow()
        return self._decode_once() or admitted > 0
