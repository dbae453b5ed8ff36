"""Cross-request prefix caching: a radix index over token-block content
with refcounted copy-on-write blocks and a host-RAM offload tier (port
of ``flexflow_tpu/generation/prefix.py``; it imports nothing of the JAX
package and keeps its own copy of the module).

Most serving traffic shares long prompt prefixes (a chat system prompt,
a few-shot template, a RAG instruction block). The block cache
(cache.py) is made content-addressed — PagedAttention block sharing
(SOSP'23) and RadixAttention prefix trees (SGLang):

* **Radix index.** Full blocks of prompt (and, after preemption,
  prompt+generated) content are registered in a trie keyed by
  ``(parent entry, block's token tuple)`` — exact-match edges, so no
  hash collision can alias two prefixes onto one block's KV. Admission
  walks the trie over the new prompt's full blocks and reuses every
  matched block; the engine then prefills only the *suffix*.

* **Refcounted copy-on-write blocks.** A block the index holds is
  immutable and shared: live sequences hold refcounts, and sharing is at
  full-block granularity so the append path never writes into a shared
  block — except where a prompt's tokens are FULLY covered by cached
  blocks: its last position must still be recomputed (the first sampled
  token needs that position's logits), and that write lands inside the
  last matched block. That block is copied on the device first (an
  admission-time copy into a private block) and the copy is written.

* **Host-RAM offload tier.** Cold blocks (refcount 0, LRU by last
  touch) swap out to host buffers instead of being dropped — including
  a preempted sequence's blocks, so its re-admission can swap its KV
  back in instead of recomputing it. Swap-in or recompute is decided by
  the serving roofline (transfer bytes over the host link against the
  recompute's FLOPs and bytes over the device's peaks,
  ``obs/capacity.py``). Host buffers carry a CRC, so a corrupted
  swap-in is detected and falls back to recompute.

Exactness invariant: token streams are identical with caching on and
off — greedy, seeded temperature and speculative. Sampling keys are
indexed by generated-token count, so position is the only state that
matters, and reused blocks hold the K/V the prefill would have
recomputed.

Threading: all mutation happens on the scheduler's thread (admission,
preemption, reclaim); one lock guards the trie, and decode never takes
it (prefix work is admission-time only).
"""
from __future__ import annotations

import threading
import time
import zlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .cache import BlockAllocator, CacheConfig

# Host<->device link bandwidth estimate for the swap-vs-recompute
# decision (PCIe gen4 x16 order of magnitude; deliberately conservative
# — a wrong "swap" costs one transfer, a wrong "recompute" costs a full
# prefill). The decision is pure arithmetic on sizes, so it is
# deterministic run to run.
DEFAULT_HOST_LINK_BYTES_PER_S = 16e9
# per-swap fixed cost (dispatch + host sync)
SWAP_OVERHEAD_S = 20e-6


class PrefixEntry:
    """One cached block of prefix content: a radix-trie node.

    ``block`` is the device block id while resident; ``host`` (a
    :class:`PackedBlock`) holds the content while offloaded (exactly one
    tier is populated).
    ``refs`` counts live sequences whose block tables include this
    block; the index itself keeps the entry alive at refs == 0 until
    eviction. ``children`` counts child entries (any tier) — an entry
    with children is never dropped from the trie, or its descendants
    would become unreachable."""

    __slots__ = (
        "eid", "parent_eid", "tokens", "depth", "block",
        "host", "refs", "children", "last_touch",
    )

    def __init__(self, eid: int, parent_eid: int, tokens: Tuple[int, ...],
                 depth: int, block: int):
        self.eid = eid
        self.parent_eid = parent_eid
        self.tokens = tokens
        self.depth = depth  # block index within the prefix (0-based)
        self.block: Optional[int] = block
        self.host: Optional["PackedBlock"] = None
        self.refs = 0
        self.children = 0
        self.last_touch = 0.0

    @property
    def resident(self) -> bool:
        return self.block is not None


def _crc(k: np.ndarray, v: np.ndarray) -> int:
    return zlib.crc32(v.tobytes(), zlib.crc32(k.tobytes()))


class PackedBlock:
    """One KV block's content on the host: full-head ``[layers,
    block_size, heads, head_dim]`` K and V arrays and the CRC taken when
    they were packed, so a copy corrupted on the host is detected before
    it is written back to the device (the host tier's format)."""

    __slots__ = ("host_k", "host_v", "crc")

    def __init__(self, host_k: np.ndarray, host_v: np.ndarray):
        self.host_k = host_k
        self.host_v = host_v
        self.crc = _crc(host_k, host_v)

    def verify(self) -> bool:
        """True when the payload still matches its packing-time CRC."""
        return _crc(self.host_k, self.host_v) == self.crc


class PrefixCache:
    """Radix prefix index + host tier over one engine's block cache.

    Owns no device memory itself: resident entries hold block ids from
    the shared :class:`BlockAllocator` (an index-owned block is
    *outstanding* from the allocator's point of view until eviction
    frees it), and the engine performs all device reads and writes
    through its block programs (:meth:`reclaim` takes its reader).
    """

    ROOT = 0  # parent_eid of depth-0 entries

    def __init__(
        self,
        allocator: BlockAllocator,
        config: CacheConfig,
        *,
        enabled: bool = True,
        host_budget_bytes: Optional[int] = None,
        host_link_bytes_per_s: float = DEFAULT_HOST_LINK_BYTES_PER_S,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.allocator = allocator
        self.config = config
        self.enabled = enabled
        # default host tier: as large as the device cache — every
        # evicted block has somewhere to go until real pressure
        self.host_budget_bytes = (
            config.total_bytes if host_budget_bytes is None else host_budget_bytes
        )
        self.host_link_bytes_per_s = host_link_bytes_per_s
        self.swap_overhead_s = SWAP_OVERHEAD_S
        self.clock = clock
        self._lock = threading.Lock()
        self._eid = 0
        # (parent_eid, token tuple) -> entry; entries by id — guarded-by: _lock
        self._edges: Dict[Tuple[int, Tuple[int, ...]], PrefixEntry] = {}
        self._by_id: Dict[int, PrefixEntry] = {}
        # telemetry (admission-path writes; gauges read without the
        # lock — plain ints under the GIL, same idiom as CacheTelemetry)
        self.lookups = 0
        self.hits = 0
        self.tokens_reused_total = 0
        self.blocks_reused_total = 0
        self.cow_copies_total = 0
        self.swaps_in_total = 0
        self.swaps_out_total = 0
        self.swap_in_failures = 0
        self.recompute_fallbacks = 0
        self.registered_total = 0
        self.evicted_total = 0
        self.dropped_total = 0
        self.host_bytes = 0

    # ------------------------------------------------------------- queries
    @property
    def resident_blocks(self) -> int:
        with self._lock:
            return sum(1 for e in self._by_id.values() if e.resident)

    @property
    def offloaded_blocks(self) -> int:
        with self._lock:
            return sum(1 for e in self._by_id.values() if not e.resident)

    def hit_ratio(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0

    def match(self, prompt: Sequence[int]) -> List[PrefixEntry]:
        """The longest cached run of full blocks along ``prompt``
        (resident and offloaded entries mixed), touched for LRU. Walks
        at most the blocks whose reuse could cover position
        ``len(prompt) - 2`` — the last position is ALWAYS recomputed so
        its logits exist to sample the first generated token from."""
        if not self.enabled or len(prompt) < 2:
            return []
        bs = self.config.block_size
        max_entries = (len(prompt) - 2) // bs + 1
        run: List[PrefixEntry] = []
        now = self.clock()
        with self._lock:
            parent = self.ROOT
            for j in range(max_entries):
                tok = tuple(prompt[j * bs:(j + 1) * bs])
                if len(tok) < bs:
                    break
                entry = self._edges.get((parent, tok))
                if entry is None:
                    break
                entry.last_touch = now
                run.append(entry)
                parent = entry.eid
        return run

    def probe(self, prompt: Sequence[int]) -> int:
        """Read-only matched-token count (fleet router affinity): how
        many of ``prompt``'s leading tokens are covered by cached
        blocks, capped at ``len(prompt) - 1``. No LRU touch, no
        counters — a routing probe must not look like traffic."""
        if not self.enabled or len(prompt) < 2:
            return 0
        bs = self.config.block_size
        matched = 0
        with self._lock:
            parent = self.ROOT
            for j in range((len(prompt) - 2) // bs + 1):
                tok = tuple(prompt[j * bs:(j + 1) * bs])
                if len(tok) < bs:
                    break
                entry = self._edges.get((parent, tok))
                if entry is None:
                    break
                matched += bs
                parent = entry.eid
        return min(matched, len(prompt) - 1)

    # ------------------------------------------------------------ refcounts
    def acquire(self, entries: Sequence[PrefixEntry]) -> None:
        now = self.clock()
        with self._lock:
            for e in entries:
                e.refs += 1
                e.last_touch = now

    def release(self, entries: Sequence[PrefixEntry]) -> None:
        """Drop one reference per entry. Tolerates entries invalidated
        by a wholesale :meth:`reset` — a stale decref
        must not corrupt the fresh index."""
        with self._lock:
            for e in entries:
                if self._by_id.get(e.eid) is e and e.refs > 0:
                    e.refs -= 1

    # ----------------------------------------------------------- registration
    def register_chain(
        self,
        tokens: Sequence[int],
        blocks: Sequence[int],
        shared_idx: set,
        entries: List[PrefixEntry],
        upto_tokens: int,
    ) -> int:
        """Register ``tokens``' full blocks below ``upto_tokens`` into
        the trie, transferring ownership of the newly registered blocks
        from the sequence to the index (the sequence keeps a ref).

        ``blocks``/``shared_idx``/``entries`` are the owning sequence's
        block table, its set of already-index-owned table positions, and
        its held entries — updated in place. Existing entries are left
        alone (the sequence's own copy of that content stays private),
        except an offloaded entry holding the same content, which
        adopts the sequence's resident block (free device promotion:
        the host copy is dropped). Returns the number of entries
        registered or promoted."""
        if not self.enabled:
            return 0
        bs = self.config.block_size
        n_new = 0
        now = self.clock()
        with self._lock:
            parent = self.ROOT
            for j in range(upto_tokens // bs):
                tok = tuple(tokens[j * bs:(j + 1) * bs])
                if len(tok) < bs:
                    break
                entry = self._edges.get((parent, tok))
                if entry is None:
                    if j in shared_idx:
                        # chain broken upstream of a block we believed
                        # shared (reset raced us): stop registering
                        break
                    self._eid += 1
                    entry = PrefixEntry(self._eid, parent, tok, j, blocks[j])
                    self._edges[(parent, tok)] = entry
                    self._by_id[entry.eid] = entry
                    if parent != self.ROOT:
                        self._by_id[parent].children += 1
                    entry.refs += 1
                    entry.last_touch = now
                    shared_idx.add(j)
                    entries.append(entry)
                    self.registered_total += 1
                    n_new += 1
                elif j not in shared_idx and not entry.resident:
                    # promote: the index already knows this content but
                    # only on the host tier; adopt our resident block
                    self._drop_host(entry)
                    entry.block = blocks[j]
                    entry.refs += 1
                    entry.last_touch = now
                    shared_idx.add(j)
                    entries.append(entry)
                    n_new += 1
                entry.last_touch = now
                parent = entry.eid
        return n_new

    # ------------------------------------------------------------- eviction
    def _drop_host(self, entry: PrefixEntry) -> None:
        if entry.host is not None:
            self.host_bytes -= self.config.bytes_per_block
        entry.host = None

    def _remove(self, entry: PrefixEntry) -> None:
        """Drop ``entry`` from the trie entirely. Caller holds _lock
        (reclaim and _enforce_host_budget both invoke this inside their
        ``with self._lock:`` blocks)."""
        self._drop_host(entry)
        del self._edges[(entry.parent_eid, entry.tokens)]  # flexlint: disable=lock-discipline — caller holds _lock (see docstring)
        del self._by_id[entry.eid]
        parent = self._by_id.get(entry.parent_eid)
        if parent is not None:
            parent.children -= 1
        self.dropped_total += 1

    def reclaim(
        self,
        n_blocks: int,
        read_block: Optional[Callable[[int], Tuple[np.ndarray, np.ndarray]]] = None,
    ) -> int:
        """Free up to ``n_blocks`` device blocks by evicting refcount-0
        resident entries, LRU by last touch. Each eviction offloads the
        block's content to the host tier when ``read_block`` is given
        and the host budget allows (the caller wraps the device read
        with the ``generation.kv_offload`` fault site and may raise to
        simulate a failed swap-out — the entry is then dropped instead,
        which is always safe: a dropped block is just a future
        recompute). Returns blocks actually freed."""
        if not self.enabled:
            return 0
        freed = 0
        while freed < n_blocks:
            with self._lock:
                cands = [
                    e for e in self._by_id.values() if e.resident and e.refs == 0
                ]
                if not cands:
                    break
                victim = min(cands, key=lambda e: (e.last_touch, -e.depth))
                # an orphan (its parent already dropped from the trie)
                # can never be reached by match() again: drop it free
                # instead of paying a device read + host budget for
                # permanently dead content
                reachable = (
                    victim.parent_eid == self.ROOT
                    or victim.parent_eid in self._by_id
                )
            offloaded = False
            if (
                reachable
                and read_block is not None
                and self.host_bytes + self.config.bytes_per_block
                <= self.host_budget_bytes
            ):
                try:
                    hk, hv = read_block(victim.block)
                    with self._lock:
                        victim.host = PackedBlock(np.asarray(hk), np.asarray(hv))
                        self.host_bytes += self.config.bytes_per_block
                        self.swaps_out_total += 1
                    offloaded = True
                except Exception:
                    offloaded = False  # failed swap-out: drop instead
            with self._lock:
                block, victim.block = victim.block, None
                if not offloaded:
                    # dropped: no tier holds the content, so the node
                    # leaves the trie. Descendants are orphaned (the
                    # match walk can no longer reach them) but stay
                    # evictable — reclaim scans all entries, so their
                    # blocks still come back under pressure and their
                    # own removal tolerates the missing parent.
                    self._remove(victim)
                self.evicted_total += 1
            self.allocator.free([block])
            freed += 1
        self._enforce_host_budget()
        return freed

    def _enforce_host_budget(self) -> None:
        """Drop LRU offloaded leaves until the host tier fits its
        budget. Internal offloaded entries (with children) are kept —
        dropping them would strand reachable descendants; the overshoot
        is bounded by the trie's internal-node count and drains as
        children age out."""
        while True:
            with self._lock:
                if self.host_bytes <= self.host_budget_bytes:
                    return
                leaves = [
                    e for e in self._by_id.values()
                    if not e.resident and e.children == 0 and e.refs == 0
                    and e.host is not None
                ]
                if not leaves:
                    return
                victim = min(leaves, key=lambda e: e.last_touch)
                self._remove(victim)

    # --------------------------------------------------------------- tiers
    def take_host_copy(
        self, entry: PrefixEntry
    ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """The entry's host buffers, CRC-verified. None (and the entry
        dropped from the trie entirely) when the content is corrupt —
        the caller falls back to recompute. Removal, not just a host
        drop: a tier-less node would still count as ``offloaded`` and
        break the host-bytes conservation invariant on the next scrape
        (a held ref is safe — release() ignores removed entries)."""
        with self._lock:
            packed = entry.host
        if packed is None:
            return None
        if not packed.verify():
            with self._lock:
                if self._by_id.get(entry.eid) is entry:
                    self._remove(entry)
                else:
                    self._drop_host(entry)
            return None
        return packed.host_k, packed.host_v

    def note_swapped_in(self, entry: PrefixEntry, block: int) -> None:
        """The entry's content was written into device ``block``: it is
        resident again; the host copy is retained only if budget is
        slack (re-offload is then free) — dropped here for simplicity
        and budget honesty."""
        with self._lock:
            self._drop_host(entry)
            entry.block = block
            entry.last_touch = self.clock()
            self.swaps_in_total += 1

    # ------------------------------------------------------ decision model
    def swap_in_cost_s(self, n_blocks: int) -> float:
        bytes_total = n_blocks * self.config.bytes_per_block
        return self.swap_overhead_s + bytes_total / self.host_link_bytes_per_s

    # ------------------------------------------------------------ lifecycle
    def reset(self) -> None:
        """Wholesale invalidation after an engine reset: the
        allocator's free list was restored and the device cache
        rezeroed, so every entry — resident ids AND host copies (their
        provenance is the dead cache) — is dropped without per-block
        frees. Later admissions match against an empty index, which is
        trivially correct (recompute)."""
        with self._lock:
            self._edges.clear()
            self._by_id.clear()
            self.host_bytes = 0

    # -------------------------------------------------------------- report
    def snapshot(self) -> Dict:
        with self._lock:
            resident = sum(1 for e in self._by_id.values() if e.resident)
            offloaded = len(self._by_id) - resident
            shared = sum(1 for e in self._by_id.values() if e.refs > 0)
        return {
            "enabled": self.enabled,
            "resident_blocks": resident,
            "offloaded_blocks": offloaded,
            "shared_blocks": shared,  # resident entries referenced by >=1 stream
            "host_bytes": self.host_bytes,
            "host_budget_bytes": self.host_budget_bytes,
            "lookups": self.lookups,
            "hits": self.hits,
            "hit_ratio": self.hit_ratio(),
            "tokens_reused_total": self.tokens_reused_total,
            "blocks_reused_total": self.blocks_reused_total,
            "cow_copies_total": self.cow_copies_total,
            "swaps_in_total": self.swaps_in_total,
            "swaps_out_total": self.swaps_out_total,
            "swap_in_failures": self.swap_in_failures,
            "recompute_fallbacks": self.recompute_fallbacks,
            "registered_total": self.registered_total,
            "evicted_total": self.evicted_total,
        }

    def tier_residency(self) -> List[Dict]:
        """Per-entry tier table for ``obsreport cache`` (bounded: the
        trie never exceeds the allocator's block count plus the host
        budget's block count)."""
        with self._lock:
            return [
                {
                    "depth": e.depth,
                    "tier": "device" if e.resident else "host",
                    "block": e.block,
                    "refs": e.refs,
                    "last_touch": e.last_touch,
                }
                for e in sorted(
                    self._by_id.values(), key=lambda e: (e.depth, e.eid)
                )
            ]
