"""Block-structured KV cache: preallocated device storage + host-side
block accounting (port of ``flexflow_tpu/generation/cache.py``).

vLLM/PagedAttention (SOSP'23): the cache is ONE preallocated tensor per
K/V — ``[L, num_blocks, block_size, H, D]`` — and a sequence's cache is a
*block table* (list of block ids) into it. Appending a token writes one
``(block, offset)`` slot; nothing is ever moved or reallocated, so every
step sees the same cache shape however many sequences are live.

Block 0 is reserved as a **scratch block**: padded prompt positions and
inactive decode slots scatter their (meaningless) K/V there, so the
fixed-shape steps never need masked scatters to avoid corrupting live
sequences. The allocator never hands out block 0.

Unlike the JAX package, whose steps return new cache arrays, the port's
steps write K/V into :class:`KVCache`'s tensors IN PLACE.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import List, Optional, Union

import torch

from ..core.types import DataType


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    """Geometry of the block-structured cache.

    ``num_blocks`` INCLUDES the reserved scratch block 0, so the usable
    capacity is ``(num_blocks - 1) * block_size`` token positions.
    """

    num_layers: int
    num_heads: int
    head_dim: int
    num_blocks: int
    block_size: int = 16
    dtype: DataType = DataType.FLOAT

    def __post_init__(self):
        if self.num_blocks < 2:
            raise ValueError("num_blocks must be >= 2 (block 0 is scratch)")
        if self.block_size < 1:
            raise ValueError("block_size must be >= 1")

    @property
    def bytes_per_block(self) -> int:
        """K + V bytes one block occupies across all layers."""
        return (
            2
            * self.num_layers
            * self.block_size
            * self.num_heads
            * self.head_dim
            * self.dtype.size_bytes
        )

    @property
    def total_bytes(self) -> int:
        return self.num_blocks * self.bytes_per_block

    @property
    def usable_tokens(self) -> int:
        return (self.num_blocks - 1) * self.block_size

    def blocks_for(self, num_tokens: int) -> int:
        """Blocks needed to hold ``num_tokens`` cache positions."""
        return -(-max(0, num_tokens) // self.block_size)

    @classmethod
    def from_budget(
        cls,
        budget_bytes: int,
        num_layers: int,
        num_heads: int,
        head_dim: int,
        block_size: int = 16,
        dtype: DataType = DataType.FLOAT,
        kv_shards: int = 1,
    ) -> "CacheConfig":
        """Size the cache against a PER-DEVICE memory budget:

            num_blocks = budget * kv_shards
                         // (2 * L * block_size * H * D * dtype_bytes)

        ``kv_shards`` is the tensor-parallel degree the cache's heads
        shard over (each device then holds H / kv_shards heads of every
        block, so the same per-device budget buys kv_shards x the
        blocks). Raises when the heads do not divide across the shards,
        or when the budget cannot hold even scratch + one usable block.
        """
        from .sharding import validate_kv_shards

        validate_kv_shards(num_heads, kv_shards)
        per_block = 2 * num_layers * block_size * num_heads * head_dim * dtype.size_bytes
        num_blocks = budget_bytes * kv_shards // per_block
        if num_blocks < 2:
            raise ValueError(
                f"cache budget {budget_bytes}B x {kv_shards} shard(s) holds "
                f"{num_blocks} blocks of {per_block}B; need >= 2 "
                f"(scratch + one usable)"
            )
        return cls(
            num_layers=num_layers,
            num_heads=num_heads,
            head_dim=head_dim,
            num_blocks=int(num_blocks),
            block_size=block_size,
            dtype=dtype,
        )

    @classmethod
    def for_slots(
        cls,
        num_layers: int,
        num_heads: int,
        head_dim: int,
        max_seq_len: int,
        max_batch_slots: int,
        block_size: int = 16,
        dtype: DataType = DataType.FLOAT,
        expected_prefix_sharing: float = 0.0,
    ) -> "CacheConfig":
        """Worst-case slot sizing: every slot can reach ``max_seq_len``.
        ``expected_prefix_sharing`` in [0, 1) discounts the aggregate
        bound by the fraction of positions expected to be shared through
        a prefix cache, floored at one slot's full bound plus one block
        per remaining slot (the JAX package's sizing, kept so the two
        engines size identical caches)."""
        if not 0.0 <= expected_prefix_sharing < 1.0:
            raise ValueError(
                f"expected_prefix_sharing must be in [0, 1), got "
                f"{expected_prefix_sharing}"
            )
        per_seq = -(-max_seq_len // block_size)
        worst = per_seq * max_batch_slots
        discounted = int(-(-worst * (1.0 - expected_prefix_sharing) // 1))
        floor = per_seq + max(0, max_batch_slots - 1)
        return cls(
            num_layers=num_layers,
            num_heads=num_heads,
            head_dim=head_dim,
            num_blocks=1 + max(floor, discounted),
            block_size=block_size,
            dtype=dtype,
        )


class KVCache:
    """Device storage: ``k``/``v`` of shape [L, num_blocks, block_size,
    H, D]. The port's steps update these tensors in place."""

    def __init__(self, config: CacheConfig, k: torch.Tensor, v: torch.Tensor):
        self.config = config
        self.k = k
        self.v = v

    @classmethod
    def create(cls, config: CacheConfig,
               device: Optional[Union[str, torch.device]] = None,
               kv_shards: int = 1) -> "KVCache":
        """Zeroed storage on ``device``: the GPU unless the caller asks
        for the CPU (``core/device.py::resolve_device``). ``kv_shards``
        > 1 makes one rank's part of a tensor-parallel cache
        (``sharding.py``): ``H / kv_shards`` heads of every block."""
        from ..core.device import resolve_device
        from .sharding import validate_kv_shards

        validate_kv_shards(config.num_heads, kv_shards)
        device = resolve_device(device)
        shape = (
            config.num_layers,
            config.num_blocks,
            config.block_size,
            config.num_heads // kv_shards,
            config.head_dim,
        )
        return cls(
            config,
            torch.zeros(shape, dtype=config.dtype.torch, device=device),
            torch.zeros(shape, dtype=config.dtype.torch, device=device),
        )

    def reset(self) -> None:
        """Drop all cached K/V (rezeroing also clears any NaN a poisoned
        batch may have written)."""
        self.k.zero_()
        self.v.zero_()


class BlockAllocator:
    """Host-side free list over the cache's blocks. Thread-safe: the
    scheduler's admission path and a cancellation path may free
    concurrently. Block 0 (scratch) is never handed out.

    ``total_allocated`` / ``total_freed`` count blocks cumulatively,
    ``total_reset_reclaimed`` the blocks :meth:`reset` reclaimed wholesale
    (not counted in ``total_freed``: conservation is ``total_allocated ==
    total_freed + total_reset_reclaimed + outstanding``);
    ``low_water`` / ``high_water`` mark the free list's extremes."""

    def __init__(self, config: CacheConfig):
        self.config = config
        self._lock = threading.Lock()
        self._free: List[int] = list(range(config.num_blocks - 1, 0, -1))
        self.total_allocated = 0
        self.total_freed = 0
        self.total_reset_reclaimed = 0
        self.low_water = len(self._free)
        self.high_water = len(self._free)

    def reset(self) -> None:
        """Restore the full free list: every outstanding block table is
        invalidated wholesale."""
        with self._lock:
            self.total_reset_reclaimed += (self.config.num_blocks - 1) - len(self._free)
            self._free = list(range(self.config.num_blocks - 1, 0, -1))
            self.high_water = len(self._free)

    @property
    def num_free(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def num_total(self) -> int:
        return self.config.num_blocks - 1

    def can_allocate(self, n: int) -> bool:
        return self.num_free >= n

    def allocate(self, n: int) -> Optional[List[int]]:
        """Pop ``n`` blocks, or None (atomically — no partial grabs)."""
        if n < 0:
            raise ValueError(f"cannot allocate {n} blocks")
        with self._lock:
            if len(self._free) < n:
                return None
            taken, self._free = self._free[:n], self._free[n:]
            self.total_allocated += n
            if len(self._free) < self.low_water:
                self.low_water = len(self._free)
            return taken

    def free(self, blocks: List[int]) -> None:
        with self._lock:
            for b in blocks:
                if b == 0:
                    raise ValueError("block 0 is scratch; it is never allocated")
                if b in self._free:
                    raise ValueError(f"double free of block {b}")
                self._free.append(b)
            self.total_freed += len(blocks)
            if len(self._free) > self.high_water:
                self.high_water = len(self._free)


def slot_mapping(
    block_table: torch.Tensor, positions: torch.Tensor, block_size: int
) -> torch.Tensor:
    """Flat cache slot (block * block_size + offset) for each position.

    ``block_table``: [max_blocks] int32, or [B, max_blocks] with
    ``positions`` [B, ...] (the batched form the JAX package writes as a
    vmap). Positions past the table's coverage land in the scratch block
    (block 0) instead of indexing out of bounds — callers mask those
    positions out of attention anyway.
    """
    mb = block_table.shape[-1]
    block_idx = torch.div(positions, block_size, rounding_mode="floor")
    offset = positions - block_idx * block_size
    in_range = block_idx < mb
    clipped = block_idx.clamp(0, mb - 1).long()
    if block_table.dim() == 1:
        block = block_table[clipped]
    else:
        flat = clipped.reshape(clipped.shape[0], -1)
        block = torch.gather(block_table, 1, flat).reshape(clipped.shape)
    block = torch.where(in_range, block, torch.zeros_like(block))
    return block * block_size + torch.where(in_range, offset, torch.zeros_like(offset))
