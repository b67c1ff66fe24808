"""Refcounted physical-block pool — the host-side allocator of the paged KV
cache (``repro.runtime.kvcache.pool``, ported as it is: host-side numpy).

Device storage (``models.transformer.make_pool``) is a flat array of
``num_blocks`` fixed-size blocks per layer; this class owns which of those
physical ids are free, and how many holders reference each allocated one
(active requests via their page tables, plus the radix prefix cache for
registered blocks).  A block returns to the free list when its last
reference drops — there is no separate "free" walk, release IS deallocation.

Block 0 is reserved as the null/scratch block: page-table entries of retired
slots and out-of-range positions point at it, so device-side writes for
inactive rows land somewhere harmless without any masking in the step
function.  It is pinned with a permanent reference.
"""
from __future__ import annotations

from collections.abc import Iterable

import numpy as np


class BlockPool:
    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError(f"pool needs >= 2 blocks (1 reserved), got {num_blocks}")
        self.num_blocks = num_blocks
        # LIFO free list: recently released blocks are re-used first (their
        # pool rows are more likely still warm in cache)
        self._free: list[int] = list(range(num_blocks - 1, 0, -1))
        self._ref = np.zeros(num_blocks, np.int32)
        self._ref[0] = 1                         # pin the null block
        self.peak_used = 0                       # allocation high-water mark

    # ------------------------------------------------------------ accounting
    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        """Allocated blocks, excluding the pinned null block."""
        return self.num_blocks - 1 - len(self._free)

    @property
    def utilization(self) -> float:
        return self.used_blocks / max(self.num_blocks - 1, 1)

    def refcount(self, block_id: int) -> int:
        return int(self._ref[block_id])

    # ------------------------------------------------------------ operations
    def alloc(self, n: int) -> list[int] | None:
        """Take ``n`` free blocks (each with refcount 1), or None if the pool
        cannot satisfy the request — the caller decides whether to evict
        cached blocks or keep the request queued.  All-or-nothing."""
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        self._ref[out] = 1
        self.peak_used = max(self.peak_used, self.used_blocks)
        return out

    def acquire(self, block_id: int) -> None:
        """Add a reference to an allocated block (prefix sharing: a new
        request's page table, or the radix cache registering it)."""
        if block_id <= 0 or self._ref[block_id] < 1:
            raise ValueError(f"acquire of unallocated block {block_id}")
        self._ref[block_id] += 1

    def release(self, block_id: int) -> bool:
        """Drop one reference; frees the block (returns True) on the last."""
        if block_id <= 0 or self._ref[block_id] < 1:
            raise ValueError(f"release of unallocated block {block_id}")
        self._ref[block_id] -= 1
        if self._ref[block_id] == 0:
            self._free.append(block_id)
            return True
        return False

    # ------------------------------------------------------------- invariants
    def check(self, page_tables: Iterable[Iterable[int]] = (),
              radix_holders: Iterable[int] = ()) -> None:
        """Cross-check the pool's accounting against its live holders.

        ``page_tables``: one block-id sequence per resident request (its
        owned blocks, shared + private).  ``radix_holders``: the block ids
        the radix prefix cache currently references (one per node).  Raises
        ``RuntimeError`` on the first violated invariant:

          * the null block stays pinned and never enters the free list;
          * the free list holds no duplicates and no referenced block
            (free list ∩ allocated = ∅);
          * every block's refcount equals its live holder count — nothing
            leaks (refs without holders) and nothing dangles (holders of
            freed blocks).
        """
        if self._ref[0] < 1:
            raise RuntimeError("null block 0 lost its pin")
        free = list(self._free)
        if len(free) != len(set(free)):
            raise RuntimeError(f"free list holds duplicates: {sorted(free)}")
        if 0 in free:
            raise RuntimeError("null block 0 entered the free list")
        for bid in free:
            if self._ref[bid] != 0:
                raise RuntimeError(
                    f"block {bid} is free but still has refcount "
                    f"{int(self._ref[bid])}")
        holders = np.zeros(self.num_blocks, np.int64)
        for row in page_tables:
            for bid in row:
                if bid != 0:
                    holders[bid] += 1
        for bid in radix_holders:
            holders[bid] += 1
        for bid in range(1, self.num_blocks):
            if holders[bid] != self._ref[bid]:
                raise RuntimeError(
                    f"block {bid}: refcount {int(self._ref[bid])} != "
                    f"{int(holders[bid])} live holders "
                    f"({'leaked' if self._ref[bid] > holders[bid] else 'dangling'})")
