"""Host-side block-space manager for the paged KV pool — the port's copy of
``nxdi_tpu/runtime/block_manager.py`` (numpy only).

Allocates fixed-size blocks per sequence, hands out padded block tables,
derives slot mappings, and reference-counts shared prefix blocks for the
prefix cache. The JAX package's fault-injection failpoint and its telemetry
gauges belong to the host plane, which is not ported yet.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np


class BlockSpaceManager:
    """First-fit block allocator with refcounts (prefix blocks can be shared).

    A ``reclaimer`` (the serving prefix cache) may hold blocks that no
    sequence references: those stay out of ``_free`` but are released on
    demand, so ``num_free_blocks`` — the admission/watermark arithmetic —
    reports free + reclaimable and an exhausted pool asks the reclaimer to
    evict before failing an allocation.
    """

    def __init__(self, num_blocks: int, block_size: int):
        self.num_blocks = num_blocks
        self.block_size = block_size
        self._free = deque(range(num_blocks))
        self._tables: Dict[int, List[int]] = {}
        self._refs = np.zeros(num_blocks, dtype=np.int64)
        #: optional prefix cache: must expose ``reclaimable() -> int`` and
        #: ``evict(n) -> int`` (release >= min(n, reclaimable) blocks into
        #: the pool via release_block)
        self.reclaimer = None

    # ------------------------------------------------------------------
    def num_free_blocks(self) -> int:
        """Allocatable blocks: the free list plus whatever the reclaimer
        (prefix cache) could evict on demand."""
        n = len(self._free)
        if self.reclaimer is not None:
            n += self.reclaimer.reclaimable()
        return n

    def refcount(self, blk: int) -> int:
        return int(self._refs[blk])

    def blocks_needed(self, seq_id: int, num_tokens: int) -> int:
        """NEW blocks ``ensure_capacity(seq_id, num_tokens)`` would have to
        allocate beyond what the sequence already holds."""
        have = len(self._tables.get(seq_id, ()))
        return max(0, -(-num_tokens // self.block_size) - have)

    def ensure_capacity(self, seq_id: int, num_tokens: int) -> List[int]:
        """Grow seq_id's table to cover ``num_tokens`` positions; returns the
        table. Raises if the pool is exhausted (caller preempts/evicts)."""
        table = self._tables.setdefault(seq_id, [])
        needed = -(-num_tokens // self.block_size)
        while len(table) < needed:
            table.append(self._alloc_block())
        return table

    def _alloc_block(self) -> int:
        """Pop one free block (refcount 1), evicting from the reclaimer
        first when the free list is dry. Raises on a truly exhausted pool."""
        if not self._free and self.reclaimer is not None:
            self.reclaimer.evict(1)
        if not self._free:
            raise RuntimeError(
                f"KV block pool exhausted ({self.num_blocks} blocks); "
                f"free a sequence or raise pa_num_blocks"
            )
        blk = self._free.popleft()
        self._refs[blk] += 1
        return blk

    def fork_prefix(
        self, seq_id: int, prefix_table: Sequence[int], resurrect: bool = False
    ) -> None:
        """Start seq_id with shared (refcounted) prefix blocks.

        Blocks with refcount 0 sit in the free list; incrementing them
        without removal would let the allocator hand the same block to
        another sequence. Such a fork is rejected unless ``resurrect=True``,
        which pulls the block back out of ``_free``."""
        if seq_id in self._tables:
            raise ValueError(f"seq {seq_id} already allocated")
        dead = [blk for blk in prefix_table if self._refs[blk] == 0]
        if dead and not resurrect:
            raise ValueError(
                f"fork_prefix({seq_id}): blocks {dead} have refcount 0 (they "
                "are in the free pool and would be double-allocated); hold a "
                "reference before forking or pass resurrect=True"
            )
        for blk in dead:
            self._free.remove(blk)
        for blk in prefix_table:
            self._refs[blk] += 1
        self._tables[seq_id] = list(prefix_table)

    def free_seq(self, seq_id: int) -> None:
        for blk in self._tables.pop(seq_id, []):
            self._refs[blk] -= 1
            if self._refs[blk] == 0:
                self._free.append(blk)

    # -- cache retention / copy-on-write -------------------------------
    def retain_block(self, blk: int) -> None:
        """Take one table-less reference (the prefix cache's own hold) on a
        LIVE block."""
        if self._refs[blk] == 0:
            raise ValueError(
                f"retain_block({blk}): block is free; retain must happen "
                "while the owning sequence still holds it"
            )
        self._refs[blk] += 1

    def release_block(self, blk: int) -> None:
        """Drop one table-less reference; the block rejoins the free pool
        when nobody else holds it (prefix-cache eviction path)."""
        if self._refs[blk] <= 0:
            raise ValueError(f"release_block({blk}): block is not held")
        self._refs[blk] -= 1
        if self._refs[blk] == 0:
            self._free.append(blk)

    def cow_block(self, seq_id: int, block_idx: int) -> tuple:
        """Copy-on-write: give ``seq_id`` a PRIVATE copy of the shared block
        at table index ``block_idx`` before it writes there. Returns
        ``(src_blk, dst_blk)`` for the device-side copy
        (``kvcache.kv_cache.copy_kv_blocks``)."""
        table = self._tables[seq_id]
        src = table[block_idx]
        if self._refs[src] <= 1:
            raise ValueError(
                f"cow_block({seq_id}, {block_idx}): block {src} is not "
                "shared (refcount <= 1); write in place instead"
            )
        dst = self._alloc_block()
        table[block_idx] = dst
        self._refs[src] -= 1
        return src, dst

    # ------------------------------------------------------------------
    def block_table(self, seq_id: int, width: Optional[int] = None) -> np.ndarray:
        """Padded (-1) int32 table row for the model."""
        table = self._tables.get(seq_id, [])
        width = width if width is not None else len(table)
        out = np.full((width,), -1, dtype=np.int32)
        out[: len(table)] = table[:width]
        return out

    def slot_mapping(self, seq_id: int, positions: np.ndarray) -> np.ndarray:
        """Flat slot per position: table[p // bs] * bs + p % bs (unallocated
        positions map to -1 = dropped write)."""
        table = self._tables.get(seq_id, [])
        positions = np.asarray(positions)
        blk_idx = positions // self.block_size
        out = np.full(positions.shape, -1, dtype=np.int32)
        valid = (positions >= 0) & (blk_idx < len(table))
        if len(table):
            tbl = np.asarray(table, dtype=np.int32)
            out[valid] = (
                tbl[blk_idx[valid]] * self.block_size + positions[valid] % self.block_size
            )
        return out
