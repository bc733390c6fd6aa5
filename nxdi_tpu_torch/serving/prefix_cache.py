"""Radix prefix cache: cross-request KV block sharing for the paged layout —
the port's copy of ``nxdi_tpu/serving/prefix_cache.py``.

The paged :class:`~nxdi_tpu_torch.runtime.block_manager.BlockSpaceManager`
refcounts shared prefix blocks (``fork_prefix``) and the paged attention
paths consume arbitrary block tables; this module decides what is shared,
so a prompt prefix common to many requests is prefilled and stored once:

- a **radix tree over token ids at block granularity**: each node is one
  full block's token tuple mapping to the physical block holding its KV.
  A path from the root spells a block-aligned prompt prefix.
- the cache holds its **own reference** on every cached block
  (``retain_block``), so retired requests' blocks survive ``free_seq``.
- **LRU eviction feeds the free pool on demand**: blocks nobody but the
  cache references are *reclaimable* — ``BlockSpaceManager.num_free_blocks``
  counts them as free (admission/watermark arithmetic sees free +
  reclaimable) and an exhausted allocation evicts least-recently-used
  unreferenced leaves before failing. Eviction is leaf-first: a child's
  chain is only matchable through its parent, so interior nodes fall only
  after their subtree (reference monotonicity — a live request holding a
  child block necessarily holds every ancestor — makes every ref-1 node's
  whole subtree ref-1, so ``reclaimable() == count(refcount == 1)``).

Wiring (scheduler/engine):

- at admission the scheduler longest-prefix-matches the request's token
  sequence, hands it the shared chain via ``fork_prefix``, and starts
  ``num_prefilled`` at the cached token count — the engine then prefills
  ONLY the uncached tail (chunked prefill just sees a shorter prompt). The
  match is capped at ``len(seq) - 1`` tokens: the tail must keep at least
  one token so the (re)prefill still produces the next-token logits.
- on retirement and preemption-free the scheduler inserts the sequence's
  full blocks into the tree *before* ``free_seq`` drops the table.
- writes into a *shared* block (refcount > 1) are copy-on-write:
  ``BlockSpaceManager.cow_block`` swaps in a private copy and
  ``kvcache.kv_cache.copy_kv_blocks`` moves the data on device. Full-block
  cache hits never need this (the tail starts block-aligned); ``n > 1``
  continuation forks — which share the parent's partial last prompt block
  — are where COW earns its keep.

The JAX package's telemetry counters (hits, misses, evictions, COW copies,
cached blocks, tokens saved) are kept here as plain attributes only: the
metrics registry belongs to the host plane, which is not ported yet.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["PrefixCache"]


class _Node:
    """One full block of the radix tree: ``key`` is the block's token tuple,
    ``block`` the physical block id whose KV holds those tokens."""

    __slots__ = ("key", "block", "children", "parent", "last_used")

    def __init__(self, key: Tuple[int, ...], block: int, parent: "_Node"):
        self.key = key
        self.block = block
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.last_used = 0


class PrefixCache:
    """Radix tree of retained KV block chains over a BlockSpaceManager."""

    def __init__(self, block_manager):
        self.mgr = block_manager
        self.block_size = block_manager.block_size
        self._root = _Node((), -1, None)  # sentinel; holds no block
        self._nodes: Dict[int, _Node] = {}  # physical block -> node
        self._tick = 0
        self.hits_n = 0
        self.misses_n = 0
        self.evictions_n = 0
        self.cow_copies_n = 0
        self.tokens_saved_n = 0
        # the manager asks the cache to evict when its free list runs dry,
        # and counts reclaimable blocks as free (watermark arithmetic)
        block_manager.reclaimer = self

    # -- views --------------------------------------------------------------
    def __len__(self) -> int:
        return len(self._nodes)

    def blocks(self) -> set:
        """The physical blocks the cache currently retains (test surface)."""
        return set(self._nodes)

    @property
    def hit_rate_pct(self) -> float:
        total = self.hits_n + self.misses_n
        return 100.0 * self.hits_n / total if total else 0.0

    def reclaimable(self) -> int:
        """Cached blocks no live sequence references (manager refcount 1 =
        the cache's own hold) — evictable on demand, so they count as free
        for admission/watermark arithmetic. Reference monotonicity down
        every chain makes this exactly the evictable set."""
        if not self._nodes:
            return 0
        blks = np.fromiter(self._nodes.keys(), dtype=np.int64, count=len(self._nodes))
        return int(np.count_nonzero(self.mgr._refs[blks] == 1))

    # -- match / insert / evict ---------------------------------------------
    def peek(self, tokens: Sequence[int], max_tokens: Optional[int] = None) -> int:
        """Token count the longest cached full-block prefix of ``tokens``
        would cover — WITHOUT touching LRU ticks or hit/miss stats. The
        scheduler's cache-aware admission scan probes every waiting request
        each step; only the request actually placed should move the cache's
        observable state (its ``match`` at fork time does)."""
        bs = self.block_size
        limit = len(tokens) if max_tokens is None else min(max_tokens, len(tokens))
        node = self._root
        depth = 0
        for i in range(limit // bs):
            child = node.children.get(
                tuple(int(t) for t in tokens[i * bs : (i + 1) * bs])
            )
            if child is None:
                break
            depth += 1
            node = child
        return depth * bs

    def match(
        self, tokens: Sequence[int], max_tokens: Optional[int] = None
    ) -> Tuple[List[int], int]:
        """Longest cached full-block prefix of ``tokens``: the shared block
        chain and the token count it covers. ``max_tokens`` caps the match
        (admission passes ``len(seq) - 1`` so the uncached tail keeps the
        token whose logits sample the next one). Touches matched nodes for
        LRU and counts the hit/miss."""
        bs = self.block_size
        limit = len(tokens) if max_tokens is None else min(max_tokens, len(tokens))
        max_blocks = limit // bs
        self._tick += 1
        node = self._root
        chain: List[int] = []
        for i in range(max_blocks):
            key = tuple(int(t) for t in tokens[i * bs : (i + 1) * bs])
            child = node.children.get(key)
            if child is None:
                break
            child.last_used = self._tick
            chain.append(child.block)
            node = child
        if chain:
            self.hits_n += 1
            self.tokens_saved_n += len(chain) * bs
        else:
            self.misses_n += 1
        return chain, len(chain) * bs

    def insert(self, tokens: Sequence[int], table: Sequence[int]) -> int:
        """Adopt the full blocks of ``tokens`` (KV resident in ``table``)
        into the tree, retaining each newly adopted block. Blocks whose
        token path already exists are NOT replaced — the existing chain
        keeps serving and the caller's duplicate block is simply freed by
        its own ``free_seq``. Must run while the owning sequence still
        holds its table (before ``free_seq``). Returns blocks adopted."""
        bs = self.block_size
        n_blocks = min(len(tokens) // bs, len(table))
        self._tick += 1
        node = self._root
        adopted = 0
        for i in range(n_blocks):
            key = tuple(int(t) for t in tokens[i * bs : (i + 1) * bs])
            child = node.children.get(key)
            if child is None:
                blk = int(table[i])
                if blk in self._nodes:
                    # this physical block already backs a different path
                    # (cannot happen through normal fork/alloc flows; guard
                    # so a buggy caller cannot corrupt the tree<->pool map)
                    break
                self.mgr.retain_block(blk)
                child = _Node(key, blk, node)
                node.children[key] = child
                self._nodes[blk] = child
                adopted += 1
            child.last_used = self._tick
            node = child
        return adopted

    def evict(self, n: int) -> int:
        """Release up to ``n`` least-recently-used UNREFERENCED blocks back
        to the pool (manager refcount 1 — only the cache holds them), leaf
        first so every surviving node's chain stays matchable. Returns the
        number actually released."""
        released = 0
        refs = self.mgr._refs
        while released < n:
            victim = None
            for node in self._nodes.values():
                if node.children or refs[node.block] != 1:
                    continue
                if victim is None or node.last_used < victim.last_used:
                    victim = node
            if victim is None:
                break
            self._detach(victim)
            released += 1
        self.evictions_n += released
        return released

    def clear(self) -> int:
        """Drop every cached chain whose blocks are unreferenced (leaf-up);
        referenced chains stay. Returns blocks released."""
        return self.evict(len(self._nodes))

    def _detach(self, node: _Node) -> None:
        del node.parent.children[node.key]
        del self._nodes[node.block]
        self.mgr.release_block(node.block)

    def note_cow(self, n: int = 1) -> None:
        """Count ``n`` copy-on-write block materializations (engine calls
        this next to the device copy)."""
        self.cow_copies_n += n
