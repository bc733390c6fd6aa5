"""KV cache — layer-stacked, updated in place.

Counterpart of ``nxdi_tpu/kvcache/kv_cache.py`` for two layouts:

- contiguous: one tensor per cache side, stacked over layers,
  ``(n_layers, batch, kv_heads, max_len, head_dim)``; the K/V of the token
  at position p of line b lands at ``[b, :, p, :]``.
- paged (the serving engine's pool): ``(n_layers, num_blocks * block_size,
  kv_heads, head_dim)`` — a flat slot pool per layer, written through a
  slot mapping and read through per-row block tables.

The JAX package carries the cache through each jitted step as a donated
pytree; here the tensors are simply mutated in place — the prefill writes,
the decode commit kernel, the paged scatter and the copy-on-write block copy
all write into the caller's cache. Right-padded prefill garbage sits at
future positions that decode overwrites before any query attends them.

Contiguous continuous batching (``route_by_seq_id``): batch row i reads and
writes cache line ``seq_ids[i]``, and a negative ``write_positions`` entry
(a frozen row of the K-step and loop bodies) drops the row's write.

Not ported yet: quantized stores (``k_scale``/``v_scale`` other than 1.0 —
the paged kernels already take the scales) and the handoff export/import of
block chains.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

from nxdi_tpu_torch.config import to_torch_dtype
from nxdi_tpu_torch.ops.kernels import flash_attention as fa
from nxdi_tpu_torch.ops.kernels import kv_commit
from nxdi_tpu_torch.runtime.device import resolve_device


@dataclass(frozen=True)
class KVCacheSpec:
    num_layers: int
    batch_size: int
    num_kv_heads: int
    max_len: int
    head_dim: int
    dtype: str = "bfloat16"

    @property
    def torch_dtype(self) -> torch.dtype:
        return to_torch_dtype(self.dtype)

    @property
    def shape(self) -> Tuple[int, ...]:
        return (self.num_layers, self.batch_size, self.num_kv_heads, self.max_len, self.head_dim)


def init_kv_cache(spec, device=None) -> Dict[str, torch.Tensor]:
    """Zero-initialized cache {'k': ..., 'v': ...} on ``device`` (the card
    unless the CPU is asked for) for a :class:`KVCacheSpec` or a
    :class:`BlockKVCacheSpec` (the paged pool)."""
    device = resolve_device(device)
    return {
        "k": torch.zeros(spec.shape, dtype=spec.torch_dtype, device=device),
        "v": torch.zeros(spec.shape, dtype=spec.torch_dtype, device=device),
    }


@dataclass(frozen=True)
class BlockKVCacheSpec:
    """Paged layout: a flat pool of ``num_blocks * block_size`` token slots
    per layer, kept flat so the scatter and the block-table gather are
    single-index operations."""

    num_layers: int
    num_blocks: int
    block_size: int
    num_kv_heads: int
    head_dim: int
    dtype: str = "bfloat16"

    @property
    def torch_dtype(self) -> torch.dtype:
        return to_torch_dtype(self.dtype)

    @property
    def total_slots(self) -> int:
        return self.num_blocks * self.block_size

    @property
    def shape(self) -> Tuple[int, ...]:
        return (self.num_layers, self.total_slots, self.num_kv_heads, self.head_dim)


def reset_kv_cache(cache: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    for t in cache.values():
        t.zero_()
    return cache


@dataclass(frozen=True)
class ContiguousKVLayout:
    """(B_cache, KV, S, D) lines addressed by (batch row, position), or under
    ``route_by_seq_id`` by (``seq_ids[row]``, position): continuous batching,
    where one request's prefill lands in its own line while the other lines
    keep decoding."""

    route_by_seq_id: bool = False
    k_scale: float = 1.0
    v_scale: float = 1.0

    def __post_init__(self):
        if self.k_scale != 1.0 or self.v_scale != 1.0:
            raise NotImplementedError("scaled KV caches are not ported yet")

    def lines(self, cache_inputs, B: int):
        """(B,) cache line of each batch row under ``route_by_seq_id``, else None."""
        return cache_inputs["seq_ids"].reshape(B) if self.route_by_seq_id else None

    @staticmethod
    def write_positions(cache_inputs):
        """The positions a forward writes: ``write_positions`` (frozen rows
        -1) when given, else the rows' positions."""
        wp = cache_inputs.get("write_positions")
        return cache_inputs["position_ids"] if wp is None else wp

    def update(self, k_cache_l, v_cache_l, k_new, v_new, cache_inputs, spec):
        """Write this step's K/V (B, KV, S_act, D) into one layer's cache view
        IN PLACE; returns the (same) views."""
        B, S_act = k_new.shape[0], k_new.shape[2]
        store = k_cache_l.dtype
        if (S_act > 1 and cache_inputs.get("prefill_from_zero", False)
                and not self.route_by_seq_id):
            # context encoding from a fresh cache: every row writes positions
            # [0, S_act) (right-pad lanes continue the arange) — one slice copy
            k_cache_l[:B, :, :S_act] = k_new.to(store)
            v_cache_l[:B, :, :S_act] = v_new.to(store)
            return k_cache_l, v_cache_l
        # one layer through the commit kernel: row t of batch line b lands at
        # slot pos[b, t] of its line; out-of-range slots and lines drop, at
        # fixed shapes (so a routed prefill stays capturable)
        kv_commit.kv_commit_rows(
            k_cache_l[None], v_cache_l[None], k_new[None].to(store), v_new[None].to(store),
            self.write_positions(cache_inputs), self.lines(cache_inputs, B))
        return k_cache_l, v_cache_l

    def read(self, k_cache_l, v_cache_l, cache_inputs, spec):
        """Returns (kk, vv, kv_pos): (B, KV, W, D) x2 and (B, W) positions;
        under ``route_by_seq_id`` row i reads line ``seq_ids[i]`` (clipped into
        range, as the JAX package's gather)."""
        kk, vv = k_cache_l.to(spec.torch_dtype), v_cache_l.to(spec.torch_dtype)
        if self.route_by_seq_id:
            sid = cache_inputs["seq_ids"].long().clamp(0, kk.shape[0] - 1)
            kk, vv = kk[sid], vv[sid]
        B, W = kk.shape[0], kk.shape[2]
        kv_pos = torch.arange(W, dtype=torch.int32, device=kk.device)[None, :].expand(B, W)
        return kk, vv, kv_pos

    def commit_rows(self, cache, k_rows, v_rows, cache_inputs, spec):
        """Deferred-write commit: land every layer's fresh rows
        (L, B, KV, S_act, D) in the stacked cache in ONE in-place kernel
        launch (negative or out-of-range positions and lines drop).

        The JAX package keeps a jnp scatter when ``write_positions`` is given:
        its TPU kernel rewrites a 128-slot window per row, and a frozen lane
        sharing row 0's line would write a stale window back. The port's
        kernel writes each row directly, so it serves frozen lanes too (a
        departure)."""
        B = k_rows.shape[1]
        kv_commit.kv_commit_rows(
            cache["k"], cache["v"],
            k_rows.to(cache["k"].dtype), v_rows.to(cache["v"].dtype),
            self.write_positions(cache_inputs), self.lines(cache_inputs, B),
        )
        return cache


@dataclass(frozen=True)
class BlockKVLayout:
    """Paged pool addressed by slot mappings (writes) and block tables
    (reads). Negative slots drop the write (see :func:`scatter_indices`); the block-table
    gather returns rows in logical token order, so kv positions are simply
    0..W-1, with holes (negative table entries) poisoned."""

    block_size: int
    k_scale: float = 1.0
    v_scale: float = 1.0

    def __post_init__(self):
        if self.k_scale != 1.0 or self.v_scale != 1.0:
            raise NotImplementedError("scaled KV caches are not ported yet")

    def update(self, k_cache_l, v_cache_l, k_new, v_new, cache_inputs, spec):
        """Scatter this step's K/V (B, KV, S_act, D) into one layer's pool
        (total_slots, KV, D) IN PLACE: the token at flat (B, S_act) index
        ``write_index[i]`` lands at slot ``write_slots[i]``. Both come from
        :func:`scatter_indices` on the host, so the device needs no sync per
        layer to find the tokens that write."""
        idx, rows = cache_inputs["write_index"], cache_inputs["write_slots"]
        store = k_cache_l.dtype
        flat = (-1, k_new.shape[1], k_new.shape[3])
        k_cache_l[rows] = k_new.transpose(1, 2).reshape(flat)[idx].to(store)
        v_cache_l[rows] = v_new.transpose(1, 2).reshape(flat)[idx].to(store)
        return k_cache_l, v_cache_l

    def read(self, k_cache_l, v_cache_l, cache_inputs, spec):
        """Gather each row's blocks in table order: returns (kk, vv, kv_pos),
        (B, KV, W, D) x2 with W = table width * block size, and (B, W)
        logical positions where hole entries read slot 0 and carry the
        position 2**30, which no causal mask admits."""
        bt = cache_inputs["block_table"]
        kk, live = fa.gather_pages(k_cache_l, bt, self.block_size)
        vv, _ = fa.gather_pages(v_cache_l, bt, self.block_size)
        W = kk.shape[2]
        kv_pos = torch.arange(W, dtype=torch.int32, device=kk.device).expand(bt.shape[0], W)
        kv_pos = torch.where(live, kv_pos, torch.full_like(kv_pos, 2 ** 30))
        return kk.to(spec.torch_dtype), vv.to(spec.torch_dtype), kv_pos


def drop_slot(num_blocks: int, block_size: int) -> int:
    """The slot every dropped write of a fixed-length scatter lands in: the
    first of one extra block past the ``num_blocks`` the block manager hands
    out, which no block table reaches and nothing reads."""
    return num_blocks * block_size


def scatter_indices_fixed(slot_mapping, drop: int) -> Dict[str, np.ndarray]:
    """The inputs of :meth:`BlockKVLayout.update` at a fixed length, one
    entry per token of the padded (b, S) slot mapping: every token writes,
    and a token with a negative slot (a padding row or lane, a position
    without a block) writes the ``drop`` slot (:func:`drop_slot`) instead of
    nothing. The reachable pool ends as after :func:`scatter_indices`; the
    lengths depend on the shape only, so one CUDA graph serves every step."""
    flat = np.asarray(slot_mapping).reshape(-1)
    return {"write_index": np.arange(flat.size, dtype=np.int64),
            "write_slots": np.where(flat >= 0, flat, drop).astype(np.int64)}


def scatter_indices(slot_mapping) -> Dict[str, np.ndarray]:
    """The inputs of :meth:`BlockKVLayout.update` for a host slot mapping
    (b, S): the flat indices of the tokens whose slot is >= 0 and those
    slots, int64. A negative slot (a padding lane, a position without a
    block) writes nothing."""
    flat = np.asarray(slot_mapping).reshape(-1)
    keep = np.nonzero(flat >= 0)[0]
    return {"write_index": keep.astype(np.int64), "write_slots": flat[keep].astype(np.int64)}


def _block_slots(blocks, block_size: int) -> np.ndarray:
    blocks = np.asarray(blocks, dtype=np.int64).reshape(-1)
    offs = np.arange(block_size, dtype=np.int64)
    return (blocks[:, None] * block_size + offs[None, :]).reshape(-1)


def copy_kv_blocks(cache, src_blocks, dst_blocks, block_size: int):
    """Copy every slot of each ``src`` block into the matching ``dst`` block
    across all layers, for k and v, IN PLACE — the copy-on-write primitive
    of the serving engine (``BlockSpaceManager.cow_block`` swaps the table
    entry; this moves the data). It runs on the pool's stream, so it lands
    before any later dispatch that writes the copied block."""
    src = np.asarray(src_blocks).reshape(-1)
    dst = np.asarray(dst_blocks).reshape(-1)
    if src.shape != dst.shape:
        raise ValueError(f"src/dst block counts differ: {src.shape} vs {dst.shape}")
    if src.size == 0:
        return cache
    dev = cache["k"].device
    s = torch.from_numpy(_block_slots(src, block_size)).to(dev)
    d = torch.from_numpy(_block_slots(dst, block_size)).to(dev)
    for key in ("k", "v"):
        cache[key][:, d] = cache[key][:, s]
    return cache


DEFAULT_KV_LAYOUT = ContiguousKVLayout()
