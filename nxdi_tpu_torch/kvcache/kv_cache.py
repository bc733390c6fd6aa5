"""KV cache — layer-stacked, updated in place.

Counterpart of ``nxdi_tpu/kvcache/kv_cache.py`` for three layouts:

- contiguous: one tensor per cache side, stacked over layers,
  ``(n_layers, batch, kv_heads, max_len, head_dim)``; the K/V of the token
  at position p of line b lands at ``[b, :, p, :]``.
- paged (the serving engine's pool): ``(n_layers, num_blocks * block_size,
  kv_heads, head_dim)`` — a flat slot pool per layer, written through a
  slot mapping and read through per-row block tables.
- the window-sized ring (``window_sized_kv``, :class:`WindowKVLayout`): the
  contiguous layout's shape with W slots in place of max_len; position p
  lives in slot p % W. An interleaved model (full and sliding-window layers)
  keeps its full layers on the contiguous stack ``k`` / ``v`` and its window
  layers on a ring stack ``k_win`` / ``v_win`` of the same cache dict.

``KVCacheSpec.v_head_dim`` gives the V stack its own width: an MLA model's
latent cache (one kv head, K the rotated rope key, V the normed kv latent,
``ops/mla.py``) and MiMo-V2's stacks, whose values are narrower than their
keys, on the contiguous layout and the window-sized ring.

The JAX package carries the cache through each jitted step as a donated
pytree; here the tensors are simply mutated in place — the prefill writes,
the decode commit kernel, the paged scatter and the copy-on-write block copy
all write into the caller's cache. Right-padded prefill garbage sits at
future positions that decode overwrites before any query attends them.

Contiguous continuous batching (``route_by_seq_id``): batch row i reads and
writes cache line ``seq_ids[i]``, and a negative ``write_positions`` entry
(a frozen row of the K-step and loop bodies) drops the row's write.

Quantized stores (the JAX package's KV quantization): a spec's
``quant_dtype`` (``float8_e4m3``, ``float8_e5m2``, ``int8``) is the store
dtype, one byte per element, and the layouts scale on the way in and out —
the contiguous layout in all four modes (``direct_cast``, ``per_tensor``
``k_scale``/``v_scale``, ``per_key`` / ``per_channel`` arrays selected by
``layer_idx``), the paged layout at ``direct_cast`` and ``per_tensor``. The
writes round and saturate as the JAX package's do (:func:`xla_cast`), so the
two packages store the same bits. The paged kernels read the one-byte pool
themselves, with ``k_scale`` folded into the softmax scale and ``v_scale``
into the output. One-byte tensors move as ``uint8`` views (:func:`raw`).

:func:`export_kv_blocks` / :func:`import_kv_blocks` move a block chain to
the host and back: the disaggregation handoff (``serving/handoff.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import functools

import numpy as np
import torch

from nxdi_tpu_torch.config import to_torch_dtype
from nxdi_tpu_torch.ops.kernels import flash_attention as fa
from nxdi_tpu_torch.ops.kernels import kv_commit
from nxdi_tpu_torch.runtime.device import resolve_device


def raw(t: torch.Tensor) -> torch.Tensor:
    """A one-byte float tensor as its ``uint8`` bytes (a view), so indexing,
    scatters and copies move bits on every device; other tensors as they
    are."""
    if t.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
        return t.view(torch.uint8)
    return t


# the largest magnitude XLA rounds to e4m3fn's max (448) instead of NaN: the
# tie at 464 goes to the even mantissa
_E4M3_ROUND_LIMIT = 464.0


def xla_cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x.astype(dtype)`` as the JAX package's XLA computes it: float to
    int8 truncates toward zero and saturates (NaN to 0), float to e4m3fn
    rounds to nearest even and overflows past 464 to NaN (torch saturates
    both: int8 wraps, e4m3fn clamps to 448). e5m2 and wider floats agree."""
    if dtype == torch.int8:
        y = torch.nan_to_num(x.to(torch.float32), nan=0.0, posinf=127.0, neginf=-128.0)
        return y.trunc().clamp(-128, 127).to(torch.int8)
    if dtype == torch.float8_e4m3fn:
        over = x.abs() > _E4M3_ROUND_LIMIT  # 464 is exact in every float dtype
        nan = torch.copysign(torch.full_like(x, float("nan")), x)  # NaN keeps the sign
        return torch.where(over, nan, x).to(dtype)
    return x.to(dtype)


@dataclass(frozen=True)
class KVCacheSpec:
    num_layers: int
    batch_size: int
    num_kv_heads: int
    max_len: int
    head_dim: int
    dtype: str = "bfloat16"
    # the one-byte store of a quantized cache (None: the compute dtype)
    quant_dtype: Optional[str] = None
    # the V stack's width where it differs from K's (an MLA latent cache,
    # MiMo-V2's stacks); None = the same as k
    v_head_dim: Optional[int] = None

    @property
    def torch_dtype(self) -> torch.dtype:
        """The compute dtype the layouts read into."""
        return to_torch_dtype(self.dtype)

    @property
    def store_dtype(self) -> torch.dtype:
        return to_torch_dtype(self.quant_dtype or self.dtype)

    @property
    def shape(self) -> Tuple[int, ...]:
        return (self.num_layers, self.batch_size, self.num_kv_heads, self.max_len, self.head_dim)

    @property
    def shape_v(self) -> Tuple[int, ...]:
        d = self.v_head_dim if self.v_head_dim is not None else self.head_dim
        return self.shape[:-1] + (d,)


def init_kv_cache(spec, device=None) -> Dict[str, torch.Tensor]:
    """Zero-initialized cache {'k': ..., 'v': ...} on ``device`` (the card
    unless the CPU is asked for) for a :class:`KVCacheSpec` or a
    :class:`BlockKVCacheSpec` (the paged pool)."""
    device = resolve_device(device)
    return {
        "k": torch.zeros(spec.shape, dtype=spec.store_dtype, device=device),
        "v": torch.zeros(spec.shape_v, dtype=spec.store_dtype, device=device),
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
    quant_dtype: Optional[str] = None

    @property
    def torch_dtype(self) -> torch.dtype:
        """The compute dtype the layouts read into."""
        return to_torch_dtype(self.dtype)

    @property
    def store_dtype(self) -> torch.dtype:
        return to_torch_dtype(self.quant_dtype or self.dtype)

    @property
    def total_slots(self) -> int:
        return self.num_blocks * self.block_size

    @property
    def shape(self) -> Tuple[int, ...]:
        return (self.num_layers, self.total_slots, self.num_kv_heads, self.head_dim)

    @property
    def shape_v(self) -> Tuple[int, ...]:
        return self.shape


def reset_kv_cache(cache: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Zero every tensor of ``cache`` in place (nested dicts too: a
    speculation app's ``{"draft": ..., "target": ...}`` caches)."""
    for t in cache.values():
        if isinstance(t, dict):
            reset_kv_cache(t)
        else:
            t.zero_()
    return cache


def _const(x: torch.Tensor, value: float) -> torch.Tensor:
    """``value`` as a (1,) tensor in x's dtype on x's device: rounded to that
    dtype as the JAX package's weakly typed scalars are, and divided by
    elementwise (torch turns division by a scalar into a reciprocal
    product, which rounds differently)."""
    return torch.full((1,), value, dtype=x.dtype, device=x.device)


@functools.lru_cache(maxsize=None)
def _scale_table(scales: tuple, axis: str, device: str) -> torch.Tensor:
    """A per-layer scale table (L, KV) or (L, D) as a broadcastable float32
    tensor (L, 1, KV, 1, 1) or (L, 1, 1, 1, D) on ``device``, made once (a
    CUDA graph's capture must not copy it from the host)."""
    arr = torch.tensor(np.asarray(scales, dtype=np.float32), device=device)
    return arr[:, None, :, None, None] if axis == "key" else arr[:, None, None, None, :]


def clip_to_store(x: torch.Tensor, store: torch.dtype) -> torch.Tensor:
    """Saturate (and, for an integer store, round half to even) before the
    store cast, in x's dtype: e4m3fn has no inf, and an int8 cast truncates
    (the JAX package's ``ContiguousKVLayout.clip_to_store``)."""
    if not store.is_floating_point:
        info = torch.iinfo(store)
        return torch.clamp(torch.round(x), info.min, info.max)
    lim = float(torch.finfo(store).max)
    return torch.clamp(x, -lim, lim)


@dataclass(frozen=True)
class ContiguousKVLayout:
    """(B_cache, KV, S, D) lines addressed by (batch row, position), or under
    ``route_by_seq_id`` by (``seq_ids[row]``, position): continuous batching,
    where one request's prefill lands in its own line while the other lines
    keep decoding.

    A quantized store: values are divided by their scale and saturated
    before the store cast and multiplied back after the load —
    ``k_scale``/``v_scale`` (per_tensor), or the per-layer ``k_scales`` /
    ``v_scales`` tables ((L, KV) per kv head, ``scale_axis="key"``, or
    (L, D) per head-dim channel, ``"channel"``), whose row the layer loop
    selects by ``cache_inputs["layer_idx"]``; ``commit_rows`` broadcasts
    the whole table over the stack."""

    route_by_seq_id: bool = False
    k_scale: float = 1.0
    v_scale: float = 1.0
    k_scales: Optional[tuple] = None  # (L, KV) or (L, D) nested tuple
    v_scales: Optional[tuple] = None
    scale_axis: Optional[str] = None  # "key" | "channel" when *_scales set

    def has_array_scales(self) -> bool:
        return self.k_scales is not None or self.v_scales is not None

    def scaled(self, which: str) -> bool:
        """Whether side ``which`` ("k" or "v") is scaled."""
        return self.has_array_scales() or (self.k_scale if which == "k" else self.v_scale) != 1.0

    def _scale_for(self, which: str, cache_inputs, stacked: bool,
                   device) -> Union[float, torch.Tensor]:
        """The active scale: a float (per_tensor), or a float32 tensor that
        broadcasts against a layer's (B, KV, S, D) view or, ``stacked``, the
        (L, B, KV, S, D) stack."""
        scales = self.k_scales if which == "k" else self.v_scales
        if scales is None:
            return self.k_scale if which == "k" else self.v_scale
        table = _scale_table(scales, self.scale_axis, str(torch.device(device)))
        if stacked:
            return table
        li = (cache_inputs or {}).get("layer_idx")
        if li is None:
            raise NotImplementedError(
                "per-key/per-channel KV scales need the layer index; this "
                "execution path does not provide one"
            )
        return table[min(max(int(li), 0), table.shape[0] - 1)]

    def quantize_rows(self, which: str, x: torch.Tensor, store: torch.dtype,
                      cache_inputs, stacked: bool = False) -> torch.Tensor:
        """Fresh K or V rows (compute dtype) as the store holds them: divided
        by the scale and saturated, then cast to ``store`` (the JAX
        package's ``update`` and ``commit_rows`` arithmetic, step for
        step)."""
        if stacked:  # commit_rows(): the whole stack at once
            if self.has_array_scales():
                sc = self._scale_for(which, cache_inputs, True, x.device)
                return clip_to_store(x.to(torch.float32) / sc, store).to(store)
            sc = self.k_scale if which == "k" else self.v_scale
            if sc != 1.0:
                x = x / _const(x, sc)  # in the rows' dtype
        elif self.scaled(which):  # update(): scaled in f32, back to the rows' dtype
            sc = self._scale_for(which, cache_inputs, False, x.device)
            xf = x.to(torch.float32)
            sc = sc if isinstance(sc, torch.Tensor) else _const(xf, sc)
            x = clip_to_store(xf / sc, store).to(x.dtype)
        if store != x.dtype:
            x = clip_to_store(x, store)  # the narrowing store saturates
        return x.to(store)

    def dequantize(self, which: str, kk: torch.Tensor, compute: torch.dtype,
                   cache_inputs) -> torch.Tensor:
        """Stored rows (any view of one layer) in the compute dtype, times
        their scale."""
        kk = kk.to(compute)
        if not self.scaled(which):
            return kk
        sc = self._scale_for(which, cache_inputs, False, kk.device)
        if isinstance(sc, torch.Tensor):
            return (kk * sc).to(compute)
        return (kk * _const(kk, sc)).to(compute)

    def round_trip(self, which: str, x: torch.Tensor, store: torch.dtype,
                   cache_inputs) -> torch.Tensor:
        """A fresh row through ``store`` and its scale and back: the JAX
        package's round trip of the deferred decode's fresh rows. Its
        forward passes the compute dtype as ``store`` (the model's cache
        spec there carries no quant dtype), so the row is only divided and
        multiplied by its scale."""
        if store == x.dtype and not self.scaled(which):
            return x
        sc = self._scale_for(which, cache_inputs, False, x.device)
        if isinstance(sc, torch.Tensor):
            q = clip_to_store(x / sc, store).to(store).to(x.dtype)
            return (q * sc).to(x.dtype)
        s_t = _const(x, sc)
        q = clip_to_store(x / s_t, store).to(store).to(x.dtype)
        return (q * s_t).to(x.dtype)

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
        k_st = self.quantize_rows("k", k_new, store, cache_inputs)
        v_st = self.quantize_rows("v", v_new, store, cache_inputs)
        if (S_act > 1 and cache_inputs.get("prefill_from_zero", False)
                and not self.route_by_seq_id):
            # context encoding from a fresh cache: every row writes positions
            # [0, S_act) (right-pad lanes continue the arange) — one slice copy
            raw(k_cache_l)[:B, :, :S_act] = raw(k_st)
            raw(v_cache_l)[:B, :, :S_act] = raw(v_st)
            return k_cache_l, v_cache_l
        # one layer through the commit kernel: row t of batch line b lands at
        # slot pos[b, t] of its line; out-of-range slots and lines drop, at
        # fixed shapes (so a routed prefill stays capturable)
        kv_commit.kv_commit_rows(
            k_cache_l[None], v_cache_l[None], k_st[None], v_st[None],
            self.write_positions(cache_inputs), self.lines(cache_inputs, B))
        return k_cache_l, v_cache_l

    def read(self, k_cache_l, v_cache_l, cache_inputs, spec):
        """Returns (kk, vv, kv_pos): (B, KV, W, D) x2 in the compute dtype
        (dequantized) and (B, W) positions; under ``route_by_seq_id`` row i
        reads line ``seq_ids[i]`` (clipped into range, as the JAX package's
        gather)."""
        kk = self.dequantize("k", k_cache_l, spec.torch_dtype, cache_inputs)
        vv = self.dequantize("v", v_cache_l, spec.torch_dtype, cache_inputs)
        if self.route_by_seq_id:
            sid = cache_inputs["seq_ids"].long().clamp(0, kk.shape[0] - 1)
            kk, vv = kk[sid], vv[sid]
        B, W = kk.shape[0], kk.shape[2]
        kv_pos = torch.arange(W, dtype=torch.int32, device=kk.device)[None, :].expand(B, W)
        return kk, vv, kv_pos

    def commit_rows(self, cache, k_rows, v_rows, cache_inputs, spec):
        """Deferred-write commit: land every layer's fresh rows
        (L, B, KV, S_act, D) in the stacked cache in ONE in-place kernel
        launch (negative or out-of-range positions and lines drop); a
        quantized store gets the rows scaled, saturated and cast first.

        The JAX package keeps a jnp scatter when ``write_positions`` is given:
        its TPU kernel rewrites a 128-slot window per row, and a frozen lane
        sharing row 0's line would write a stale window back. The port's
        kernel writes each row directly, so it serves frozen lanes too (a
        departure)."""
        B = k_rows.shape[1]
        kv_commit.kv_commit_rows(
            cache["k"], cache["v"],
            self.quantize_rows("k", k_rows, cache["k"].dtype, cache_inputs, stacked=True),
            self.quantize_rows("v", v_rows, cache["v"].dtype, cache_inputs, stacked=True),
            self.write_positions(cache_inputs), self.lines(cache_inputs, B),
        )
        return cache


@dataclass(frozen=True)
class BlockKVLayout:
    """Paged pool addressed by slot mappings (writes) and block tables
    (reads). Negative slots drop the write (see :func:`scatter_indices`); the
    block-table gather returns rows in logical token order, so kv positions
    are simply 0..W-1, with holes (negative table entries) poisoned. A
    quantized pool takes ``direct_cast`` or static ``per_tensor`` scales: the
    rows are divided by the scale and cast to the store (no clip, as in the
    JAX package), and the reads and the paged kernels multiply back."""

    block_size: int
    k_scale: float = 1.0
    v_scale: float = 1.0

    def update(self, k_cache_l, v_cache_l, k_new, v_new, cache_inputs, spec):
        """Scatter this step's K/V (B, KV, S_act, D) into one layer's pool
        (total_slots, KV, D) IN PLACE: the token at flat (B, S_act) index
        ``write_index[i]`` lands at slot ``write_slots[i]``. Both come from
        :func:`scatter_indices` on the host, so the device needs no sync per
        layer to find the tokens that write."""
        idx, rows = cache_inputs["write_index"], cache_inputs["write_slots"]
        store = k_cache_l.dtype
        flat = (-1, k_new.shape[1], k_new.shape[3])
        for cache_l, new, sc in ((k_cache_l, k_new, self.k_scale), (v_cache_l, v_new, self.v_scale)):
            if sc != 1.0:
                new = new / _const(new, sc)
            raw(cache_l)[rows] = raw(xla_cast(new.transpose(1, 2).reshape(flat)[idx], store))
        return k_cache_l, v_cache_l

    def read(self, k_cache_l, v_cache_l, cache_inputs, spec):
        """Gather each row's blocks in table order: returns (kk, vv, kv_pos),
        (B, KV, W, D) x2 in the compute dtype with W = table width * block
        size, and (B, W) logical positions where hole entries read slot 0 and
        carry the position 2**30, which no causal mask admits."""
        bt = cache_inputs["block_table"]
        kk, live = fa.gather_pages(k_cache_l, bt, self.block_size)
        vv, _ = fa.gather_pages(v_cache_l, bt, self.block_size)
        W = kk.shape[2]
        kv_pos = torch.arange(W, dtype=torch.int32, device=kk.device).expand(bt.shape[0], W)
        kv_pos = torch.where(live, kv_pos, torch.full_like(kv_pos, 2 ** 30))
        compute = spec.torch_dtype
        kk, vv = kk.to(compute), vv.to(compute)
        if self.k_scale != 1.0:
            kk = kk * _const(kk, self.k_scale)
        if self.v_scale != 1.0:
            vv = vv * _const(vv, self.v_scale)
        return kk, vv, kv_pos


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
        raw(cache[key])[:, d] = raw(cache[key])[:, s]
    return cache


def _chain_slots(blocks, block_size: int) -> np.ndarray:
    blocks = np.asarray(blocks, dtype=np.int64).reshape(-1)
    if blocks.size == 0:
        raise ValueError("empty block chain")
    if (blocks < 0).any():
        raise ValueError(f"negative block id in chain: {blocks.tolist()}")
    return _block_slots(blocks, block_size)


def export_kv_blocks(cache, blocks, block_size: int) -> Dict[str, torch.Tensor]:
    """Gather a block chain's K/V rows to the host for the disaggregation
    handoff (``serving/handoff.py``): ``{"k", "v"}`` CPU tensors of shape
    ``(num_layers, len(blocks) * block_size, num_kv_heads, head_dim)`` in
    the pool's store dtype (the JAX package's ``export_kv_blocks``)."""
    slots = torch.from_numpy(_chain_slots(blocks, block_size)).to(cache["k"].device)
    return {side: raw(cache[side])[:, slots].to("cpu").view(cache[side].dtype)
            for side in ("k", "v")}


def import_kv_blocks(cache, blocks, payload: Dict[str, torch.Tensor], block_size: int):
    """Scatter an exported chain into the receiver's pool at ``blocks``, IN
    PLACE; returns the cache. The layout, the length and the dtype are
    checked against the receiver's pool, in the JAX package's order and
    words, before anything is written."""
    slots = _chain_slots(blocks, block_size)
    for side in ("k", "v"):
        rows = payload[side]
        want = tuple(cache[side].shape)
        have = tuple(rows.shape)
        if len(have) != len(want) or have[0] != want[0] or have[2:] != want[2:]:
            raise ValueError(
                f"handoff {side} layout mismatch: payload {have} does "
                f"not address a cache of shape {want} "
                "(layers/heads/head_dim must agree)"
            )
        if have[1] != slots.size:
            raise ValueError(
                f"handoff {side} length mismatch: payload carries {have[1]} "
                f"slots but the chain places {slots.size} "
                f"({len(np.asarray(blocks).reshape(-1))} blocks x {block_size})"
            )
        if rows.dtype != cache[side].dtype:
            raise ValueError(
                f"handoff {side} dtype mismatch: payload {rows.dtype} vs "
                f"receiver cache {cache[side].dtype}"
            )
    dev = cache["k"].device
    idx = torch.from_numpy(slots).to(dev)
    for side in ("k", "v"):
        raw(cache[side])[:, idx] = raw(payload[side]).to(dev)
    return cache


@dataclass(frozen=True)
class WindowKVLayout:
    """The W-slot ring of sliding-window layers (the JAX package's
    ``WindowKVLayout``): (B_cache, KV, W, D) lines where position p lives in
    slot ``p % W``, W slots instead of max_len.

    Writes: only the last W real tokens of a forward land; a right-padding
    lane continues the positions past the true last token, so the keep mask
    reads ``last_token_index`` (without it a pad lane would overwrite a live
    slot), and one call never writes a slot twice. A negative write position
    (a frozen row's ``write_positions``) drops the write. Both go through the
    commit kernel, at fixed shapes, so a graph holds them.

    Reads: slot ``s`` holds position ``p - ((p - s) mod W)`` for the row's
    first query position p; a slot no position has reached yet is pushed out
    of every causal mask (2**30). The positions are computed on the device
    from ``position_ids``, so a captured graph reads nothing from the host.
    Under ``route_by_seq_id`` row i reads and writes line ``seq_ids[i]``.
    The store is the compute dtype (the JAX package refuses scaled stores on
    the ring; a quantized cache is refused on any windowed family)."""

    window: int
    route_by_seq_id: bool = False

    def has_array_scales(self) -> bool:
        return False

    def scaled(self, which: str) -> bool:
        return False

    def round_trip(self, which: str, x: torch.Tensor, store: torch.dtype,
                   cache_inputs) -> torch.Tensor:
        return x  # the ring stores the compute dtype, unscaled

    def lines(self, cache_inputs, B: int):
        return cache_inputs["seq_ids"].reshape(B) if self.route_by_seq_id else None

    write_positions = staticmethod(ContiguousKVLayout.write_positions)

    def write_slots(self, cache_inputs) -> torch.Tensor:
        """(B, S) ring slots of a forward's writes, -1 where the write drops:
        positions outside the last W real tokens of the row (by
        ``last_token_index``), and negative write positions."""
        pos = self.write_positions(cache_inputs).to(torch.int64)
        lti = cache_inputs.get("last_token_index")
        rows = cache_inputs["position_ids"].to(torch.int64)
        last_real = (torch.gather(rows, 1, lti.to(torch.int64).reshape(-1, 1)) if lti is not None
                     else rows[:, -1:])
        keep = (pos >= 0) & (pos <= last_real) & (pos > last_real - self.window)
        return torch.where(keep, torch.remainder(pos, self.window), torch.full_like(pos, -1))

    def update(self, k_cache_l, v_cache_l, k_new, v_new, cache_inputs, spec):
        """Write this forward's K/V (B, KV, S_act, D) into one layer's ring IN
        PLACE (the commit kernel, one layer); returns the (same) views."""
        B = k_new.shape[0]
        kv_commit.kv_commit_rows(
            k_cache_l[None], v_cache_l[None], k_new.to(k_cache_l.dtype)[None],
            v_new.to(v_cache_l.dtype)[None], self.write_slots(cache_inputs),
            self.lines(cache_inputs, B))
        return k_cache_l, v_cache_l

    def read(self, k_cache_l, v_cache_l, cache_inputs, spec):
        """(kk, vv, kv_pos): the ring (B, KV, W, D) in the compute dtype, row
        i's line ``seq_ids[i]`` (clipped) under ``route_by_seq_id``, and each
        slot's position (B, W) for the row's first query position."""
        kk, vv = k_cache_l.to(spec.torch_dtype), v_cache_l.to(spec.torch_dtype)
        if self.route_by_seq_id:
            sid = cache_inputs["seq_ids"].long().clamp(0, kk.shape[0] - 1)
            kk, vv = kk[sid], vv[sid]
        p = cache_inputs["position_ids"][:, :1].to(torch.int32)
        s = torch.arange(self.window, dtype=torch.int32, device=kk.device)[None, :]
        kv_pos = p - torch.remainder(p - s, self.window)
        return kk, vv, torch.where(kv_pos >= 0, kv_pos, torch.full_like(kv_pos, 2 ** 30))

    def commit_rows(self, cache, k_rows, v_rows, cache_inputs, spec):
        """Deferred-write commit into the ring stack: every layer's fresh rows
        (L, B, KV, S_act, D) land at slot ``p % W`` in ONE kernel launch; a
        negative write position drops. Attending the OLD ring before this
        commit is right: the stale row in slot p % W reports position p (the
        ring arithmetic of :meth:`read`), which the deferred decode's strict
        mask excludes, and its true position p - W is outside the window."""
        pos = self.write_positions(cache_inputs).to(torch.int64)
        slots = torch.where(pos >= 0, torch.remainder(pos, self.window), torch.full_like(pos, -1))
        kv_commit.kv_commit_rows(
            cache["k"], cache["v"], k_rows.to(cache["k"].dtype), v_rows.to(cache["v"].dtype),
            slots, self.lines(cache_inputs, k_rows.shape[1]))
        return cache


DEFAULT_KV_LAYOUT = ContiguousKVLayout()
