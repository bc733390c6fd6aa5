"""Ragged paged attention: CUDA kernels (``csrc/ragged_paged.cu``: the
ragged addressing mode of the prefill kernels in ``csrc/prefill_kernel.cuh``
for tiles of one row, a split kernel over kv chunks and a combine kernel for
the rest), their host work list :func:`ragged_plan`, and the plain PyTorch
version.

Replaces ``nxdi_tpu/ops/kernels/ragged_paged_attention.py::
ragged_paged_attention`` (Pallas, ``pl.pallas_call`` at
ragged_paged_attention.py:199): ONE attention launch for the serving
engine's mixed step, prefill chunks and decode tokens packed into one token
stream (batch 1). Token t belongs to row ``row_ids[t]`` at position
``q_pos[t]`` and attends that row's blocks at logical positions up to its
own; holes (negative table entries) are skipped; ``k_scale`` folds into the
softmax scale and ``v_scale`` into the output; padding tokens (row -1) and
tokens with no visible key output exactly 0.

The kernels run a work list built on the host from the token tags
(:func:`ragged_plan`): 64-token q tiles that hold one row's prefill chunk
run the prefill kernels' tensor-core body; every other token's context is
cut into kv chunks, one block per (chunk, kv head) serving the kv head's G
q heads, and the chunks' partial softmax states are merged in chunk order
by a combine kernel (no atomics: the same bits on every call). The serving engine builds the plan once per mixed
dispatch, where the tags are still on the host (``MixedModelWrapper``), and
hands it to every layer; a caller that passes none gets one built here.

The kernels read the plan's counts from its header on the card, so a launch
may be sized from shapes alone: :func:`ragged_capacity` gives a bucket's
largest plan, and a plan padded to it (:func:`pad_plan`) runs in a launch
of that size, which is what the mixed step's CUDA graph holds.

The pool may hold a one-byte store (``float8_e4m3fn``, ``float8_e5m2``,
``int8``), read as the JAX kernel reads it: converted to q's dtype, with
the scales folded as above. Every head dim that is a multiple of 8 up to
256 runs (a one-byte pool: multiples of 16). With bf16 q at head dim 64 or
128 (and a block size the TMA walk takes) the plan's one-row tiles become
wgmma items
(:func:`ragged_direct_body`, ``ragged_plan(wgmma=True)``): up to 128
consecutive tokens of one row at consecutive positions, each a q tile of
the one-byte TMA + wgmma body (``csrc/prefill_wgmma.cuh``), whose raw K/V
boxes are converted to bf16 in shared memory.

The wrapper takes its plain version for tensors on the CPU only; for a CUDA
tensor it launches the kernels or raises, and counts each call in
``ragged_paged_attention.launches``. Tags and tables may arrive on the host
(int32 numpy or CPU tensors); they are moved to the operands' device here.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from nxdi_tpu_torch.ops.kernels import _build
from nxdi_tpu_torch.ops.kernels.flash_attention import (
    ONE_BYTE_STORES,
    WGMMA_HEAD_DIMS,
    _check_cuda_operand,
    _check_head_dim,
    _check_kv_store,
    _check_tma,
    _plain_attention,
    gather_pages,
    paged_wgmma_block,
)

# rows the one-kernel design (ragged_plan(split=False)) may hold: its q
# tiles keep a 64-bit mask of the rows present. The split plan gives direct
# tiles only to tiles of one row, so it takes any number of rows.
MAX_ROWS = 64

# a launch sized from shapes (ragged_capacity) gives the split kernel at
# most this many blocks (items x kv heads) and the combine at most COMB_GRID
# blocks along its tokens; they stride over the rest of their lists
SPLIT_BLOCKS = 4 * 132
COMB_GRID = 4 * 132

# the work list's layout (shared with csrc/prefill_kernel.cuh): a header
# (T, direct tiles, items, partial slots, tokens to combine, chunk, wgmma
# items, 0), then the direct tiles, the wgmma items, the items and the
# tokens to combine
PLAN_HEADER = 8
WG_INTS = 4      # first token, tokens, row, first position
ITEM_INTS = 7    # token, row, kv begin, kv end, chunk index, chunks, first slot
COMB_INTS = 3    # token, first slot, chunks (0: the token writes 0)
TILE = 64        # q tile of the direct kernels
WG_TILE = 128    # tokens of a wgmma item at most (the wgmma body's q tile)
CHUNK_UNIT = 128  # kv chunks are whole multiples: the split kernel's 4 warps x 32 keys
CHUNK_MAX = 2048
# a launch of the split kernel should hold at least this many blocks: two
# per SM of an H100 (132 SMs)
MIN_SPLIT_BLOCKS = 2 * 132
# a tile holding one row runs the direct (tensor-core) kernel when the row
# has more tokens than this in it; fewer go to the split kernel
DIRECT_MIN_TOKENS = 16


@dataclasses.dataclass(frozen=True)
class RaggedPlan:
    """The ragged kernels' work list: the host counts the launch sizes come
    from, and the flat int32 list (numpy on the host, or its device copy)
    laid out as ``PLAN_HEADER`` ints, the direct tiles, the wgmma items
    (``WG_INTS`` each), the items (``ITEM_INTS`` each) and the tokens to
    combine (``COMB_INTS`` each). ``wgmma``: the one-row tiles are wgmma
    items (there are then no direct tiles)."""

    T: int
    n_direct: int
    n_items: int
    n_slots: int
    n_comb: int
    chunk: int
    flat: object
    split: bool = True
    # sized from shapes (ragged_capacity): the counts above are the bucket's
    # largest, the real ones are in the flat list's header on the card
    static: bool = False
    n_wg: int = 0
    wgmma: bool = False

    def to(self, device) -> "RaggedPlan":
        flat = self.flat
        if isinstance(flat, np.ndarray):
            flat = torch.from_numpy(flat)
        return dataclasses.replace(self, flat=flat.to(device))

    def direct_tiles(self) -> np.ndarray:
        return self._host()[PLAN_HEADER:PLAN_HEADER + self.n_direct]

    def wgmma_items(self) -> np.ndarray:
        """(n_wg, 4): first token, tokens, row, first position."""
        b = PLAN_HEADER + self.n_direct
        return self._host()[b:b + self.n_wg * WG_INTS].reshape(-1, WG_INTS)

    def items(self) -> np.ndarray:
        b = PLAN_HEADER + self.n_direct + self.n_wg * WG_INTS
        return self._host()[b:b + self.n_items * ITEM_INTS].reshape(-1, ITEM_INTS)

    def combined(self) -> np.ndarray:
        b = PLAN_HEADER + self.n_direct + self.n_wg * WG_INTS + self.n_items * ITEM_INTS
        return self._host()[b:b + self.n_comb * COMB_INTS].reshape(-1, COMB_INTS)

    def _host(self) -> np.ndarray:
        f = self.flat
        return f if isinstance(f, np.ndarray) else f.cpu().numpy()

    @property
    def flat_len(self) -> int:
        return (PLAN_HEADER + self.n_direct + self.n_wg * WG_INTS + self.n_items * ITEM_INTS
                + self.n_comb * COMB_INTS)

    def grids(self, kv_heads: int):
        """The launch sizes: (direct tiles, split blocks along the items,
        combine blocks along the tokens). A plan sized from shapes caps the
        last two (the kernels stride over the rest)."""
        if not self.static:
            return self.n_direct, self.n_items, self.n_comb
        return (self.n_direct, min(self.n_items, max(1, SPLIT_BLOCKS // kv_heads)),
                min(self.n_comb, COMB_GRID))


def _choose_chunk(lengths, kv_heads: int) -> int:
    """The largest chunk (a multiple of CHUNK_UNIT, up to CHUNK_MAX) that
    still gives the split launch MIN_SPLIT_BLOCKS blocks over these kv
    lengths; the smallest when none does."""
    chunk = CHUNK_UNIT
    while chunk * 2 <= CHUNK_MAX and kv_heads * sum(
            -(-n // (chunk * 2)) for n in lengths) >= MIN_SPLIT_BLOCKS:
        chunk *= 2
    return chunk


def ragged_capacity(T: int, num_rows: int, kv_width: int, kv_heads: int, *,
                    wgmma: bool = False) -> RaggedPlan:
    """The largest split plan :func:`ragged_plan` can give for a stream of
    ``T`` tokens, from shapes only (``flat`` is None). Direct tiles (or,
    with ``wgmma``, wgmma items, each holding at least one such tile):
    every tile that can hold more than DIRECT_MIN_TOKENS tokens. Tokens to
    combine: every token. Items: :func:`_choose_chunk`
    keeps doubling the chunk while ``kv_heads`` x the items of twice the
    chunk reach MIN_SPLIT_BLOCKS, so either the chunk stopped below
    CHUNK_MAX with fewer than ``2 * (MIN_SPLIT_BLOCKS - 1) // kv_heads``
    items, or it is CHUNK_MAX and each token has at most ``kv_width /
    CHUNK_MAX`` (rounded up) chunks. Partial slots: at most one per item."""
    items = max(2 * ((MIN_SPLIT_BLOCKS - 1) // kv_heads), T * -(-kv_width // CHUNK_MAX))
    direct = T // TILE + (T % TILE > DIRECT_MIN_TOKENS)
    return RaggedPlan(T=T, n_direct=0 if wgmma else direct, n_items=items, n_slots=items,
                      n_comb=T, chunk=0, flat=None, static=True, n_wg=direct if wgmma else 0,
                      wgmma=wgmma)


def pad_plan(plan: RaggedPlan, cap: RaggedPlan) -> np.ndarray:
    """``plan``'s flat list in a buffer of ``cap``'s length (the rest 0):
    what the kernels read when launched at ``cap``'s sizes."""
    if (plan.T != cap.T or not plan.split or plan.wgmma != cap.wgmma
            or plan.n_direct > cap.n_direct or plan.n_wg > cap.n_wg
            or plan.n_items > cap.n_items or plan.n_slots > cap.n_slots
            or plan.n_comb > cap.n_comb):
        raise ValueError(f"ragged plan (T {plan.T}: {plan.n_direct} tiles, {plan.n_wg} wgmma "
                         f"items, {plan.n_items} items, {plan.n_slots} slots, {plan.n_comb} to "
                         f"combine) exceeds the bucket's capacity {cap}")
    out = np.zeros(cap.flat_len, np.int32)
    host = plan._host()
    out[:host.size] = host
    return out


def _wgmma_runs(direct, rid, qp, real, T):
    """The wgmma items of ``direct`` one-row tiles, as an (n, WG_INTS) array
    (first token, tokens, row, first position), longest kv extent first. A
    tile's real tokens become a run when they sit at consecutive stream
    slots and consecutive positions (a tile whose tokens do not is left
    out); a run merges with the previous one when it continues it (the same
    row, the next slot, the next position) and the two hold at most WG_TILE
    tokens."""
    if not direct.size:
        return np.zeros((0, WG_INTS), np.int64)
    in_direct = np.zeros(-(-T // TILE), bool)
    in_direct[direct] = True
    tok = np.flatnonzero(real & in_direct[np.arange(T) // TILE])
    tt = tok // TILE
    counts = np.bincount(tt, minlength=in_direct.size)[direct]
    start = np.searchsorted(tt, direct)
    first, last = tok[start], tok[start + counts - 1]
    rel = np.repeat(first, counts)
    bad = np.bincount(np.repeat(np.arange(direct.size), counts),
                      weights=(qp[tok] - qp[rel]) != (tok - rel), minlength=direct.size)
    consec = (last - first + 1 == counts) & (bad == 0)
    runs = []
    for t0, n in zip(first[consec].tolist(), counts[consec].tolist()):
        row, p0 = int(rid[t0]), int(qp[t0])
        if runs:
            pt, pn, prow, pp = runs[-1]
            if prow == row and pt + pn == t0 and pp + pn == p0 and pn + n <= WG_TILE:
                runs[-1][1] += n
                continue
        runs.append([t0, n, row, p0])
    wg = np.array(runs, np.int64).reshape(-1, WG_INTS)
    return wg[np.argsort(-(wg[:, 3] + wg[:, 1]), kind="stable")]


def ragged_plan(row_ids, q_pos, num_rows: int, kv_width: int, kv_heads: int, *,
                split: bool = True, wgmma: bool = False) -> RaggedPlan:
    """The work list of one ragged call, from host int tags (numpy or CPU
    tensors): ``row_ids`` (T,) (-1, or a row outside [0, num_rows), is
    padding) and ``q_pos`` (T,); ``kv_width`` is a row's table width in
    positions (NB * block_size).

    - Direct tiles: 64-token tiles that hold more than DIRECT_MIN_TOKENS
      tokens of one row and no other row (a prefill chunk's tiles). With
      ``split=False`` every tile is direct: the earlier one-kernel design,
      which walks a tile's rows in series and holds at most MAX_ROWS rows
      (more raise).
    - With ``wgmma`` (the one-byte pool's wgmma body,
      :func:`ragged_direct_body`): those tiles become wgmma items instead,
      runs of up to WG_TILE consecutive tokens of one row at consecutive
      positions (two adjacent tiles of a chunk make one), longest kv extent
      first; a tile whose real tokens or positions are not consecutive goes
      to the items below, and the padding tokens of the runs' tiles to the
      tokens written 0.
    - Items: every other real token, over its kv positions [0, min(its
      position + 1, kv_width)) cut into chunks (``_choose_chunk``); a token
      of one chunk writes its output itself, a token of more reserves a
      partial slot per chunk.
    - Tokens to combine: the tokens of more than one chunk (merging them in
      chunk order), and every padding token or token that sees no position
      outside the direct tiles and wgmma items (written 0).

    Vectorised numpy over the host tags: no device work, no sync."""
    if not split and num_rows > MAX_ROWS:
        raise ValueError(
            f"ragged_paged_attention: {num_rows} rows exceed the kernel's {MAX_ROWS}")
    if wgmma and not split:
        raise ValueError("ragged_plan: wgmma items come with the split plan only")
    rid = np.asarray(row_ids, dtype=np.int64).reshape(-1)
    qp = np.asarray(q_pos, dtype=np.int64).reshape(-1)
    T = rid.shape[0]
    n_tiles = -(-T // TILE)
    tile = np.arange(T) // TILE
    real = (rid >= 0) & (rid < num_rows)
    if split:
        # a tile is direct when it holds one row only, with enough tokens
        real_n = np.bincount(tile, weights=real, minlength=n_tiles)
        pairs = np.unique(tile[real] * (num_rows + 1) + rid[real])
        rows_n = np.bincount(pairs // (num_rows + 1), minlength=n_tiles)
        is_direct = (rows_n == 1) & (real_n > DIRECT_MIN_TOKENS)
    else:
        is_direct = np.ones(n_tiles, bool)
    direct = np.flatnonzero(is_direct)
    covered = is_direct[tile]  # the tokens the direct tiles (or wgmma items) write
    wg = np.zeros((0, WG_INTS), np.int64)
    if wgmma:
        wg = _wgmma_runs(direct, rid, qp, real, T)
        direct = direct[:0]
        covered = np.zeros(T, bool)
        for t0, n, _, _ in wg.tolist():
            covered[t0:t0 + n] = True
    # every other token is an item of its own (a token's q heads fill a
    # block; a run of one row's tokens spreads over blocks), or, padding or
    # at a negative position, a token written 0
    width = np.minimum(qp + 1, kv_width)
    rest = ~covered
    tok = np.flatnonzero(rest & real & (width > 0))
    zeros = np.flatnonzero(rest & ~(real & (width > 0)))
    t_width = width[tok]
    chunk = _choose_chunk(t_width.tolist(), kv_heads) if tok.size else CHUNK_UNIT
    nch = -(-t_width // chunk)
    multi = nch > 1
    slot0 = np.cumsum(np.where(multi, nch, 0)) - np.where(multi, nch, 0)
    slots = int(nch[multi].sum())
    # items: one per (token, chunk), in stream order
    of = np.repeat(np.arange(tok.size), nch)
    c = np.arange(of.size) - np.repeat(np.cumsum(nch) - nch, nch)
    items = np.stack([tok[of], rid[tok][of], c * chunk,
                      np.minimum((c + 1) * chunk, t_width[of]), c, nch[of],
                      np.where(multi, slot0, 0)[of]], axis=1)
    # tokens to combine: those of more than one chunk, and the zeros
    comb = np.concatenate([
        np.stack([tok[multi], slot0[multi], nch[multi]], axis=1),
        np.stack([zeros, np.zeros_like(zeros), np.zeros_like(zeros)], axis=1),
    ])
    comb = comb[np.argsort(comb[:, 0], kind="stable")]
    flat = np.concatenate([
        np.array([T, direct.size, len(items), slots, len(comb), chunk, len(wg), 0], np.int64),
        direct, wg.reshape(-1), items.reshape(-1), comb.reshape(-1),
    ]).astype(np.int32)
    return RaggedPlan(T=T, n_direct=int(direct.size), n_items=len(items), n_slots=slots,
                      n_comb=len(comb), chunk=chunk, flat=flat, split=split, n_wg=len(wg),
                      wgmma=wgmma)


def ragged_direct_body(q_dtype: torch.dtype, kv_dtype: torch.dtype, head_dim: int,
                       block_size: int) -> str:
    """The body the ragged kernel's one-row tiles run: ``"wgmma"`` (bf16 q
    over a one-byte pool at head dim 64 or 128 with a block size
    ``paged_wgmma_block`` takes: the plan's wgmma items on the one-byte TMA
    + wgmma body, ``ragged_plan(wgmma=True)``), ``"mma"`` (mma.sync: other
    bf16 q at head dims that are multiples of 16, Gemma's 256 among them,
    where the plan holds direct tiles and no wgmma items) or ``"simt"``
    (CUDA cores). Looked up on every call (a caller may replace it, to time
    the earlier design)."""
    if (q_dtype == torch.bfloat16 and kv_dtype in ONE_BYTE_STORES
            and head_dim in WGMMA_HEAD_DIMS and paged_wgmma_block(block_size)):
        return "wgmma"
    if q_dtype == torch.bfloat16 and head_dim % 16 == 0:
        return "mma"
    return "simt"


def ragged_paged_kernel_supported(q_shape, cache_shape, block_size) -> bool:
    """The JAX package's rule in interpret mode: the packed layout (B == 1),
    whole heads per kv head, whole blocks."""
    B, H = q_shape[0], q_shape[1]
    total_slots, KV = cache_shape[0], cache_shape[1]
    return B == 1 and H % KV == 0 and total_slots % block_size == 0


def _host_ints(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.asarray(x)


def _as_tensor(x, device):
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device=device)


def ragged_paged_attention_plain(q, k_cache, v_cache, block_tables, row_ids, q_pos, *,
                                 block_size, scale=None, k_scale=1.0, v_scale=1.0):
    """Plain PyTorch version: the K/V of every row gathered through its
    table into one (1, KV, R * W, D) window (column g serves row g // W at
    in-row position g % W, holes masked) and the ragged causal mask rebuilt
    from the token tags, through the kernels' arithmetic
    (:func:`_plain_attention`)."""
    dev = q.device
    D = q.shape[3]
    bt = _as_tensor(block_tables, dev).long()
    rid = _as_tensor(row_ids, dev).long().reshape(-1)
    qp = _as_tensor(q_pos, dev).long().reshape(-1)
    R, NB = bt.shape
    W = NB * block_size
    kk, live = gather_pages(k_cache, bt.reshape(1, R * NB), block_size)
    vv, _ = gather_pages(v_cache, bt.reshape(1, R * NB), block_size)
    g = torch.arange(R * W, device=dev)
    mask = ((rid[:, None] == g[None, :] // W) & (g[None, :] % W <= qp[:, None])
            & live[0][None, :])[None]  # (1, T, R * W)
    scale = (D ** -0.5 if scale is None else scale) * k_scale
    return _plain_attention(q, kk.to(q.dtype), vv.to(q.dtype), mask, scale, v_scale)


def ragged_paged_attention(
    q: torch.Tensor,  # (1, H, T, D) — the packed queries
    k_cache: torch.Tensor,  # (total_slots, KV, D) — pool layer, this step's rows written
    v_cache: torch.Tensor,
    block_tables,  # (R, NB) int block ids per row in logical order; <0 = hole
    row_ids,  # (T,) int — owning row per packed token; -1 = padding
    q_pos,  # (T,) int — position within the row per packed token
    *,
    block_size: int,
    scale: Optional[float] = None,
    k_scale: float = 1.0,
    v_scale: float = 1.0,
    plan: Optional[RaggedPlan] = None,
) -> torch.Tensor:
    """Causal attention of a ragged mixed batch in one call. Returns
    (1, H, T, D) in q's dtype (a transposed view of a (1, T, H, D) buffer on
    the card, so the caller's head merge costs no copy). ``plan``: the work
    list (:func:`ragged_plan` over these tags; on the card it is built here
    from the tags when not given, which reads device tags back)."""
    name = "ragged_paged_attention"
    B, H, T, D = q.shape
    total_slots, KV = k_cache.shape[0], k_cache.shape[1]
    R, NB = block_tables.shape
    if (B != 1 or H % KV or k_cache.dim() != 3 or k_cache.shape != v_cache.shape
            or k_cache.shape[2] != D or tuple(row_ids.shape) != (T,)
            or tuple(q_pos.shape) != (T,)):
        raise ValueError(
            f"{name}: bad shapes q{tuple(q.shape)} pool{tuple(k_cache.shape)} "
            f"tables{tuple(block_tables.shape)} tags{tuple(row_ids.shape)}"
        )
    if block_size < 1 or total_slots % block_size:
        raise ValueError(f"{name}: {total_slots} pool slots are not whole blocks of {block_size}")
    _check_head_dim(D, name)
    code = _build.dtype_code(q, name)
    if q.device.type == "cpu":
        return ragged_paged_attention_plain(
            q, k_cache, v_cache, block_tables, row_ids, q_pos, block_size=block_size,
            scale=scale, k_scale=k_scale, v_scale=v_scale,
        )
    _check_cuda_operand(q, name, q.dtype)
    _check_kv_store(name, q, k_cache, v_cache)
    kv_code = _build.store_code(k_cache, q, name)
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError(f"{name}: the pool layers must be contiguous")
    wgmma = ragged_direct_body(q.dtype, k_cache.dtype, D, block_size) == "wgmma"
    if wgmma:
        _check_tma(name, (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)))
    scale = (D ** -0.5 if scale is None else scale) * k_scale
    dev = q.device
    bt = _as_tensor(block_tables, dev).to(torch.int32).contiguous()
    rid = _as_tensor(row_ids, dev).to(torch.int32).contiguous()
    qp = _as_tensor(q_pos, dev).to(torch.int32).contiguous()
    if plan is None:
        plan = ragged_plan(_host_ints(row_ids), _host_ints(q_pos), R, NB * block_size, KV,
                           wgmma=wgmma)
    if plan.T != T:
        raise ValueError(f"{name}: the plan covers {plan.T} tokens, the stream has {T}")
    if plan.wgmma != wgmma:  # no quiet fallback from one body to the other
        raise ValueError(f"{name}: the plan was built {'with' if plan.wgmma else 'without'} "
                         f"wgmma items, but this call's one-row tiles run the "
                         f"{'wgmma' if wgmma else 'direct-tile'} body (ragged_direct_body)")
    if not plan.split and R > MAX_ROWS:
        raise ValueError(f"{name}: {R} rows exceed the kernel's {MAX_ROWS}")
    flat = plan.to(dev).flat
    if flat.numel() < plan.flat_len:
        raise ValueError(f"{name}: the plan's list holds {flat.numel()} ints, its sizes "
                         f"need {plan.flat_len}")
    ws = (torch.empty(plan.n_slots * H * (D + 2), dtype=torch.float32, device=dev)
          if plan.n_slots else None)
    out = torch.empty((1, T, H, D), dtype=q.dtype, device=dev).transpose(1, 2)
    n_direct, n_items, n_comb = plan.grids(KV)
    err = _build.library().nxdi_ragged_paged(
        code, kv_code, q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
        rid.data_ptr(), qp.data_ptr(), bt.data_ptr(), flat.data_ptr(), n_direct,
        n_items, plan.n_slots, n_comb, plan.n_wg, int(plan.split),
        None if ws is None else ws.data_ptr(),
        H, KV, T, R, NB, block_size, D, total_slots, q.stride(1), q.stride(2), out.stride(1),
        out.stride(2), float(scale), float(v_scale), _build.stream_ptr(dev),
    )
    _build.check(err, name)
    ragged_paged_attention.launches += 1
    return out


ragged_paged_attention.launches = 0
