"""Flash and paged attention: CUDA kernels (the prefill kernels of
``csrc/prefill_kernel.cuh`` behind ``csrc/flash_prefill.cu`` and
``csrc/paged_prefill.cu``; the decode kernel of ``csrc/decode_kernel.cuh``
behind ``csrc/flash_decode.cu``, ``csrc/window_decode.cu`` and
``csrc/paged_decode.cu``) and their plain PyTorch versions.

Counterpart of ``nxdi_tpu/ops/kernels/flash_attention.py``:

- :func:`flash_attention_prefill` replaces ``flash_attention_prefill``
  (Pallas, ``pl.pallas_call`` at flash_attention.py:234).
- :func:`flash_attention_decode_fused` and
  :func:`flash_attention_decode_fused_stacked` replace the two fused-decode
  entries (``pl.pallas_call`` at :629 and :509). One CUDA kernel serves both:
  the stacked entry hands it the ``cache[layer_idx]`` view, which costs
  nothing in torch, and takes an optional per-row cache line (``lines``,
  continuous batching) that the kernel reads in place of a gather.
- :func:`flash_attention_decode` replaces ``flash_attention_decode``
  (``pl.pallas_call`` at :337): decode over a window that already holds
  this step's row (the decode kernel's window mode).
- The fused and window decodes take a ``ring`` operand: the cache is then a
  W-slot ring (``kvcache/kv_cache.py::WindowKVLayout``), whose slot j holds
  position ``q - ((q - j) mod W)`` for the row's query position q
  (:func:`_ring_positions`); the JAX package reads such a cache with plain
  attention only.
- :func:`paged_attention_decode` and :func:`paged_attention_prefill`
  replace the block-table kernels (``pl.pallas_call`` at :802 and :946):
  K/V read through per-row block tables from the paged pool (the decode
  kernel's paged mode; the prefill kernels' paged instantiation).

The contiguous prefill has three bodies; :func:`prefill_body` picks one per
call: the TMA + wgmma body (``csrc/prefill_wgmma.cuh``) for bf16 at head
dims 64 and 128, the mma.sync body for other bf16 head dims that are
multiples of 16, the CUDA-core body otherwise. The paged prefill picks
among the same bodies (:func:`paged_prefill_body`); its TMA body reads the
pool through one box per pool block (:func:`paged_prefill_boxes`).

The decode kernel splits each row's kv range over blocks (flash decoding):
:func:`decode_chunk` takes the chunk length from shapes only, a block per
(chunk, kv head, row) writes its partial softmax state, and a combine
kernel merges the chunks in order.

The paged kernels also read a one-byte pool (``float8_e4m3fn``,
``float8_e5m2`` or ``int8``: the KV store of a quantized cache) with q in
bf16 or f32, as the JAX kernels read it in its store dtype: each kernel
converts its K/V tiles to q's dtype, ``k_scale`` folds into the softmax
scale and ``v_scale`` into the output. A one-byte paged prefill with bf16 q
at head dim 64 or 128 runs the TMA + wgmma body's one-byte variant
(:func:`paged_prefill_body`): the raw boxes land by TMA and producer warps
convert them to bf16 in shared memory (wgmma multiplies bf16 only by bf16,
and q stays bf16), so its output equals the bf16 body's on the up-cast pool
bit for bit.

Each wrapper takes its plain version for tensors on the CPU only; for a CUDA
tensor it launches the kernel or raises. Each kernel launch adds one to the
wrapper's ``launches`` attribute (launches of the plain version do not).
What bounds each kernel on the card, and what its simple design leaves for
later, is noted at the top of its ``.cu`` file.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from nxdi_tpu_torch.ops.attention import NEG_INF
from nxdi_tpu_torch.ops.kernels import _build

# head dims every attention kernel takes (multiples of 8; over a one-byte
# pool, multiples of 16): up to 256 (Gemma's). The TMA + wgmma bodies take
# 64 and 128 (WGMMA_HEAD_DIMS); the other head dims run the mma.sync body
# (bf16) or the CUDA-core body (f32)
MAX_HEAD_DIM = 256
# the one-byte KV stores the paged kernels read (and convert as tiles land)
ONE_BYTE_STORES = (torch.float8_e4m3fn, torch.float8_e5m2, torch.int8)
# the contiguous prefill's bodies (codes shared with csrc/flash_prefill.cu)
PREFILL_BODIES = {"simt": 0, "mma": 1, "wgmma": 2}
WGMMA_HEAD_DIMS = (64, 128)
PAGED_TILE = 128  # kv rows per tile of the paged TMA body


def _affine(start: torch.Tensor, n: int) -> torch.Tensor:
    """(B,) starts -> (B, n) positions start + arange (the kernels' contract:
    positions are affine per row)."""
    return start[:, None].long() + torch.arange(n, device=start.device)[None, :]


def _ring_positions(q_pos0: torch.Tensor, ring: int) -> torch.Tensor:
    """(B,) query positions -> (B, ring) positions of a ring's slots: slot j
    holds q - ((q - j) mod ring); a slot no position has reached yet (a
    negative one) gets 2**30, which no causal mask admits (the JAX
    package's ``WindowKVLayout.read``)."""
    q = q_pos0[:, None].long()
    pos = q - torch.remainder(q - torch.arange(ring, device=q.device)[None, :], ring)
    return torch.where(pos >= 0, pos, torch.full_like(pos, 2 ** 30))


def _check_ring(name: str, ring: Optional[int], slots: int) -> None:
    if ring is not None and ring != slots:
        raise ValueError(f"{name}: a ring of {ring} slots over a cache of {slots}")


def _opt(x: Optional[int]) -> int:
    return 0 if x is None else int(x)


def _visible(kv_pos, q_pos, strict: bool, sliding_window, chunk_size):
    """(B, Sq, Sk) mask from (B, Sk) and (B, Sq) positions."""
    kp, qp = kv_pos[:, None, :], q_pos[:, :, None]
    m = kp < qp if strict else kp <= qp
    if sliding_window is not None:
        m = m & (kp > qp - sliding_window)
    if chunk_size is not None:
        m = m & (torch.div(kp, chunk_size, rounding_mode="floor")
                 == torch.div(qp, chunk_size, rounding_mode="floor"))
    return m


def _check_head_dim(D: int, name: str, limit: int = MAX_HEAD_DIM) -> None:
    if D % 8 or D > limit:
        raise ValueError(f"{name}: head_dim {D} must be a multiple of 8 up to {limit}")


def _check_cuda_operand(t: torch.Tensor, name: str, dtype: torch.dtype) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: all operands must be on the same CUDA device")
    if t.dtype != dtype:
        raise TypeError(f"{name}: operand dtypes differ ({t.dtype} vs {dtype})")
    if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:-1]) or t.data_ptr() % 16:
        raise ValueError(
            f"{name}: operands need a unit-stride last dim, other strides a multiple "
            "of 8 elements and a 16-byte aligned base"
        )


def _check_kv_store(name: str, q: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor) -> None:
    """K/V pool operands: q's dtype (the checks of :func:`_check_cuda_operand`)
    or a one-byte store shared by k and v, whose rows must be whole 16-byte
    loads (a head dim that is a multiple of 16)."""
    if k_cache.dtype == q.dtype and v_cache.dtype == q.dtype:
        for t in (k_cache, v_cache):
            _check_cuda_operand(t, name, q.dtype)
        return
    if k_cache.dtype not in ONE_BYTE_STORES or v_cache.dtype != k_cache.dtype:
        raise TypeError(f"{name}: KV store dtypes ({k_cache.dtype}, {v_cache.dtype}) are "
                        f"neither q's ({q.dtype}) nor one shared one-byte store")
    D = q.shape[-1]
    if D % 16 or D > MAX_HEAD_DIM:
        raise ValueError(f"{name}: a one-byte KV store needs head_dim a multiple of 16 up to "
                         f"{MAX_HEAD_DIM}, got {D}")
    for t in (k_cache, v_cache):
        if t.device != q.device:
            raise ValueError(f"{name}: all operands must be on the same CUDA device")
        if t.stride(-1) != 1 or any(s_ % 16 for s_ in t.stride()[:-1]) or t.data_ptr() % 16:
            raise ValueError(f"{name}: a one-byte store needs a unit-stride last dim, other "
                             "strides in multiples of 16 elements and a 16-byte aligned base")


# ---------------------------------------------------------------------------
# The decode kernel's kv split (csrc/decode_kernel.cuh)
# ---------------------------------------------------------------------------

# a chunk is a whole number of these: the split kernel's 4 warps x 32 positions
DECODE_CHUNK_UNIT = 128
# q heads a decode block serves (the m16 tile's rows): a larger group of q
# heads per kv head runs in head tiles of this many, one more factor of the
# grid's kv-head axis (csrc/decode_kernel.cuh)
DECODE_HEAD_TILE = 16


def decode_head_tiles(H: int, KV: int) -> int:
    """Head tiles of the decode kernel's grid per kv head: ceil(G / 16)."""
    return -(-(H // KV) // DECODE_HEAD_TILE)


def decode_chunk(B: int, KV: int, kv_len: int, n_sm: int) -> int:
    """kv positions per block of the decode kernel, from shapes only: the
    largest multiple of DECODE_CHUNK_UNIT that still gives the launch two
    blocks per SM over the ``B * KV`` (row, kv head) pairs, or the whole
    range when one block per pair already does; never below the unit. The
    chunk does not depend on the rows' positions, so the launch reads
    nothing back from the card (a block whose chunk holds no visible
    position exits at once)."""
    unit = DECODE_CHUNK_UNIT
    whole = max(unit, -(-kv_len // unit) * unit)
    need = -(-2 * n_sm // max(1, B * KV))  # chunks per (row, kv head)
    if need <= 1:
        return whole
    # the largest chunk c with ceil(kv_len / c) >= need
    return min(whole, max(unit, (kv_len - 1) // (need - 1) // unit * unit))


def decode_visible_range(q_pos, kv_start, kv_len: int, *, fresh: bool, window=None,
                         ring: Optional[int] = None, chunk=None):
    """(lo, hi) int64 arrays: the slots [lo, hi) each row's decode query
    scans, as the kernel computes them (up to q_pos, exclusive when a fresh
    row replaces the slot at q_pos; inside kv_len; from the sliding
    window's start and from the start of q_pos's ``chunk``, but on a
    ``ring``, whose positions are not monotone in the slot, from 0). The
    window and chunk masks and holes are applied per position."""
    qp = np.asarray(q_pos, np.int64).reshape(-1)
    ks = np.zeros_like(qp) if kv_start is None else np.asarray(kv_start, np.int64).reshape(-1)
    hi = np.maximum(0, np.minimum(kv_len, qp - ks + (0 if fresh else 1)))
    lo = (np.maximum(0, np.minimum(hi, qp - window + 1 - ks)) if window and not ring
          else np.zeros_like(hi))
    if chunk and not ring:
        lo = np.maximum(lo, np.minimum(hi, qp // chunk * chunk - ks))
    return lo, hi


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _decode_split(B, H, KV, D, kv_len, device):
    """The decode launch's split: (chunk length, chunks, the partials'
    scratch or None), over the grid's B x KV x head tiles (row, kv head,
    tile) triples. ``decode_chunk`` is looked up on every call, so a caller
    may replace it (to time one chunk per row, the earlier design)."""
    chunk = decode_chunk(B, KV * decode_head_tiles(H, KV), kv_len,
                         _sm_count(device.index or 0))
    n = max(1, -(-kv_len // chunk))
    ws = (torch.empty(B * H * n * (D + 2), dtype=torch.float32, device=device)
          if n > 1 else None)
    return chunk, n, ws


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------


def _plain_attention(q, k, v, mask, scale, v_scale=1.0):
    """The kernels' arithmetic in plain PyTorch: q (B,H,Sq,D) against
    un-repeated k/v (B,KV,Sk,D) under a (B,Sq,Sk) mask; f32 scores, mask
    value -30000, the denominator clamped at 1e-20 (a row with no visible
    key outputs 0), probabilities rounded to v's dtype before P.V, v_scale
    on the output."""
    B, H, Sq, D = q.shape
    KV = k.shape[1]
    G = H // KV
    mask = mask[:, None, None]  # (B,1,1,Sq,Sk)
    qg = q.reshape(B, KV, G, Sq, D).float()
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k.float()) * scale
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    pv = torch.einsum("bkgqs,bksd->bkgqd", p.to(v.dtype).float(), v.float())
    if v_scale != 1.0:
        pv = pv * v_scale
    return (pv / l).to(q.dtype).reshape(B, H, Sq, D)


def flash_attention_prefill_plain(
    q, k, v, q_pos, kv_pos, *, scale=None, sliding_window=None, chunk_size=None
):
    """Plain PyTorch version of the prefill kernel: causal attention with
    positions rebuilt from the per-row starts (:func:`_plain_attention`)."""
    Sq, D, Sk = q.shape[2], q.shape[3], k.shape[2]
    scale = D ** -0.5 if scale is None else scale
    mask = _visible(_affine(kv_pos[:, 0], Sk), _affine(q_pos[:, 0], Sq), False,
                    sliding_window, chunk_size)
    return _plain_attention(q, k, v, mask, scale)


def _tma_strides_ok(t: torch.Tensor) -> bool:
    return not (t.data_ptr() % 16 or t.stride(-1) != 1 or any(
        (s * t.element_size()) % 16 for s in t.stride()[:-1]))


def _check_tma(name: str, operands) -> None:
    for what, t in operands:
        if not _tma_strides_ok(t):
            raise ValueError(
                f"{name}: {what} strides {tuple(t.stride())} (or its base) break TMA's rules: "
                "a 16-byte aligned base, a unit-stride last dim and other strides in "
                "multiples of 16 bytes")


def prefill_body(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The body the contiguous prefill runs for these operands: ``"wgmma"``
    (TMA + wgmma: bf16, head dim 64 or 128), ``"mma"`` (mma.sync: other bf16
    head dims that are multiples of 16) or ``"simt"`` (CUDA cores: f32, other
    bf16 head dims). The TMA body reads its tiles through tensor maps, which
    need a 16-byte aligned base and strides in whole 16-byte units; operands
    that break that raise (the model's layouts meet it)."""
    D = q.shape[3]
    if q.dtype == torch.bfloat16 and D in WGMMA_HEAD_DIMS:
        _check_tma("flash_attention_prefill", (("q", q), ("k", k), ("v", v)))
        return "wgmma"
    if q.dtype == torch.bfloat16 and D % 16 == 0:
        return "mma"
    return "simt"


def paged_wgmma_block(block_size: int) -> bool:
    """Whether the paged TMA body takes this pool block size: a 128-row kv
    tile must be whole boxes of ``min(block_size, 128)`` rows, at most 16 —
    block sizes 8, 16, 32 and 64 (several boxes a tile) or a multiple of 128
    (one box a tile). Over a bf16 pool each box is at least one 1 KB
    swizzle atom (8 rows of 64 bf16 columns); over a one-byte pool a box is
    whole rows of D bytes, unswizzled (the converting warps write the
    swizzled bf16 stage), each box 128-byte aligned in shared memory from 8
    rows of 64 bytes on, so the same block sizes serve both."""
    return block_size in (8, 16, 32, 64) or block_size % PAGED_TILE == 0


def paged_prefill_body(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                       block_size: int) -> str:
    """The body the paged prefill runs: ``"wgmma"`` (TMA + wgmma, K/V boxes
    per pool block: bf16 q at head dim 64 or 128 with a block size
    :func:`paged_wgmma_block` takes, over a bf16 pool or a one-byte pool,
    whose raw boxes are converted to bf16 in shared memory), ``"mma"``
    (mma.sync: other bf16 cases whose head dim is a multiple of 16, Gemma's
    256 among them, over either pool) or ``"simt"`` (CUDA cores: f32, other
    bf16 head dims). Operands whose strides TMA cannot take raise: an
    eligible call never falls back."""
    D = q.shape[3]
    if (q.dtype == torch.bfloat16 and (k_cache.dtype == q.dtype or k_cache.dtype in
                                       ONE_BYTE_STORES)
            and D in WGMMA_HEAD_DIMS and paged_wgmma_block(block_size)):
        _check_tma("paged_attention_prefill",
                   (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)))
        return "wgmma"
    if q.dtype == torch.bfloat16 and D % 16 == 0:
        return "mma"
    return "simt"


def paged_prefill_boxes(table_row, kt: int, block_size: int):
    """The TMA boxes the paged TMA body's producer issues for kv tile ``kt``
    (positions ``128 kt ... 128 kt + 127``) of one row, as
    ``csrc/prefill_wgmma.cuh`` computes them: ``(first tile row, pool slot,
    rows)`` per live pool block, boxes of ``min(block_size, 128)`` rows (of
    bf16 64-column boxes over a bf16 pool, of raw D-byte rows over a
    one-byte pool, both bodies the same list; the ragged kernel's wgmma
    items walk their row's table the same way).
    Holes (negative entries) and blocks past the table are left out (never
    loaded; their V rows are zeroed and their columns masked); a tile whose
    boxes are all left out is skipped."""
    rows = min(block_size, PAGED_TILE)
    out = []
    for i in range(PAGED_TILE // rows):
        j = kt * PAGED_TILE + i * rows
        e = j // block_size
        blk = int(table_row[e]) if e < len(table_row) else -1
        if blk >= 0:
            out.append((i * rows, blk * block_size + j % block_size, rows))
    return out


def flash_attention_prefill(
    q: torch.Tensor,  # (B, H, Sq, D)
    k: torch.Tensor,  # (B, KV, Sk, D)
    v: torch.Tensor,  # (B, KV, Sk, D)
    q_pos: torch.Tensor,  # (B, Sq) int — affine per row
    kv_pos: torch.Tensor,  # (B, Sk) int — affine per row
    *,
    scale: Optional[float] = None,
    sliding_window: Optional[int] = None,
    chunk_size: Optional[int] = None,
) -> torch.Tensor:
    """Causal flash attention for prefill. Returns (B, H, Sq, D) in q's
    dtype (a transposed view of a (B, Sq, H, D) buffer on the card, so the
    caller's head merge costs no copy)."""
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    if H % KV or k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"flash_attention_prefill: bad shapes q{tuple(q.shape)} k{tuple(k.shape)}")
    _check_head_dim(D, "flash_attention_prefill")
    code = _build.dtype_code(q, "flash_attention_prefill")
    if q.device.type == "cpu":
        return flash_attention_prefill_plain(
            q, k, v, q_pos, kv_pos, scale=scale,
            sliding_window=sliding_window, chunk_size=chunk_size,
        )
    for t in (q, k, v):
        _check_cuda_operand(t, "flash_attention_prefill", q.dtype)
    body = PREFILL_BODIES[prefill_body(q, k, v)]
    scale = D ** -0.5 if scale is None else scale
    q_start = q_pos[:, 0].to(device=q.device, dtype=torch.int32).contiguous()
    kv_start = kv_pos[:, 0].to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device).transpose(1, 2)
    lib = _build.library()
    err = lib.nxdi_flash_prefill(
        code, body, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        q_start.data_ptr(), kv_start.data_ptr(), B, H, KV, Sq, Sk, D,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        float(scale), _opt(sliding_window), _opt(chunk_size),
        _build.stream_ptr(q.device),
    )
    _build.check(err, "flash_attention_prefill")
    flash_attention_prefill.launches += 1
    return out


flash_attention_prefill.launches = 0


# ---------------------------------------------------------------------------
# Deferred-write (fused) decode
# ---------------------------------------------------------------------------


def flash_attention_decode_fused_plain(
    q, k_cache, v_cache, k_new, v_new, q_pos, kv_start=None, *,
    scale=None, sliding_window=None, chunk_size=None, kv_len=None, ring=None,
):
    """Plain PyTorch version of the fused decode kernel: all f32; cache slot
    j < kv_len holds position kv_start + j (on a ``ring``: its ring
    position, :func:`_ring_positions`) and is visible iff that position is
    STRICTLY before q_pos (plus window/chunk); the fresh row is always
    visible."""
    B, H, _, D = q.shape
    KV, Sk = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    W = Sk if kv_len is None else min(int(kv_len), Sk)
    scale = D ** -0.5 if scale is None else scale
    if ring is not None:
        _check_ring("flash_attention_decode_fused", ring, W)
        kv_positions = _ring_positions(q_pos[:, 0], ring)
    else:
        if kv_start is None:
            kv_start = torch.zeros((B,), dtype=torch.long, device=q.device)
        kv_positions = _affine(kv_start, W)
    mask1 = _visible(kv_positions, q_pos[:, :1].long(), True,
                     sliding_window, chunk_size)[:, None, None]  # (B,1,1,1,W)
    qg = q.reshape(B, KV, G, 1, D).float()
    s1 = torch.einsum("bkgqd,bksd->bkgqs", qg, k_cache[:, :, :W].float()) * scale
    s2 = torch.einsum("bkgqd,bksd->bkgqs", qg, k_new.float()) * scale
    s1 = torch.where(mask1, s1, torch.full_like(s1, NEG_INF))
    m = torch.maximum(s1.amax(dim=-1, keepdim=True), s2)
    p1 = torch.where(mask1, torch.exp(s1 - m), torch.zeros_like(s1))
    p2 = torch.exp(s2 - m)
    l = (p1.sum(dim=-1, keepdim=True) + p2).clamp_min(1e-20)
    acc = torch.einsum("bkgqs,bksd->bkgqd", p1, v_cache[:, :, :W].float()) + torch.einsum(
        "bkgqs,bksd->bkgqd", p2, v_new.float()
    )
    return (acc / l).to(q.dtype).reshape(B, H, 1, D)


def _decode_fused(q, k_cache, v_cache, k_new, v_new, q_pos, kv_start, *,
                  scale, sliding_window, chunk_size, kv_len, lines=None, ring=None):
    B, H, Sq, D = q.shape
    KV, Sk = k_cache.shape[1], k_cache.shape[2]
    if lines is None and k_cache.shape[0] != B:
        raise ValueError(f"flash_attention_decode_fused: cache batch {k_cache.shape[0]} != {B} "
                         "rows and no cache lines given")
    if Sq != 1 or H % KV or k_new.shape != (B, KV, 1, D) or v_new.shape != k_new.shape:
        raise ValueError(
            f"flash_attention_decode_fused: bad shapes q{tuple(q.shape)} "
            f"cache{tuple(k_cache.shape)} new{tuple(k_new.shape)}"
        )
    W = Sk if kv_len is None else min(int(kv_len), Sk)
    name = "flash_attention_decode_fused"
    _check_head_dim(D, name)
    _check_ring(name, ring, W)
    code = _build.dtype_code(q, name)
    if q.device.type == "cpu":
        if lines is not None:  # the JAX package's gather of each row's line (clipped)
            sel = lines.reshape(B).long().clamp(0, k_cache.shape[0] - 1)
            k_cache, v_cache = k_cache[sel], v_cache[sel]
        return flash_attention_decode_fused_plain(
            q, k_cache, v_cache, k_new, v_new, q_pos, kv_start, scale=scale,
            sliding_window=sliding_window, chunk_size=chunk_size, kv_len=W, ring=ring,
        )
    if k_new.stride() != v_new.stride():
        # the kernel reads both fresh rows through one pair of strides: under
        # fused_qkv the roped k is a new tensor while v is still a view of the
        # fused projection's output (a (B, KV, 1, D) copy each)
        k_new, v_new = k_new.contiguous(), v_new.contiguous()
    for t in (q, k_cache, v_cache, k_new, v_new):
        _check_cuda_operand(t, name, q.dtype)
    if k_cache.stride() != v_cache.stride():
        raise ValueError(f"{name}: k and v caches must share strides")
    scale = D ** -0.5 if scale is None else scale
    qp = q_pos[:, 0].to(device=q.device, dtype=torch.int32).contiguous()
    ks = (None if kv_start is None or ring is not None
          else kv_start.to(device=q.device, dtype=torch.int32).contiguous())
    ln = (None if lines is None
          else lines.reshape(B).to(device=q.device, dtype=torch.int32).contiguous())
    out = torch.empty((B, 1, H, D), dtype=q.dtype, device=q.device).transpose(1, 2)
    chunk, n_chunks, ws = _decode_split(B, H, KV, D, W, q.device)
    lib = _build.library()
    err = lib.nxdi_flash_decode_fused(
        code, q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        k_new.data_ptr(), v_new.data_ptr(), out.data_ptr(), qp.data_ptr(),
        None if ks is None else ks.data_ptr(), None if ln is None else ln.data_ptr(),
        k_cache.shape[0], B, H, KV, D, W,
        q.stride(0), q.stride(1), *k_cache.stride()[:3], k_new.stride(0), k_new.stride(1),
        out.stride(0), out.stride(1), float(scale), _opt(sliding_window), _opt(chunk_size),
        _opt(ring), chunk, n_chunks, None if ws is None else ws.data_ptr(),
        _build.stream_ptr(q.device),
    )
    _build.check(err, name)
    flash_attention_decode_fused.launches += 1
    return out


def flash_attention_decode_fused(
    q: torch.Tensor,  # (B, H, 1, D)
    k_cache: torch.Tensor,  # (B, KV, Sk, D) — OLD cache (this step's slot stale)
    v_cache: torch.Tensor,
    k_new: torch.Tensor,  # (B, KV, 1, D) — this step's fresh row
    v_new: torch.Tensor,
    q_pos: torch.Tensor,  # (B, 1) decode position == write slot
    kv_pos: torch.Tensor,  # (B, Sk) — affine per row (unread on a ring)
    *,
    scale: Optional[float] = None,
    sliding_window: Optional[int] = None,
    chunk_size: Optional[int] = None,
    kv_len: Optional[int] = None,
    ring: Optional[int] = None,  # the cache is a ring of this many slots
) -> torch.Tensor:
    """Deferred-write decode attention: old cache (strict causal) + fresh row."""
    return _decode_fused(
        q, k_cache, v_cache, k_new, v_new, q_pos, kv_pos[:, 0], scale=scale,
        sliding_window=sliding_window, chunk_size=chunk_size, kv_len=kv_len, ring=ring,
    )


flash_attention_decode_fused.launches = 0


def flash_attention_decode_fused_stacked(
    q: torch.Tensor,  # (B, H, 1, D)
    k_cache_s: torch.Tensor,  # (L, B, KV, Sk, D) — the whole OLD stack
    v_cache_s: torch.Tensor,
    k_new: torch.Tensor,  # (B, KV, 1, D)
    v_new: torch.Tensor,
    q_pos: torch.Tensor,  # (B, 1)
    layer_idx: int,
    *,
    scale: Optional[float] = None,
    sliding_window: Optional[int] = None,
    chunk_size: Optional[int] = None,
    kv_len: Optional[int] = None,
    lines: Optional[torch.Tensor] = None,  # (B,) cache line of each row
    ring: Optional[int] = None,  # the stack is a ring of this many slots
) -> torch.Tensor:
    """The stacked entry: reads layer ``layer_idx`` of the (L, B_cache, KV, S,
    D) cache (contiguous layout: slot j is position j; a ``ring``: the
    window-sized stack of ``WindowKVLayout``), row b from line ``lines[b]``
    when given (continuous batching; the cache may then hold more lines
    than rows). Launches the same kernel as
    :func:`flash_attention_decode_fused` and counts there."""
    li = int(layer_idx)
    return _decode_fused(
        q, k_cache_s[li], v_cache_s[li], k_new, v_new, q_pos, None, scale=scale,
        sliding_window=sliding_window, chunk_size=chunk_size, kv_len=kv_len, lines=lines,
        ring=ring,
    )


# ---------------------------------------------------------------------------
# Decode over a window that already holds this step's row
# ---------------------------------------------------------------------------


def flash_attention_decode_plain(
    q, k, v, q_pos, kv_pos, *, scale=None, sliding_window=None, chunk_size=None, ring=None
):
    """Plain PyTorch version of the window-decode kernel: window slot j holds
    position kv_pos[b, 0] + j (on a ``ring``: its ring position,
    :func:`_ring_positions`) and is visible iff that position is at or
    before q_pos (inclusive: the slot at q_pos holds this step's row), plus
    the window/chunk masks."""
    D, Sk = q.shape[3], k.shape[2]
    scale = D ** -0.5 if scale is None else scale
    _check_ring("flash_attention_decode", ring, Sk)
    kv_positions = (_affine(kv_pos[:, 0], Sk) if ring is None
                    else _ring_positions(q_pos[:, 0], ring))
    mask = _visible(kv_positions, q_pos[:, :1].long(), False, sliding_window, chunk_size)
    return _plain_attention(q, k, v, mask, scale)


def _check_decode_shapes(name, q, k, v):
    B, H, Sq, D = q.shape
    KV = k.shape[1]
    if Sq != 1 or H % KV or k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"{name}: bad shapes q{tuple(q.shape)} k{tuple(k.shape)}")
    _check_head_dim(D, name)


def flash_attention_decode(
    q: torch.Tensor,  # (B, H, 1, D)
    k: torch.Tensor,  # (B, KV, Sk, D) — window holding this step's row
    v: torch.Tensor,
    q_pos: torch.Tensor,  # (B, 1)
    kv_pos: torch.Tensor,  # (B, Sk) — affine per row (only [:, 0] is read; unread on a ring)
    *,
    scale: Optional[float] = None,
    sliding_window: Optional[int] = None,
    chunk_size: Optional[int] = None,
    ring: Optional[int] = None,  # the window is a ring of this many slots
) -> torch.Tensor:
    """Single-position decode over a contiguous window (inclusive causal
    mask), or over a ring. The window may be a strided view (the paged
    gather's transpose); k and v must share strides."""
    name = "flash_attention_decode"
    _check_decode_shapes(name, q, k, v)
    B, H, _, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    code = _build.dtype_code(q, name)
    if q.device.type == "cpu":
        return flash_attention_decode_plain(
            q, k, v, q_pos, kv_pos, scale=scale,
            sliding_window=sliding_window, chunk_size=chunk_size, ring=ring,
        )
    _check_ring(name, ring, Sk)
    for t in (q, k, v):
        _check_cuda_operand(t, name, q.dtype)
    if k.stride() != v.stride():
        raise ValueError(f"{name}: k and v must share strides")
    scale = D ** -0.5 if scale is None else scale
    qp = q_pos[:, 0].to(device=q.device, dtype=torch.int32).contiguous()
    ks = (None if ring is not None
          else kv_pos[:, 0].to(device=q.device, dtype=torch.int32).contiguous())
    out = torch.empty((B, 1, H, D), dtype=q.dtype, device=q.device).transpose(1, 2)
    chunk, n_chunks, ws = _decode_split(B, H, KV, D, Sk, q.device)
    err = _build.library().nxdi_flash_decode_window(
        code, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), qp.data_ptr(),
        None if ks is None else ks.data_ptr(), B, H, KV, D, Sk, q.stride(0), q.stride(1),
        *k.stride()[:3], out.stride(0), out.stride(1), float(scale), _opt(sliding_window),
        _opt(chunk_size), _opt(ring), chunk, n_chunks, None if ws is None else ws.data_ptr(),
        _build.stream_ptr(q.device),
    )
    _build.check(err, name)
    flash_attention_decode.launches += 1
    return out


flash_attention_decode.launches = 0


# ---------------------------------------------------------------------------
# Paged (block-table) attention: prefill chunks and decode
# ---------------------------------------------------------------------------


def gather_pages(cache_l, block_table, block_size):
    """(total_slots, KV, D) pool layer -> (B, KV, NB * block_size, D) rows in
    logical token order through (B, NB) tables, and the (B, NB * block_size)
    mask of positions that are not holes (hole rows read slot 0)."""
    bt = block_table.to(cache_l.device).long()
    B = bt.shape[0]
    offs = torch.arange(block_size, device=bt.device)
    slots = (bt[:, :, None] * block_size + offs).reshape(B, -1).clamp(0, cache_l.shape[0] - 1)
    live = (bt >= 0)[:, :, None].expand(B, bt.shape[1], block_size).reshape(B, -1)
    if cache_l.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):  # gathered as bytes
        rows = cache_l.view(torch.uint8)[slots].view(cache_l.dtype)
    else:
        rows = cache_l[slots]
    return rows.transpose(1, 2), live


def paged_attention_plain(q, k_cache, v_cache, block_table, q_pos, *, block_size, scale=None,
                          k_scale=1.0, v_scale=1.0):
    """Plain PyTorch version of both paged kernels (decode: Sq == 1; prefill:
    a chunk): query row i of batch row b sits at position q_pos[b, 0] + i and
    sees the logical positions up to its own that are not holes; k_scale
    folds into the softmax scale, v_scale into the output."""
    Sq, D = q.shape[2], q.shape[3]
    kk, live = gather_pages(k_cache, block_table, block_size)
    vv, _ = gather_pages(v_cache, block_table, block_size)
    W = kk.shape[2]
    kv_pos = torch.arange(W, device=q.device)[None].expand(q.shape[0], W)
    mask = _visible(kv_pos, _affine(q_pos[:, 0].to(q.device), Sq), False, None, None)
    mask = mask & live[:, None, :]
    scale = (D ** -0.5 if scale is None else scale) * k_scale
    return _plain_attention(q, kk.to(q.dtype), vv.to(q.dtype), mask, scale, v_scale)


paged_attention_decode_plain = paged_attention_plain
paged_attention_prefill_plain = paged_attention_plain


def _check_paged(name, q, k_cache, v_cache, block_table, block_size):
    B, H, _, D = q.shape
    total_slots, KV = k_cache.shape[0], k_cache.shape[1]
    if (H % KV or k_cache.shape != v_cache.shape or k_cache.dim() != 3 or k_cache.shape[2] != D
            or block_table.dim() != 2 or block_table.shape[0] != B):
        raise ValueError(
            f"{name}: bad shapes q{tuple(q.shape)} pool{tuple(k_cache.shape)} "
            f"table{tuple(block_table.shape)}"
        )
    if block_size < 1 or total_slots % block_size:
        raise ValueError(f"{name}: {total_slots} pool slots are not whole blocks of {block_size}")
    _check_head_dim(D, name)


def _paged_launch(fn_name, decode, q, k_cache, v_cache, block_table, q_pos, block_size, scale,
                  k_scale, v_scale):
    B, H, Sq, D = q.shape
    KV = k_cache.shape[1]
    _check_cuda_operand(q, fn_name, q.dtype)
    _check_kv_store(fn_name, q, k_cache, v_cache)
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError(f"{fn_name}: the pool layers must be contiguous")
    scale = (D ** -0.5 if scale is None else scale) * k_scale
    bt = block_table.to(device=q.device, dtype=torch.int32).contiguous()
    qp = q_pos[:, 0].to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device).transpose(1, 2)
    common = (q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
              qp.data_ptr(), bt.data_ptr())
    code = _build.dtype_code(q, fn_name)
    kv_code = _build.store_code(k_cache, q, fn_name)
    if decode:
        NB = bt.shape[1]
        chunk, n_chunks, ws = _decode_split(B, H, KV, D, NB * block_size, q.device)
        err = _build.library().nxdi_paged_decode(
            code, kv_code, *common, B, H, KV, D, NB, block_size, q.stride(0), q.stride(1),
            out.stride(0), out.stride(1), float(scale), float(v_scale), chunk, n_chunks,
            None if ws is None else ws.data_ptr(), _build.stream_ptr(q.device),
        )
    else:
        body = PREFILL_BODIES[paged_prefill_body(q, k_cache, v_cache, block_size)]
        err = _build.library().nxdi_paged_prefill(
            code, kv_code, body, *common, B, H, KV, Sq, bt.shape[1], block_size, D,
            k_cache.shape[0], *q.stride()[:3], *out.stride()[:3], float(scale), float(v_scale),
            _build.stream_ptr(q.device),
        )
    _build.check(err, fn_name)
    return out


def paged_attention_decode(
    q: torch.Tensor,  # (B, H, 1, D)
    k_cache: torch.Tensor,  # (total_slots, KV, D) — one layer of the pool
    v_cache: torch.Tensor,
    block_table: torch.Tensor,  # (B, NB) int block ids in token order; <0 = hole
    q_pos: torch.Tensor,  # (B, 1) decode positions
    *,
    block_size: int,
    scale: Optional[float] = None,
    k_scale: float = 1.0,
    v_scale: float = 1.0,
) -> torch.Tensor:
    """Decode attention reading K/V through the block table (this step's
    row is already in the pool)."""
    name = "paged_attention_decode"
    if q.shape[2] != 1:
        raise ValueError(f"{name}: one query position per row, got {q.shape[2]}")
    _check_paged(name, q, k_cache, v_cache, block_table, block_size)
    _build.dtype_code(q, name)
    if q.device.type == "cpu":
        return paged_attention_decode_plain(
            q, k_cache, v_cache, block_table, q_pos, block_size=block_size, scale=scale,
            k_scale=k_scale, v_scale=v_scale,
        )
    out = _paged_launch(name, True, q, k_cache, v_cache, block_table, q_pos, block_size,
                        scale, k_scale, v_scale)
    paged_attention_decode.launches += 1
    return out


paged_attention_decode.launches = 0


def paged_attention_prefill(
    q: torch.Tensor,  # (B, H, Sq, D) — the chunk's queries
    k_cache: torch.Tensor,  # (total_slots, KV, D) — pool layer, chunk already written
    v_cache: torch.Tensor,
    block_table: torch.Tensor,  # (B, NB)
    q_pos: torch.Tensor,  # (B, Sq) — affine per row (only [:, 0] is read)
    *,
    block_size: int,
    scale: Optional[float] = None,
    k_scale: float = 1.0,
    v_scale: float = 1.0,
) -> torch.Tensor:
    """Chunked / prefix-cached prefill attention through the block table:
    causal over logical positions, the chunk's own K/V read from the pool.
    Returns (B, H, Sq, D) (a transposed view of a (B, Sq, H, D) buffer on
    the card)."""
    name = "paged_attention_prefill"
    _check_paged(name, q, k_cache, v_cache, block_table, block_size)
    _build.dtype_code(q, name)
    if q.device.type == "cpu":
        return paged_attention_prefill_plain(
            q, k_cache, v_cache, block_table, q_pos, block_size=block_size, scale=scale,
            k_scale=k_scale, v_scale=v_scale,
        )
    out = _paged_launch(name, False, q, k_cache, v_cache, block_table, q_pos, block_size,
                        scale, k_scale, v_scale)
    paged_attention_prefill.launches += 1
    return out


paged_attention_prefill.launches = 0
