"""KV-cache commit: CUDA kernel (``csrc/kv_commit.cu``) and its plain
PyTorch version.

Replaces ``nxdi_tpu/ops/kernels/kv_commit.py::kv_commit_rows`` (Pallas,
``pl.pallas_call`` at kv_commit.py:170): the deferred-write decode step ends
with ONE commit of every layer's fresh K/V rows into the layer-stacked cache.
Row t of batch line b lands at slot ``slots[b, t]`` of cache line
``seq_ids[b]`` (or ``b``); an out-of-range slot or line drops the row.

Both versions update the caches IN PLACE (the JAX function returns new
arrays; here the caller's cache tensors are the result). Unlike the TPU
kernel, T > 1 rows per line are allowed: each row is written directly, so
there is no shared read-modify-write window to race on.

The kernel moves bytes, so one instantiation serves every store: bf16, f32
and the one-byte stores of a quantized cache (``float8_e4m3fn``,
``float8_e5m2``, ``int8``), whose rows arrive already quantized — divided by
their scale, saturated and cast by the layout, as the JAX package's
``commit_rows`` hands them to its kernel.

The wrapper takes the plain version for CPU tensors only; on CUDA tensors
it launches the kernel or raises, and counts the launch in
``kv_commit_rows.launches``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from nxdi_tpu_torch.ops.kernels import _build

# the caches the commit takes: the compute dtypes and the one-byte stores
COMMIT_DTYPES = (torch.float32, torch.bfloat16, *_build.STORE_CODES)


def commit_rows_supported(k_cache_shape, v_cache_shape, k_rows_shape, v_rows_shape) -> bool:
    """caches (L, B_cache, KV, S, D/Dv); rows (L, B, KV, T, D/Dv)."""
    shapes = (k_cache_shape, v_cache_shape, k_rows_shape, v_rows_shape)
    if any(len(s) != 5 for s in shapes):
        return False
    L, B_cache, KV, S, D = k_cache_shape
    Dv = v_cache_shape[4]
    if tuple(v_cache_shape) != (L, B_cache, KV, S, Dv):
        return False
    if k_rows_shape[0] != L or k_rows_shape[2] != KV or k_rows_shape[4] != D:
        return False
    return tuple(v_rows_shape) == tuple(k_rows_shape[:4]) + (Dv,)


def _lines(seq_ids, B, device):
    if seq_ids is None:
        return torch.arange(B, dtype=torch.long, device=device)
    return seq_ids.reshape(B).long()


def kv_commit_rows_plain(k_cache, v_cache, k_rows, v_rows, slots, seq_ids=None):
    """Plain PyTorch version (in place)."""
    S, B_cache = k_cache.shape[3], k_cache.shape[1]
    B, T = slots.shape
    lines = _lines(seq_ids, B, k_cache.device)
    sl = slots.long()
    valid = (sl >= 0) & (sl < S) & ((lines >= 0) & (lines < B_cache))[:, None]
    bi, ti = torch.nonzero(valid, as_tuple=True)
    li, si = lines[bi], sl[bi, ti]
    for cache, rows in ((k_cache, k_rows), (v_cache, v_rows)):
        vals = rows[:, bi, :, ti].to(cache.dtype)
        if cache.element_size() == 1:  # one-byte stores move as bytes
            cache.view(torch.uint8)[:, li, :, si] = vals.view(torch.uint8)
        else:
            cache[:, li, :, si] = vals
    return k_cache, v_cache


def kv_commit_rows(
    k_cache: torch.Tensor,  # (L, B_cache, KV, S, D) — updated in place
    v_cache: torch.Tensor,  # (L, B_cache, KV, S, Dv)
    k_rows: torch.Tensor,  # (L, B, KV, T, D) in the cache dtype
    v_rows: torch.Tensor,  # (L, B, KV, T, Dv)
    slots: torch.Tensor,  # (B, T) int target slots; out of [0, S) drops
    seq_ids: Optional[torch.Tensor] = None,  # (B,) cache-line routing
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Commit fresh K/V rows into the stacked cache in place; returns the
    (same) cache tensors."""
    if not commit_rows_supported(k_cache.shape, v_cache.shape, k_rows.shape, v_rows.shape):
        raise ValueError(
            f"kv_commit_rows: unsupported shapes cache{tuple(k_cache.shape)} "
            f"rows{tuple(k_rows.shape)}"
        )
    L, B_cache, KV, S, D = k_cache.shape
    B, T = k_rows.shape[1], k_rows.shape[3]
    if tuple(slots.shape) != (B, T):
        raise ValueError(f"kv_commit_rows: slots {tuple(slots.shape)} != (B, T) = {(B, T)}")
    name = "kv_commit_rows"
    if k_cache.dtype not in COMMIT_DTYPES:
        raise TypeError(f"{name}: cache dtype {k_cache.dtype} is not supported "
                        f"({', '.join(str(d) for d in COMMIT_DTYPES)})")
    if k_cache.device.type == "cpu":
        return kv_commit_rows_plain(k_cache, v_cache, k_rows, v_rows, slots, seq_ids)
    tensors = (k_cache, v_cache, k_rows, v_rows)
    if any(t.device != k_cache.device or t.dtype != k_cache.dtype for t in tensors):
        raise ValueError(f"{name}: caches and rows must share one CUDA device and dtype")
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError(f"{name}: caches must be contiguous")
    es = k_cache.element_size()
    if (D * es) % 16 or (v_cache.shape[4] * es) % 16:
        raise ValueError(f"{name}: row widths must be a multiple of 16 bytes")
    k_rows, v_rows = k_rows.contiguous(), v_rows.contiguous()
    slots32 = slots.to(device=k_cache.device, dtype=torch.int32).contiguous()
    lines32 = (
        None if seq_ids is None
        else seq_ids.to(device=k_cache.device, dtype=torch.int32).contiguous()
    )
    lib = _build.library()
    err = lib.nxdi_kv_commit_rows(
        k_cache.data_ptr(), v_cache.data_ptr(), k_rows.data_ptr(), v_rows.data_ptr(),
        slots32.data_ptr(), None if lines32 is None else lines32.data_ptr(),
        L, B, B_cache, KV, S, T, D * es, v_cache.shape[4] * es,
        _build.stream_ptr(k_cache.device),
    )
    _build.check(err, name)
    kv_commit_rows.launches += 1
    return k_cache, v_cache


kv_commit_rows.launches = 0


def empty_launch(blocks: int, threads: int, device) -> None:
    """Launch a kernel that does nothing, ``blocks`` x ``threads``, on the
    card: the floor under :func:`kv_commit_rows`' device time at its launch
    shape (L * B blocks of 128 threads). A measuring aid; it counts nothing."""
    device = torch.device(device)
    _build.check(_build.library().nxdi_empty_launch(int(blocks), int(threads),
                                                     _build.stream_ptr(device)), "empty_launch")
