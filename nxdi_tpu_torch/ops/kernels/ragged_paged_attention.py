"""Ragged paged attention: CUDA kernel (the ragged addressing mode of the
prefill kernels in ``csrc/prefill_kernel.cuh``, behind
``csrc/ragged_paged.cu``) and its plain PyTorch version.

Replaces ``nxdi_tpu/ops/kernels/ragged_paged_attention.py::
ragged_paged_attention`` (Pallas, ``pl.pallas_call`` at
ragged_paged_attention.py:199): ONE attention launch for the serving
engine's mixed step, prefill chunks and decode tokens packed into one token
stream (batch 1). Token t belongs to row ``row_ids[t]`` at position
``q_pos[t]`` and attends that row's blocks at logical positions up to its
own; holes (negative table entries) are skipped; ``k_scale`` folds into the
softmax scale and ``v_scale`` into the output; padding tokens (row -1) and
tokens with no visible key output exactly 0.

The wrapper takes its plain version for tensors on the CPU only; for a CUDA
tensor it launches the kernel or raises, and counts the launch in
``ragged_paged_attention.launches``. Tags and tables may arrive on the host
(int32 numpy or CPU tensors); they are moved to the operands' device here.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from nxdi_tpu_torch.ops.kernels import _build
from nxdi_tpu_torch.ops.kernels.flash_attention import (
    _check_cuda_operand,
    _check_head_dim,
    _plain_attention,
    gather_pages,
)

# rows one launch may hold: the kernel keeps a 64-bit mask of the rows
# present in each q tile
MAX_ROWS = 64


def ragged_paged_kernel_supported(q_shape, cache_shape, block_size) -> bool:
    """The JAX package's rule in interpret mode: the packed layout (B == 1),
    whole heads per kv head, whole blocks."""
    B, H = q_shape[0], q_shape[1]
    total_slots, KV = cache_shape[0], cache_shape[1]
    return B == 1 and H % KV == 0 and total_slots % block_size == 0


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
) -> torch.Tensor:
    """Causal attention of a ragged mixed batch in one launch. Returns
    (1, H, T, D) in q's dtype (a transposed view of a (1, T, H, D) buffer on
    the card, so the caller's head merge costs no copy)."""
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
    if R > MAX_ROWS:
        raise ValueError(f"{name}: {R} rows exceed the kernel's {MAX_ROWS}")
    for t in (q, k_cache, v_cache):
        _check_cuda_operand(t, name, q.dtype)
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError(f"{name}: the pool layers must be contiguous")
    scale = (D ** -0.5 if scale is None else scale) * k_scale
    dev = q.device
    bt = _as_tensor(block_tables, dev).to(torch.int32).contiguous()
    rid = _as_tensor(row_ids, dev).to(torch.int32).contiguous()
    qp = _as_tensor(q_pos, dev).to(torch.int32).contiguous()
    out = torch.empty((1, T, H, D), dtype=q.dtype, device=dev).transpose(1, 2)
    err = _build.library().nxdi_ragged_paged(
        code, q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
        rid.data_ptr(), qp.data_ptr(), bt.data_ptr(), H, KV, T, R, NB, block_size, D,
        q.stride(1), q.stride(2), out.stride(1), out.stride(2), float(scale), float(v_scale),
        _build.stream_ptr(dev),
    )
    _build.check(err, name)
    ragged_paged_attention.launches += 1
    return out


ragged_paged_attention.launches = 0
