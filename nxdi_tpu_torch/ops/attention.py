"""Attention ops — plain PyTorch (counterpart of ``nxdi_tpu/ops/attention.py``).

These are the references the CUDA attention kernels are held against, and
the ``cte_xla`` / ``tkg_two_part_xla`` strategies of ``models/base.py``.
GQA is computed grouped (Q reshaped to (B, KV, G, S, D)) against un-repeated
K/V; softmax in float32; masks derived from position ids.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -30000.0  # large-negative in bf16 range, as in the JAX package


def causal_mask_from_positions(q_pos, kv_pos, valid_kv=None):
    """(B, Sq, Skv) bool: key at kv_pos is visible to query at q_pos iff
    kv_pos <= q_pos."""
    mask = kv_pos[:, None, :] <= q_pos[:, :, None]
    if valid_kv is not None:
        mask = mask & valid_kv[:, None, :]
    return mask


def sliding_window_mask_from_positions(q_pos, kv_pos, window: int, valid_kv=None):
    mask = causal_mask_from_positions(q_pos, kv_pos, valid_kv)
    return mask & (kv_pos[:, None, :] > q_pos[:, :, None] - window)


def chunked_attention_mask_from_positions(q_pos, kv_pos, chunk_size: int, valid_kv=None):
    mask = causal_mask_from_positions(q_pos, kv_pos, valid_kv)
    same_chunk = (kv_pos[:, None, :] // chunk_size) == (q_pos[:, :, None] // chunk_size)
    return mask & same_chunk


def position_mask(q_pos, kv_pos, sliding_window, chunk_size, sliding_window_enabled=None,
                  chunk_enabled=None):
    """``sliding_window_enabled`` / ``chunk_enabled``: a 0-d bool tensor that
    turns the window or the chunk on or off for this layer (a per-layer flag
    of a mixed stack, read on the device without a host sync; Llama 4 chunks
    its rope layers only). The window wins over the chunk, as in the JAX
    package."""
    if sliding_window is not None:
        mask = sliding_window_mask_from_positions(q_pos, kv_pos, sliding_window)
        if sliding_window_enabled is not None:
            mask = torch.where(sliding_window_enabled, mask,
                               causal_mask_from_positions(q_pos, kv_pos))
        return mask
    if chunk_size is not None:
        mask = chunked_attention_mask_from_positions(q_pos, kv_pos, chunk_size)
        if chunk_enabled is not None:
            mask = torch.where(chunk_enabled, mask, causal_mask_from_positions(q_pos, kv_pos))
        return mask
    return causal_mask_from_positions(q_pos, kv_pos)


def _softmax_with_sink(scores, sink):
    """Softmax over the last axis; with ``sink`` (H,) a learned per-head
    logit joins each row as one more column whose probability mass is then
    dropped (gpt-oss's attention sinks). ``scores`` is (B, KV, G, Sq, S)."""
    if sink is None:
        return torch.softmax(scores, dim=-1)
    B, KV, G, Sq, _ = scores.shape
    col = sink.float().reshape(1, KV, G, 1, 1).expand(B, KV, G, Sq, 1)
    return torch.softmax(torch.cat([scores, col], dim=-1), dim=-1)[..., :-1]


def _softcap(scores, logit_softcap: Optional[float]):
    """Gemma 2's soft cap ``cap * tanh(s / cap)`` on scaled scores (None: as
    they are), applied before the mask and the sink as in the JAX package."""
    if logit_softcap is None:
        return scores
    return logit_softcap * torch.tanh(scores / logit_softcap)


def grouped_attention(q, k, v, mask, scale: Optional[float] = None, sink=None,
                      logit_softcap: Optional[float] = None):
    """q (B, H, Sq, D), k/v (B, KV, Skv, D), mask (B, Sq, Skv) -> (B, H, Sq, D).
    ``sink`` (H,): learned attention-sink logits (:func:`_softmax_with_sink`);
    ``logit_softcap``: :func:`_softcap` on the scaled scores."""
    B, H, Sq, D = q.shape
    KV = k.shape[1]
    G = H // KV
    if scale is None:
        scale = D ** -0.5
    qg = q.reshape(B, KV, G, Sq, D)
    scores = _softcap(torch.einsum("bkgqd,bksd->bkgqs", qg.float(), k.float()) * scale,
                      logit_softcap)
    scores = torch.where(mask[:, None, None], scores, torch.full_like(scores, NEG_INF))
    weights = _softmax_with_sink(scores, sink).to(v.dtype)
    out = torch.einsum("bkgqs,bksd->bkgqd", weights, v)
    return out.reshape(B, H, Sq, v.shape[-1])


def attention_with_positions(
    q, k, v, q_pos, kv_pos, *, scale=None,
    sliding_window: Optional[int] = None, chunk_size: Optional[int] = None,
    sliding_window_enabled=None, chunk_enabled=None, sink=None,
    logit_softcap: Optional[float] = None,
):
    """Attention with the mask derived from positions (prefill and decode)."""
    mask = position_mask(q_pos, kv_pos, sliding_window, chunk_size, sliding_window_enabled,
                         chunk_enabled)
    return grouped_attention(q, k, v, mask, scale=scale, sink=sink, logit_softcap=logit_softcap)


def attention_two_part(
    q,  # (B, H, Sq, D)
    kk, vv,  # cache segment (B, KV, W, D)
    k2, v2,  # fresh segment (B, KV, S2, D)
    q_pos, kv_pos, kv_pos2, *,
    scale=None, sliding_window=None, chunk_size=None, sliding_window_enabled=None,
    chunk_enabled=None, sink=None, logit_softcap: Optional[float] = None,
):
    """Attention over [cache, fresh] without concatenating K/V: the scores are
    concatenated for one softmax and the two weighted sums add. The
    deferred-write decode reference (models/base.py)."""
    B, H, Sq, D = q.shape
    KV = kk.shape[1]
    G = H // KV
    W = kk.shape[2]
    if scale is None:
        scale = D ** -0.5
    qg = q.reshape(B, KV, G, Sq, D).float()
    s1 = torch.einsum("bkgqd,bksd->bkgqs", qg, kk.float())
    s2 = torch.einsum("bkgqd,bksd->bkgqs", qg, k2.float())
    s = _softcap(torch.cat([s1, s2], dim=-1) * scale, logit_softcap)
    m1 = position_mask(q_pos, kv_pos, sliding_window, chunk_size, sliding_window_enabled,
                       chunk_enabled)
    m2 = position_mask(q_pos, kv_pos2, sliding_window, chunk_size, sliding_window_enabled,
                       chunk_enabled)
    mask = torch.cat([m1, m2], dim=-1)
    s = torch.where(mask[:, None, None], s, torch.full_like(s, NEG_INF))
    weights = _softmax_with_sink(s, sink)
    w1 = weights[..., :W].to(vv.dtype)
    w2 = weights[..., W:].to(v2.dtype)
    out = torch.einsum("bkgqs,bksd->bkgqd", w1, vv) + torch.einsum(
        "bkgqs,bksd->bkgqd", w2, v2
    )
    return out.reshape(B, H, Sq, vv.shape[-1])
