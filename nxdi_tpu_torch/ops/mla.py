"""Multi-head Latent Attention (MLA), the DeepSeek lineage — the port of
``nxdi_tpu/ops/mla.py`` at one device.

The JAX package's design around a LATENT KV cache, step for step:

- the cache's ``k`` holds the ROTATED shared rope key (B, 1, S, qk_rope),
  its ``v`` the rms-normed compressed kv latent (B, 1, S, kv_lora): a
  position costs ``kv_lora + qk_rope`` values (576 for DeepSeek-V3) instead
  of ``heads * (qk_nope + qk_rope + v_dim)``;
- at attention time the latent is expanded through ``kv_b`` into per-head
  k_nope and value (the non-absorbed formulation, which equals HF's eager
  attention; the absorbed-matmul decode is a possible later kernel).

The fresh latent row and rope key go through ``layout.update`` before the
layer attends: on the contiguous cache that is the commit kernel
(``ops/kernels/kv_commit.py``), one launch a layer, since an MLA layer never
defers its write. The attention itself is plain PyTorch, as the JAX package
leaves it to XLA (q and k are ``qk_nope + qk_rope`` wide, v ``v_head_dim``,
and the cache holds latents, not per-head K/V), so the attention kernel
flags do not apply: the CPU ignores them (the JAX rule) and the card raises
(:func:`mla_kernel_gate`).

``rope_interleave`` checkpoints (DeepSeek stores rope channels interleaved)
are handled at conversion by :func:`deinterleave_rope_columns`, so the
runtime always rotates half. The JAX package's ``mla_param_specs`` and
``mla_shape_struct`` (sharding and ahead-of-time helpers) are not ported:
the port runs on one device and builds random weights from
:func:`mla_param_shapes`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from nxdi_tpu_torch.kvcache.kv_cache import DEFAULT_KV_LAYOUT
from nxdi_tpu_torch.ops import attention as attn_ops
from nxdi_tpu_torch.ops.norms import rms_norm
from nxdi_tpu_torch.ops.rope import apply_rotary_pos_emb

# the kernel flags an MLA layer cannot take: its attention and projections
# run plain (the JAX package's MLA attends in XLA)
MLA_KERNEL_FLAGS = ("attn_kernel_enabled", "attn_tkg_kernel_enabled",
                    "attn_block_tkg_kernel_enabled", "qkv_kernel_enabled")


@dataclass(frozen=True)
class MLAArch:
    num_heads: int
    q_lora_rank: Optional[int]
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int
    softmax_scale: float

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim


def mla_kernel_gate(arch, on_cuda: bool) -> None:
    """The kernel flags on an MLA model (``models/base._kernel_gate``'s
    rule): on the CPU the JAX rule holds, which ignores them; on the card an
    enabled attention or QKV kernel flag raises, naming "MLA attention" as
    the failed condition."""
    from nxdi_tpu_torch.models.base import _kernel_gate

    for flag in MLA_KERNEL_FLAGS:
        _kernel_gate(flag, getattr(arch, flag), on_cuda, [], ["MLA attention"],
                     ("MLA attention",))


def mla_attention_block(
    arch,  # DecoderArch with .mla set
    p_attn: Dict[str, Any],
    hidden: torch.Tensor,  # (B, S, hidden)
    cos: torch.Tensor,
    sin: torch.Tensor,
    k_cache_l: torch.Tensor,  # (B_cache, 1, S_max, qk_rope) rotated rope keys
    v_cache_l: torch.Tensor,  # (B_cache, 1, S_max, kv_lora) normed latents
    position_ids: torch.Tensor,
    cache_spec,
    attend_to_cache: bool,
    layout=DEFAULT_KV_LAYOUT,
    cache_inputs: Optional[Dict[str, torch.Tensor]] = None,
    kv_window: Optional[int] = None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """q (through ``q_proj``, or ``q_a`` -> rms norm -> ``q_b``) -> ``kv_a``
    split into the latent (rms-normed BEFORE caching) and the rope key ->
    rope on q's rope part and the shared key -> ``layout.update`` (in place)
    then ``layout.read`` -> the latent expanded through ``kv_b`` -> attention
    at the arch's softmax scale -> ``o_proj``. ``kv_window`` bounds the
    attended cache to the bucket's window after the write (the writes land
    in the whole line)."""
    from nxdi_tpu_torch.models.base import _linear

    mla_kernel_gate(arch, hidden.is_cuda)
    mla: MLAArch = arch.mla
    B, S, _ = hidden.shape
    H = mla.num_heads
    nope, rope_d, r = mla.qk_nope_head_dim, mla.qk_rope_head_dim, mla.kv_lora_rank
    aq, ac = arch.act_quant, arch.act_clamp

    # -- queries
    if mla.q_lora_rank is None:
        q = _linear(hidden, p_attn["q_proj"], aq, ac)
    else:
        qa = _linear(hidden, p_attn["q_a"], aq, ac)
        qa = rms_norm(qa, p_attn["q_a_norm"], arch.rms_norm_eps)
        q = _linear(qa, p_attn["q_b"], aq, ac)
    q = q.reshape(B, S, H, mla.qk_head_dim)
    q_nope, q_rot = q[..., :nope], q[..., nope:]

    # -- compressed kv + shared rope key
    ckv = _linear(hidden, p_attn["kv_a"], aq, ac)  # (B, S, r + rope_d)
    c, k_rot = ckv[..., :r], ckv[..., r:]
    c = rms_norm(c, p_attn["kv_a_norm"], arch.rms_norm_eps)  # normed BEFORE caching

    q_rot = q_rot.transpose(1, 2)  # (B, H, S, rope_d)
    k_rot = k_rot[:, None]  # (B, 1, S, rope_d)
    q_rot, k_rot = apply_rotary_pos_emb(q_rot, k_rot, cos, sin)

    # -- latent cache update (k <- rotated rope key, v <- normed latent)
    ci = dict(cache_inputs or {})
    ci["position_ids"] = position_ids
    if not attend_to_cache and S > 1:
        ci["prefill_from_zero"] = True
    layout.update(k_cache_l, v_cache_l, k_rot, c[:, None], ci, cache_spec)

    if attend_to_cache:
        kl, vl = k_cache_l, v_cache_l
        if kv_window is not None and kv_window < kl.shape[2]:
            kl, vl = kl[:, :, :kv_window], vl[:, :, :kv_window]
        k_rot_all, c_all, kv_pos = layout.read(kl, vl, ci, cache_spec)
    else:
        k_rot_all, c_all = k_rot, c[:, None]
        kv_pos = position_ids

    # -- expand the latent to per-head k_nope / value through kv_b
    W = c_all.shape[2]
    kb = _linear(c_all[:, 0], p_attn["kv_b"], aq, ac)  # (B, W, H * (nope + v))
    kb = kb.reshape(B, W, H, nope + mla.v_head_dim)
    k_nope = kb[..., :nope].transpose(1, 2)  # (B, H, W, nope)
    v = kb[..., nope:].transpose(1, 2)  # (B, H, W, v_dim)

    qq = torch.cat([q_nope.transpose(1, 2), q_rot], dim=-1)  # (B, H, S, qk)
    kk = torch.cat([k_nope, k_rot_all.expand(B, H, W, rope_d)], dim=-1)

    mask = attn_ops.causal_mask_from_positions(position_ids, kv_pos)
    ctx = attn_ops.grouped_attention(qq, kk, v, mask, scale=mla.softmax_scale)  # (B, H, S, v)

    ctx = ctx.transpose(1, 2).reshape(B, S, H * mla.v_head_dim)
    out = _linear(ctx, p_attn["o_proj"], aq, ac)
    return out, (k_cache_l, v_cache_l)


# ---------------------------------------------------------------------------
# Param layout and conversion helpers (used by the DeepSeek family module)
# ---------------------------------------------------------------------------


def mla_param_shapes(mla: MLAArch, hidden_size: int, num_layers: int) -> Dict[str, Any]:
    """Shapes of the layer-stacked MLA attention params (the JAX package's
    ``mla_shape_struct`` without its dtype)."""
    L, H, hs = num_layers, mla.num_heads, hidden_size
    shapes: Dict[str, Any] = {
        "kv_a": {"w": (L, hs, mla.kv_lora_rank + mla.qk_rope_head_dim)},
        "kv_a_norm": (L, mla.kv_lora_rank),
        "kv_b": {"w": (L, mla.kv_lora_rank, H * (mla.qk_nope_head_dim + mla.v_head_dim))},
        "o_proj": {"w": (L, H * mla.v_head_dim, hs)},
    }
    if mla.q_lora_rank is None:
        shapes["q_proj"] = {"w": (L, hs, H * mla.qk_head_dim)}
    else:
        shapes["q_a"] = {"w": (L, hs, mla.q_lora_rank)}
        shapes["q_a_norm"] = (L, mla.q_lora_rank)
        shapes["q_b"] = {"w": (L, mla.q_lora_rank, H * mla.qk_head_dim)}
    return shapes


def rope_deinterleave_perm(rope_d: int) -> np.ndarray:
    """The column order that turns interleaved rope channels [r0, i0, r1,
    i1, ...] into rotate-half [r0, r1, ..., i0, i1, ...]."""
    return np.concatenate([np.arange(0, rope_d, 2), np.arange(1, rope_d, 2)])


def deinterleave_rope_columns(w_t: torch.Tensor, head_dim: int, nope: int,
                              rope_d: int) -> torch.Tensor:
    """Permute the rope-dim output columns of a per-head projection weight
    (already transposed to (in, H * head_dim)) from interleaved to
    rotate-half layout (HF ``rope_interleave``, done once at conversion)."""
    fin, out = w_t.shape
    H = out // head_dim
    w = w_t.reshape(fin, H, head_dim)
    perm = torch.from_numpy(rope_deinterleave_perm(rope_d))
    w = torch.cat([w[..., :nope], w[..., nope:][..., perm]], dim=-1)
    return w.reshape(fin, out)
