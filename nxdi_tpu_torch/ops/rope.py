"""Rotary position embeddings (counterpart of ``nxdi_tpu/ops/rope.py``).

HF llama's rotate-half convention (and the adjacent-pair GPT-J layout,
:func:`apply_rotary_pos_emb_interleaved`), plain RoPE, llama3, YaRN and
LongRoPE frequency scaling, and Gemma-3's local/global pair. The frequency tables are numpy (host-side, computed once); cos/sin
are built from position ids on the fly in float32. YaRN's attention factor
scales cos/sin (the models read it as ``DecoderArch.rope_mscale``).
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch


def default_inv_freq(head_dim: int, rope_theta: float) -> np.ndarray:
    return 1.0 / (rope_theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))


def llama3_scaled_inv_freq(
    head_dim: int,
    rope_theta: float,
    factor: float = 8.0,
    low_freq_factor: float = 1.0,
    high_freq_factor: float = 4.0,
    original_max_position: int = 8192,
) -> np.ndarray:
    """Llama-3.1 rope scaling (matches HF ``_compute_llama3_parameters``)."""
    inv_freq = default_inv_freq(head_dim, rope_theta)
    low_freq_wavelen = original_max_position / low_freq_factor
    high_freq_wavelen = original_max_position / high_freq_factor
    wavelen = 2 * np.pi / inv_freq
    scaled = np.where(wavelen > low_freq_wavelen, inv_freq / factor, inv_freq)
    # equal factors (Llama 4: 1 and 1) leave no medium band: the division by
    # zero only fills entries that is_medium drops
    with np.errstate(divide="ignore", invalid="ignore"):
        smooth = (original_max_position / wavelen - low_freq_factor) / (
            high_freq_factor - low_freq_factor
        )
        smoothed = (1 - smooth) * scaled / factor + smooth * scaled
    is_medium = (wavelen >= high_freq_wavelen) & (wavelen <= low_freq_wavelen)
    return np.where(is_medium, smoothed, scaled)


def yarn_get_mscale(scale: float, m: float = 1.0) -> float:
    """YaRN's magnitude factor for a context ``scale`` (DeepSeek's
    ``yarn_get_mscale``)."""
    if scale <= 1:
        return 1.0
    return 0.1 * m * math.log(scale) + 1.0


def yarn_inv_freq(
    head_dim: int,
    rope_theta: float,
    rope_scaling: dict,
    max_position_embeddings: int = 4096,
):
    """YaRN frequency interpolation (matches HF ``_compute_yarn_parameters``).
    Returns (inv_freq float32, attention_factor): the factor scales cos/sin."""
    factor = rope_scaling.get("factor", 1.0)
    dim = head_dim
    orig = rope_scaling.get("original_max_position_embeddings") or max_position_embeddings
    mscale = rope_scaling.get("mscale")
    mscale_all_dim = rope_scaling.get("mscale_all_dim")

    attention_factor = rope_scaling.get("attention_factor")
    if attention_factor is None:
        if mscale and mscale_all_dim:
            attention_factor = float(yarn_get_mscale(factor, mscale)
                                     / yarn_get_mscale(factor, mscale_all_dim))
        else:
            attention_factor = yarn_get_mscale(factor)

    beta_fast = rope_scaling.get("beta_fast") or 32
    beta_slow = rope_scaling.get("beta_slow") or 1

    def correction_dim(num_rotations):
        return (dim * math.log(orig / (num_rotations * 2 * math.pi))) / (2 * math.log(rope_theta))

    low = correction_dim(beta_fast)
    high = correction_dim(beta_slow)
    if rope_scaling.get("truncate", True):
        low = math.floor(low)
        high = math.ceil(high)
    low, high = max(low, 0), min(high, dim - 1)
    if low == high:
        high += 0.001

    pos_freqs = rope_theta ** (np.arange(0, dim, 2, dtype=np.float64) / dim)
    extrap = 1.0 / pos_freqs
    interp = 1.0 / (factor * pos_freqs)
    ramp = np.clip((np.arange(dim // 2, dtype=np.float64) - low) / (high - low), 0, 1)
    extrap_factor = 1 - ramp
    inv_freq = interp * (1 - extrap_factor) + extrap * extrap_factor
    return inv_freq.astype(np.float32), float(attention_factor)


def longrope_inv_freq(
    head_dim: int,
    rope_theta: float,
    rope_scaling: dict,
    max_position_embeddings: int,
    original_max_position_embeddings: int,
):
    """LongRoPE (the Phi-3 128k lineage; HF ``_compute_longrope_parameters``):
    per-channel rescale factors, ``short_factor`` within the pretrained
    window and ``long_factor`` beyond it, and the cos/sin scale
    ``sqrt(1 + ln(factor) / ln(original_max))`` with factor = max_position /
    original_max. Returns (the STACKED (2, D/2) float32 table [short, long],
    attention_factor); a forward picks the set from its true last position
    (``models/base.py``)."""
    short = np.asarray(rope_scaling["short_factor"], np.float32)
    long = np.asarray(rope_scaling["long_factor"], np.float32)
    base = rope_theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim)
    factor = rope_scaling.get("factor")
    if original_max_position_embeddings:
        factor = max_position_embeddings / original_max_position_embeddings
    attention_factor = rope_scaling.get("attention_factor")
    if attention_factor is None:
        if factor is None or factor <= 1.0:
            attention_factor = 1.0
        else:
            attention_factor = math.sqrt(
                1 + math.log(factor) / math.log(original_max_position_embeddings))
    return np.stack([1.0 / (short * base), 1.0 / (long * base)]), float(attention_factor)


def rope_type_of(rope_scaling) -> str:
    return rope_scaling.get("rope_type", rope_scaling.get("type", "default"))


def inv_freq_from_hf_config(
    head_dim: int, rope_theta: float, rope_scaling=None, max_position_embeddings: int = 4096
) -> np.ndarray:
    """Frequencies for the rope types one table serves (default, llama3,
    linear, yarn, and ``dynamic`` as the JAX package takes it: the default
    table, with a warning that positions past the original context rotate
    wrongly); any other type raises rather than rotating long contexts
    wrongly. LongRoPE needs two tables and the per-forward choice between
    them: the Phi-3 families build it (``models/phi3``: ``build_inv_freq``
    through :func:`longrope_inv_freq`)."""
    if rope_scaling is None:
        return default_inv_freq(head_dim, rope_theta)
    rope_type = rope_type_of(rope_scaling)
    if rope_type == "llama3":
        return llama3_scaled_inv_freq(
            head_dim,
            rope_theta,
            factor=rope_scaling.get("factor", 8.0),
            low_freq_factor=rope_scaling.get("low_freq_factor", 1.0),
            high_freq_factor=rope_scaling.get("high_freq_factor", 4.0),
            original_max_position=rope_scaling.get("original_max_position_embeddings", 8192),
        )
    if rope_type == "linear":
        return default_inv_freq(head_dim, rope_theta) / rope_scaling.get("factor", 1.0)
    if rope_type == "default":
        return default_inv_freq(head_dim, rope_theta)
    if rope_type == "yarn":
        return yarn_inv_freq(head_dim, rope_theta, rope_scaling, max_position_embeddings)[0]
    if rope_type == "dynamic":
        # dynamic NTK equals the default frequencies inside the original
        # context window; past it the runtime would have to rescale
        warnings.warn(
            "rope_type 'dynamic' treated as default frequencies; positions "
            "beyond original_max_position_embeddings will rotate incorrectly"
        )
        return default_inv_freq(head_dim, rope_theta)
    if rope_type == "longrope":
        raise ValueError(
            "rope type 'longrope' takes two frequency sets chosen per forward: build it "
            "with the phi3 / phimoe family (models/phi3/modeling_phi3.build_inv_freq)")
    raise ValueError(f"Unsupported rope scaling type in this port: {rope_type}")


def rope_cos_sin(position_ids: torch.Tensor, inv_freq, dtype=torch.float32):
    """(B, S) int positions -> cos/sin of shape (B, S, head_dim). ``inv_freq``
    is a numpy table or a float32 tensor already on the positions' device."""
    if isinstance(inv_freq, torch.Tensor):
        inv = inv_freq.to(device=position_ids.device, dtype=torch.float32)
    else:
        inv = torch.as_tensor(np.asarray(inv_freq, dtype=np.float32), device=position_ids.device)
    freqs = position_ids.float()[..., None] * inv[None, None, :]
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos().to(dtype), emb.sin().to(dtype)


def local_global_inv_freq(head_dim: int, rope_theta: float, rope_scaling,
                          rope_local_base_freq: float,
                          max_position_embeddings: int = 4096) -> np.ndarray:
    """Gemma-3's stacked (2, D/2) table: [global, local]. The global layers
    take ``rope_theta`` with ``rope_scaling`` (linear, factor 8 on 27B); the
    sliding-window layers the plain table at ``rope_local_base_freq``."""
    g = inv_freq_from_hf_config(head_dim, rope_theta, rope_scaling,
                                max_position_embeddings=max_position_embeddings)
    return np.stack([g, default_inv_freq(head_dim, rope_local_base_freq)])


def rope_cos_sin_pair(position_ids: torch.Tensor, inv_pair, dtype=torch.float32):
    """cos / sin of a stacked [global, local] table (:func:`local_global_inv_freq`),
    each (2, B, S, head_dim): a layer's ``use_local_rope`` flag picks index 1."""
    (cg, sg), (cl, sl) = (rope_cos_sin(position_ids, inv_pair[i], dtype) for i in range(2))
    return torch.stack([cg, cl]), torch.stack([sg, sl])


def l2_norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Unweighted RMS normalization over the last axis, in float32 and cast
    back (Llama 4's q / k norm, HF ``Llama4TextL2Norm``)."""
    xf = x.float()
    return (xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)).to(x.dtype)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rotary_pos_emb(q, k, cos, sin):
    """q/k: (B, heads, S, head_dim); cos/sin: (B, S, head_dim). Computed in
    float32 and cast back."""
    cos = cos[:, None].float()
    sin = sin[:, None].float()
    qf, kf = q.float(), k.float()
    q_out = qf * cos + rotate_half(qf) * sin
    k_out = kf * cos + rotate_half(kf) * sin
    return q_out.to(q.dtype), k_out.to(k.dtype)


def apply_rotary_pos_emb_interleaved(q, k, cos, sin):
    """GPT-J-style rope (Helium, ERNIE 4.5): channels form ADJACENT (real,
    imag) pairs (2i, 2i + 1) instead of rotate-half. q/k: (B, heads, S,
    head_dim); cos/sin: (B, S, head_dim), of which only the first head_dim / 2
    entries (one per pair) are read. In float32, cast back."""
    D = q.shape[-1]
    cos = cos[:, None, :, : D // 2].float()
    sin = sin[:, None, :, : D // 2].float()

    def rot(x):
        xf = x.float()
        x1, x2 = xf[..., ::2], xf[..., 1::2]
        out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
        return out.reshape(x.shape).to(x.dtype)

    return rot(q), rot(k)
