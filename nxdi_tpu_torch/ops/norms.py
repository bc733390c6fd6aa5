"""Normalization ops (counterpart of ``nxdi_tpu/ops/norms.py``)."""

from __future__ import annotations

from typing import Optional

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6,
             gemma_style: bool = False) -> torch.Tensor:
    """RMSNorm with float32 accumulation, output in ``x.dtype``.

    ``gemma_style``: the Gemma lineage stores the weight as an offset from
    one and multiplies by ``1 + w`` in float32 before the downcast."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    w = weight.float()
    if gemma_style:
        w = 1.0 + w
    return (y * w).to(x.dtype)


def flat_rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float, denom: int) -> torch.Tensor:
    """RMSNorm over a whole flattened projection (OLMo-2's q/k norms, before
    the head reshape) whose mean square divides by ``denom``: the true,
    unpadded width. Under GQA head padding the padded entries are exactly
    zero, so ``sum(x^2) / denom`` is the unpadded model's mean."""
    xf = x.float()
    ms = (xf * xf).sum(dim=-1, keepdim=True) / denom
    return (xf * torch.rsqrt(ms + eps) * weight.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis with float32 statistics (the biased
    variance), output in ``x.dtype``; weight-only (DBRX) or biased
    (Phi-3.5-MoE)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) * (xf - mean)).mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps) * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)
