"""Gemma-2 family (counterpart of ``nxdi_tpu/models/gemma2/modeling_gemma2.py``):
Gemma-3's machinery (``models/gemma3``: (1 + w) float32 norms, sandwich
pre / post feed-forward norms, sqrt(hidden) embedding scale, alternating
sliding / full layers, ``query_pre_attn_scalar`` softmax scaling) with one
rope table for every layer, no q / k norms, and Gemma-2's soft caps:
``cap * tanh(x / cap)`` on the scaled attention scores (50) and on the final
logits (30).

No attention kernel takes the attention softcap (the JAX rule): on the card
the attention kernel flags must be off for this family (an enabled one
raises, naming the softcap), and the commit kernel and the projection
kernels still run.
"""

from __future__ import annotations

from typing import Any, Dict

from nxdi_tpu_torch.config import InferenceConfig
from nxdi_tpu_torch.models import dense
from nxdi_tpu_torch.models.base import DecoderArch
from nxdi_tpu_torch.models.gemma3.modeling_gemma3 import (
    add_layer_flags,
    add_sandwich_params,
    sliding_flags,
)

build_inv_freq = dense.build_inv_freq  # one theta; no local / global pair

# Gemma-2-9B at its published widths (HF google/gemma-2-9b config.json)
GEMMA_2_9B = dict(
    hidden_size=3584,
    intermediate_size=14336,
    num_hidden_layers=42,
    num_attention_heads=16,
    num_key_value_heads=8,
    head_dim=256,
    query_pre_attn_scalar=256,
    sliding_window=4096,
    attn_logit_softcapping=50.0,
    final_logit_softcapping=30.0,
    rope_theta=10000.0,
    vocab_size=256000,
    rms_norm_eps=1e-6,
    max_position_embeddings=8192,
    tie_word_embeddings=True,
    hidden_activation="gelu_pytorch_tanh",
)


class Gemma2InferenceConfig(dense.DenseInferenceConfig):
    REQUIRED = dense.DenseInferenceConfig.REQUIRED + ["head_dim"]

    def add_derived_config(self):
        super().add_derived_config()
        if getattr(self, "hidden_act", None) in (None, "silu"):
            self.hidden_act = getattr(self, "hidden_activation", "gelu_pytorch_tanh")
        defaults = {
            "query_pre_attn_scalar": self.head_dim,
            "sliding_window": None,
            "attn_logit_softcapping": 50.0,
            "final_logit_softcapping": 30.0,
        }
        for k, v in defaults.items():
            if not hasattr(self, k):
                setattr(self, k, v)


def layer_is_sliding(config: InferenceConfig, i: int) -> bool:
    """HF ``layer_types`` when present, else Gemma-2's default: even layers
    slide."""
    lt = getattr(config, "layer_types", None)
    if lt:
        return lt[i] == "sliding_attention"
    return i % 2 == 0


def build_arch(config: InferenceConfig, **overrides) -> DecoderArch:
    sw = getattr(config, "sliding_window", None)
    kwargs = dict(
        gemma_norm=True,
        sandwich_norm=True,
        embed_scale=float(config.hidden_size) ** 0.5,
        sliding_window=sw,
        attention_scale=float(config.query_pre_attn_scalar) ** -0.5,
        attn_logit_softcap=getattr(config, "attn_logit_softcapping", None),
        final_logit_softcap=getattr(config, "final_logit_softcapping", None),
        tie_word_embeddings=getattr(config, "tie_word_embeddings", True),
        # window_sized_kv: the full-attention layers stay off the ring
        kv_window_pattern=sliding_flags(config, layer_is_sliding) if sw else None,
    )
    kwargs.update(overrides)
    return dense.build_arch(config, **kwargs)


def convert_hf_state_dict(state_dict: Dict[str, Any], config: InferenceConfig) -> Dict[str, Any]:
    params = dense.convert_hf_state_dict(state_dict, config, build_arch(config))
    return add_sandwich_params(params, state_dict, config, layer_is_sliding, dual_rope=False)


def random_params(config: InferenceConfig, seed: int = 0, device=None) -> Dict[str, Any]:
    """Random weights (the sandwich norms included) with the window flags, on
    ``device``."""
    params = dense.random_params(build_arch(config), seed=seed, device=device)
    return add_layer_flags(params, config, layer_is_sliding, dual_rope=False)
