"""Gemma-3 (text) family, registered as ``gemma3_text`` (counterpart of
``nxdi_tpu/models/gemma3/modeling_gemma3.py``): (1 + w) float32 norms
(``gemma_norm``: the input, the sandwich's three and the per-head q / k
norms), sandwich pre / post feed-forward norms (``sandwich_norm``), the
embeddings times sqrt(hidden) rounded to the compute dtype, the softmax
scale ``query_pre_attn_scalar ** -0.5``, sliding-window layers with a
full-attention layer every ``sliding_window_pattern``-th (or HF's
``layer_types``), and a rope pair: the global layers take ``rope_theta``
with its scaling, the sliding ones ``rope_local_base_freq``.

The per-layer heterogeneity rides the layer stack as bool flags,
``use_sliding_window`` and ``use_local_rope`` (L,), and the window pattern
as ``DecoderArch.kv_window_pattern`` on the host: the window each layer's
kernel launch takes on the card, and the cache split of ``window_sized_kv``
(full-length ``k`` / ``v`` for the global layers, a W-slot ring for the
sliding ones). The multimodal ``gemma3`` type (the vision tower) is not
ported.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from nxdi_tpu_torch.config import InferenceConfig
from nxdi_tpu_torch.models import dense
from nxdi_tpu_torch.models.base import DecoderArch
from nxdi_tpu_torch.ops.rope import local_global_inv_freq

# Gemma-3-27B (text) at its published widths (HF google/gemma-3-27b-it
# config.json, text_config)
GEMMA_3_27B = dict(
    hidden_size=5376,
    intermediate_size=21504,
    num_hidden_layers=62,
    num_attention_heads=32,
    num_key_value_heads=16,
    head_dim=128,
    query_pre_attn_scalar=168,
    sliding_window=1024,
    sliding_window_pattern=6,
    rope_theta=1000000.0,
    rope_scaling=dict(rope_type="linear", factor=8.0),
    rope_local_base_freq=10000.0,
    vocab_size=262208,
    rms_norm_eps=1e-6,
    max_position_embeddings=131072,
    tie_word_embeddings=True,
    hidden_activation="gelu_pytorch_tanh",
)


class Gemma3InferenceConfig(dense.DenseInferenceConfig):
    REQUIRED = dense.DenseInferenceConfig.REQUIRED + ["head_dim"]

    def add_derived_config(self):
        super().add_derived_config()
        if getattr(self, "hidden_act", None) in (None, "silu"):
            # HF stores Gemma's activation under hidden_activation
            self.hidden_act = getattr(self, "hidden_activation", "gelu_pytorch_tanh")
        if not hasattr(self, "query_pre_attn_scalar"):
            self.query_pre_attn_scalar = self.head_dim
        if not hasattr(self, "rope_local_base_freq"):
            self.rope_local_base_freq = 10000.0
        if not hasattr(self, "sliding_window"):
            self.sliding_window = None
        if not hasattr(self, "tie_word_embeddings"):
            self.tie_word_embeddings = True


def layer_is_sliding(config: InferenceConfig, i: int) -> bool:
    """Whether layer ``i`` slides: HF ``layer_types`` when present, else the
    every-Nth-global pattern (``sliding_window_pattern``, 6 by default)."""
    lt = getattr(config, "layer_types", None)
    if lt:
        return lt[i] == "sliding_attention"
    pattern = getattr(config, "sliding_window_pattern", None) or 6
    return (i + 1) % pattern != 0


def sliding_flags(config: InferenceConfig, is_sliding=layer_is_sliding) -> Tuple[bool, ...]:
    return tuple(is_sliding(config, i) for i in range(config.num_hidden_layers))


def build_arch(config: InferenceConfig, **overrides) -> DecoderArch:
    sw = getattr(config, "sliding_window", None)
    kwargs = dict(
        qk_norm=True,
        gemma_norm=True,
        sandwich_norm=True,
        embed_scale=float(config.hidden_size) ** 0.5,
        sliding_window=sw,
        attention_scale=float(config.query_pre_attn_scalar) ** -0.5,
        tie_word_embeddings=getattr(config, "tie_word_embeddings", True),
        kv_window_pattern=sliding_flags(config) if sw else None,
    )
    kwargs.update(overrides)
    return dense.build_arch(config, **kwargs)


def build_inv_freq(config: InferenceConfig) -> np.ndarray:
    """The stacked (2, D/2) [global, local] table."""
    return local_global_inv_freq(
        config.head_dim, getattr(config, "rope_theta", 1000000.0),
        getattr(config, "rope_scaling", None), config.rope_local_base_freq,
        max_position_embeddings=getattr(config, "max_position_embeddings", 4096))


# -- the Gemma lineage's shared pieces (Gemma 2 takes them with dual_rope=False) --

def add_layer_flags(params: Dict[str, Any], config: InferenceConfig, is_sliding,
                    dual_rope: bool) -> Dict[str, Any]:
    """The per-layer ``use_sliding_window`` flags and, with ``dual_rope``,
    ``use_local_rope`` (the local rope on the sliding layers), on the
    params' device."""
    flags = torch.tensor(sliding_flags(config, is_sliding), device=params["norm"].device)
    params["layers"]["use_sliding_window"] = flags
    if dual_rope:
        params["layers"]["use_local_rope"] = flags.clone()
    return params


def add_sandwich_params(params: Dict[str, Any], state_dict: Dict[str, Any],
                        config: InferenceConfig, is_sliding, dual_rope: bool) -> Dict[str, Any]:
    """The sandwich's pre / post feed-forward norms (L, H) from the HF
    checkpoint, and the layer flags (:func:`add_layer_flags`)."""
    dt = params["norm"].dtype

    def get(name):
        for k in (name, f"model.{name}"):
            if k in state_dict:
                return torch.as_tensor(state_dict[k])
        raise KeyError(name)

    for key in ("pre_feedforward_layernorm", "post_feedforward_layernorm"):
        params["layers"][key] = torch.stack(
            [get(f"layers.{i}.{key}.weight").to(dt) for i in range(config.num_hidden_layers)])
    return add_layer_flags(params, config, is_sliding, dual_rope)


def convert_hf_state_dict(state_dict: Dict[str, Any], config: InferenceConfig) -> Dict[str, Any]:
    params = dense.convert_hf_state_dict(state_dict, config, build_arch(config))
    return add_sandwich_params(params, state_dict, config, layer_is_sliding, dual_rope=True)


def random_params(config: InferenceConfig, seed: int = 0, device=None) -> Dict[str, Any]:
    """Random weights (dense.random_params: the sandwich norms included) with
    the layer flags, on ``device``."""
    params = dense.random_params(build_arch(config), seed=seed, device=device)
    return add_layer_flags(params, config, layer_is_sliding, dual_rope=True)
