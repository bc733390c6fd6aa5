"""Cohere 2 (Command R7B) family (counterpart of
``nxdi_tpu/models/cohere2/modeling_cohere2.py``): the parallel block
(``parallel_block``: attention and the MLP both read the layer input, one
residual add) under ONE weight-only LayerNorm per layer, which the converter
aliases onto both norm keys; sliding-window layers with a full-attention
layer every ``sliding_window_pattern``-th (or HF's ``layer_types``), where
only the window layers apply rope (adjacent-pair) and the global layers are
NoPE; logits times ``logit_scale`` (the dividing ``logits_scaling``); tied
embeddings.

The per-layer ``use_sliding_window`` and ``use_rope`` flags ride the layer
stack; the window pattern is ``DecoderArch.kv_window_pattern`` on the host
(each layer's kernel window on the card, and the cache split of
``window_sized_kv``: the global layers' full-length cache beside the window
layers' ring)."""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from nxdi_tpu_torch.config import InferenceConfig
from nxdi_tpu_torch.models import dense
from nxdi_tpu_torch.models.base import DecoderArch

build_inv_freq = dense.build_inv_freq

# Command R7B at its published widths (HF CohereForAI/c4ai-command-r7b-12-2024
# config.json): 32 query heads over 8 kv heads of 128, windows of 4096 on
# three layers of four, rope theta 5e4, logits times 0.25, tied embeddings
COMMAND_R7B = dict(
    hidden_size=4096,
    intermediate_size=14336,
    num_hidden_layers=32,
    num_attention_heads=32,
    num_key_value_heads=8,
    head_dim=128,
    sliding_window=4096,
    sliding_window_pattern=4,
    rope_theta=50000.0,
    logit_scale=0.25,
    vocab_size=256000,
    layer_norm_eps=1e-5,
    max_position_embeddings=132096,
    attention_bias=False,
    tie_word_embeddings=True,
    hidden_act="silu",
)


class Cohere2InferenceConfig(dense.DenseInferenceConfig):
    def add_derived_config(self):
        self.rms_norm_eps = getattr(self, "layer_norm_eps", 1e-5)
        if not hasattr(self, "tie_word_embeddings"):
            self.tie_word_embeddings = True
        super().add_derived_config()
        if getattr(self, "use_qk_norm", False):
            raise NotImplementedError("cohere2 use_qk_norm is not supported yet")
        if getattr(self, "layer_types", None) is None:
            pat = getattr(self, "sliding_window_pattern", 4) or 4
            self.layer_types = ["full_attention" if (i + 1) % pat == 0 else "sliding_attention"
                                for i in range(self.num_hidden_layers)]


def sliding_flags(config: InferenceConfig) -> Tuple[bool, ...]:
    """Per layer, whether it slides (and ropes: the global layers are NoPE)."""
    return tuple(t == "sliding_attention" for t in config.layer_types)


def build_arch(config: InferenceConfig, **overrides) -> DecoderArch:
    sw = getattr(config, "sliding_window", None)
    kwargs = dict(
        parallel_block=True,
        layernorm=True,
        rope_interleaved=True,
        sliding_window=sw,
        kv_window_pattern=sliding_flags(config) if sw else None,
        logits_scaling=1.0 / float(getattr(config, "logit_scale", 1.0)),
        tie_word_embeddings=bool(getattr(config, "tie_word_embeddings", True)),
    )
    kwargs.update(overrides)
    return dense.build_arch(config, **kwargs)


def add_layer_flags(params: Dict[str, Any], config: InferenceConfig) -> Dict[str, Any]:
    """The ``use_sliding_window`` and ``use_rope`` flags (the same pattern),
    on the params' device."""
    flags = torch.tensor(sliding_flags(config), device=params["norm"].device)
    params["layers"]["use_sliding_window"] = flags
    params["layers"]["use_rope"] = flags.clone()
    return params


def convert_hf_state_dict(state_dict: Dict[str, Any], config: InferenceConfig) -> Dict[str, Any]:
    # ONE norm per layer: aliased onto post_attention_layernorm, which the
    # parallel block's MLP branch reads
    sd = dict(state_dict)
    for i in range(config.num_hidden_layers):
        for pre in ("model.layers.", "layers."):
            key = f"{pre}{i}.input_layernorm.weight"
            if key in sd:
                sd[f"{pre}{i}.post_attention_layernorm.weight"] = sd[key]
    params = dense.convert_hf_state_dict(sd, config, build_arch(config))
    return add_layer_flags(params, config)


def random_params(config: InferenceConfig, seed: int = 0, device=None) -> Dict[str, Any]:
    """Random weights (dense.random_params: unit norms, so the two norm keys
    agree as the converter's alias does) with the layer flags."""
    return add_layer_flags(dense.random_params(build_arch(config), seed=seed, device=device),
                           config)
