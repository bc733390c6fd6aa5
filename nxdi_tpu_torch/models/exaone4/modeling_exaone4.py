"""EXAONE 4.0 family (counterpart of
``nxdi_tpu/models/exaone4/modeling_exaone4.py``): no input norms and RMSNorm
on the attention and MLP outputs before the residual add (``post_block_norm``,
the OLMo-2 convention: the converter aliases HF's ``post_attention_layernorm``
onto ``input_layernorm`` and ``post_feedforward_layernorm`` onto
``post_attention_layernorm``), per-head q / k RMSNorm before rope
(``qk_norm``), and on a hybrid model (``sliding_window`` set) sliding-window
layers with a full-attention layer every ``sliding_window_pattern``-th (or
HF's ``layer_types``), where only the window layers apply rope: the global
layers are NoPE. The hybrid's ``use_sliding_window`` / ``use_rope`` flags
ride the layer stack, its window pattern ``DecoderArch.kv_window_pattern``."""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from nxdi_tpu_torch.config import InferenceConfig
from nxdi_tpu_torch.models import dense
from nxdi_tpu_torch.models.base import DecoderArch

build_inv_freq = dense.build_inv_freq


class Exaone4InferenceConfig(dense.DenseInferenceConfig):
    def add_derived_config(self):
        super().add_derived_config()
        if not hasattr(self, "sliding_window"):
            self.sliding_window = None
        if getattr(self, "layer_types", None) is None:
            pat = (getattr(self, "sliding_window_pattern", 4) or 4) if self.sliding_window else 0
            self.layer_types = [
                "sliding_attention" if pat and (i + 1) % pat else "full_attention"
                for i in range(self.num_hidden_layers)]


def sliding_flags(config: InferenceConfig) -> Tuple[bool, ...]:
    """Per layer, whether it slides (and, on a hybrid, ropes)."""
    return tuple(t == "sliding_attention" for t in config.layer_types)


def build_arch(config: InferenceConfig, **overrides) -> DecoderArch:
    sw = getattr(config, "sliding_window", None)
    kwargs = dict(
        post_block_norm=True,
        qk_norm=True,
        sliding_window=sw,
        kv_window_pattern=sliding_flags(config) if sw else None,
    )
    kwargs.update(overrides)
    return dense.build_arch(config, **kwargs)


def add_layer_flags(params: Dict[str, Any], config: InferenceConfig) -> Dict[str, Any]:
    """A hybrid's ``use_sliding_window`` and ``use_rope`` flags (the same
    pattern: the global layers are NoPE), on the params' device."""
    if getattr(config, "sliding_window", None):
        flags = torch.tensor(sliding_flags(config), device=params["norm"].device)
        params["layers"]["use_sliding_window"] = flags
        params["layers"]["use_rope"] = flags.clone()
    return params


def convert_hf_state_dict(state_dict: Dict[str, Any], config: InferenceConfig) -> Dict[str, Any]:
    sd = dict(state_dict)
    for i in range(config.num_hidden_layers):
        for pre in ("model.layers.", "layers."):
            p = f"{pre}{i}."
            if p + "post_attention_layernorm.weight" not in sd:
                continue
            sd[p + "input_layernorm.weight"] = sd[p + "post_attention_layernorm.weight"]
            sd[p + "post_attention_layernorm.weight"] = sd.pop(
                p + "post_feedforward_layernorm.weight")
    params = dense.convert_hf_state_dict(sd, config, build_arch(config))
    return add_layer_flags(params, config)


def random_params(config: InferenceConfig, seed: int = 0, device=None) -> Dict[str, Any]:
    """Random weights (dense.random_params) with a hybrid's layer flags."""
    return add_layer_flags(dense.random_params(build_arch(config), seed=seed, device=device),
                           config)
