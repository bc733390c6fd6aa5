"""Ministral family (counterpart of
``nxdi_tpu/models/ministral/modeling_ministral.py``): Mistral with per-layer
``layer_types`` (every layer sliding when the HF config sets a window and
no types). A mixed stack carries the pattern twice: as the layers'
``use_sliding_window`` bool param array (the plain paths read it on the
device) and as ``DecoderArch.kv_window_pattern`` (the window each layer's
kernel launch takes on the card, and the cache split of ``window_sized_kv``:
a ring stack for the window layers, or one ring when every layer slides).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from nxdi_tpu_torch.config import InferenceConfig
from nxdi_tpu_torch.models import dense
from nxdi_tpu_torch.models.base import DecoderArch

build_inv_freq = dense.build_inv_freq


class MinistralInferenceConfig(dense.DenseInferenceConfig):
    def add_derived_config(self):
        super().add_derived_config()
        if not hasattr(self, "sliding_window"):
            self.sliding_window = None
        if getattr(self, "layer_types", None) is None:
            kind = "sliding_attention" if self.sliding_window is not None else "full_attention"
            self.layer_types = [kind] * self.num_hidden_layers


def sliding_flags(config: InferenceConfig) -> Tuple[bool, ...]:
    return tuple(t == "sliding_attention" for t in config.layer_types)


def build_arch(config: InferenceConfig, **overrides) -> DecoderArch:
    sw = getattr(config, "sliding_window", None)
    kwargs = dict(sliding_window=sw, kv_window_pattern=sliding_flags(config) if sw else None)
    kwargs.update(overrides)
    return dense.build_arch(config, **kwargs)


def _add_flags(params: Dict[str, Any], config: InferenceConfig) -> Dict[str, Any]:
    """A mixed stack's ``use_sliding_window`` flags (none when every layer
    slides, as in the JAX package)."""
    flags = sliding_flags(config)
    if getattr(config, "sliding_window", None) and not all(flags):
        params["layers"]["use_sliding_window"] = torch.tensor(flags,
                                                              device=params["norm"].device)
    return params


def convert_hf_state_dict(state_dict: Dict[str, Any], config: InferenceConfig) -> Dict[str, Any]:
    return _add_flags(dense.convert_hf_state_dict(state_dict, config, build_arch(config)), config)


def random_params(config: InferenceConfig, seed: int = 0, device=None) -> Dict[str, Any]:
    """Random weights (dense.random_params) with the layer-type flags, on
    ``device``."""
    return _add_flags(dense.random_params(build_arch(config), seed=seed, device=device), config)
