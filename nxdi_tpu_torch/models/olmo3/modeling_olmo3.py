"""OLMo-3 family (counterpart of ``nxdi_tpu/models/olmo3/modeling_olmo3.py``):
OLMo-2 (post-block norms, the flat q / k RMSNorm; ``models/olmo2``) with
interleaved sliding-window layers (HF ``layer_types``) and two rope tables:
the full-attention layers take the ``rope_scaling``'d one, the window layers
the plain one at ``rope_theta``. The tables arrive stacked (2, D/2)
[global, local] and each layer's ``use_local_rope`` flag picks one (Gemma-3's
machinery); the ``use_sliding_window`` flags and
``DecoderArch.kv_window_pattern`` carry the windows."""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from nxdi_tpu_torch.config import InferenceConfig
from nxdi_tpu_torch.models import dense
from nxdi_tpu_torch.models.base import DecoderArch
from nxdi_tpu_torch.models.olmo2 import modeling_olmo2 as olmo2
from nxdi_tpu_torch.ops.rope import default_inv_freq


class Olmo3InferenceConfig(dense.DenseInferenceConfig):
    def add_derived_config(self):
        super().add_derived_config()
        if not hasattr(self, "sliding_window"):
            self.sliding_window = None
        if getattr(self, "layer_types", None) is None:
            self.layer_types = ["full_attention"] * self.num_hidden_layers


def sliding_flags(config: InferenceConfig) -> Tuple[bool, ...]:
    return tuple(t == "sliding_attention" for t in config.layer_types)


def build_arch(config: InferenceConfig, **overrides) -> DecoderArch:
    sw = getattr(config, "sliding_window", None)
    kwargs = dict(sliding_window=sw, kv_window_pattern=sliding_flags(config) if sw else None)
    kwargs.update(overrides)
    return olmo2.build_arch(config, **kwargs)


def build_inv_freq(config: InferenceConfig) -> np.ndarray:
    """The rope_scaling'd table, stacked over the plain one ([global, local])
    on a model with window layers."""
    full = dense.build_inv_freq(config)
    if not getattr(config, "sliding_window", None):
        return full
    local = default_inv_freq(dense.head_dim_of(config), getattr(config, "rope_theta", 10000.0))
    return np.stack([np.asarray(full), local])


def add_layer_flags(params: Dict[str, Any], config: InferenceConfig) -> Dict[str, Any]:
    """The ``use_sliding_window`` flags and ``use_local_rope`` (the plain
    table on the window layers), on the params' device."""
    if getattr(config, "sliding_window", None):
        flags = torch.tensor(sliding_flags(config), device=params["norm"].device)
        params["layers"]["use_sliding_window"] = flags
        params["layers"]["use_local_rope"] = flags.clone()
    return params


def convert_hf_state_dict(state_dict: Dict[str, Any], config: InferenceConfig) -> Dict[str, Any]:
    return add_layer_flags(olmo2.convert_hf_state_dict(state_dict, config), config)


def random_params(config: InferenceConfig, seed: int = 0, device=None) -> Dict[str, Any]:
    """Random weights (dense.random_params: the flat q / k norms included)
    with the layer flags."""
    return add_layer_flags(dense.random_params(build_arch(config), seed=seed, device=device),
                           config)
