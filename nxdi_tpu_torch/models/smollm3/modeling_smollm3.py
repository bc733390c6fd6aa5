"""SmolLM3 family (counterpart of ``nxdi_tpu/models/smollm3/modeling_smollm3.py``):
the Llama lineage where every ``no_rope_layer_interval``-th layer (or the
layers ``no_rope_layers`` marks 0) skips rope. The per-layer ``use_rope``
flag rides the layer stack as a bool param array.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from nxdi_tpu_torch.config import InferenceConfig
from nxdi_tpu_torch.models import dense
from nxdi_tpu_torch.models.base import DecoderArch

build_inv_freq = dense.build_inv_freq


class SmolLM3InferenceConfig(dense.DenseInferenceConfig):
    pass


def build_arch(config: InferenceConfig, **overrides) -> DecoderArch:
    return dense.build_arch(config, **overrides)


def use_rope_flags(config: InferenceConfig) -> torch.Tensor:
    """(L,) bool: True where the layer applies rope."""
    nrl = getattr(config, "no_rope_layers", None)
    if nrl:
        return torch.tensor([bool(v) for v in nrl])
    interval = getattr(config, "no_rope_layer_interval", 4) or 4
    return torch.tensor([(i + 1) % interval != 0 for i in range(config.num_hidden_layers)])


def convert_hf_state_dict(state_dict: Dict[str, Any], config: InferenceConfig) -> Dict[str, Any]:
    params = dense.convert_hf_state_dict(state_dict, config, build_arch(config))
    params["layers"]["use_rope"] = use_rope_flags(config)
    return params


def random_params(config: InferenceConfig, seed: int = 0, device=None) -> Dict[str, Any]:
    """Random weights (dense.random_params) with the config's ``use_rope``
    flags, on ``device``."""
    params = dense.random_params(build_arch(config), seed=seed, device=device)
    params["layers"]["use_rope"] = use_rope_flags(config).to(params["norm"].device)
    return params
