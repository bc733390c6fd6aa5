"""GLM-4 family (counterpart of ``nxdi_tpu/models/glm4/modeling_glm4.py``):
four RMSNorms a layer in Gemma's sandwich order (``sandwich_norm``: input,
``post_self_attn`` on the attention output, ``post_attention`` before the
MLP, ``post_mlp`` on its output, renamed onto the shared keys), rope over
``head_dim * partial_rotary_factor`` channels in the adjacent-pair layout,
one fused ``gate_up_proj`` (gate first), q/k/v biases and no o bias."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from nxdi_tpu_torch.config import InferenceConfig, to_torch_dtype
from nxdi_tpu_torch.models import dense
from nxdi_tpu_torch.models.base import DecoderArch
from nxdi_tpu_torch.ops.rope import default_inv_freq


class Glm4InferenceConfig(dense.DenseInferenceConfig):
    def add_derived_config(self):
        if not hasattr(self, "partial_rotary_factor"):
            self.partial_rotary_factor = 0.5
        if not hasattr(self, "attention_bias"):
            self.attention_bias = True
        super().add_derived_config()


def _rotary_dim(config) -> int:
    return int(dense.head_dim_of(config) * config.partial_rotary_factor)


def build_arch(config: InferenceConfig, **overrides) -> DecoderArch:
    kwargs = dict(
        sandwich_norm=True,
        rope_interleaved=True,
        rotary_dim=_rotary_dim(config),
        attention_bias=bool(getattr(config, "attention_bias", True)),
    )
    kwargs.update(overrides)
    return dense.build_arch(config, **kwargs)


def build_inv_freq(config: InferenceConfig) -> np.ndarray:
    return default_inv_freq(_rotary_dim(config), getattr(config, "rope_theta", 10000.0))


def convert_hf_state_dict(state_dict: Dict[str, Any], config: InferenceConfig) -> Dict[str, Any]:
    arch = build_arch(config)

    def src(name):
        return dense.state_tensor(state_dict, name)

    def ff(get, has, cast, pre):
        gu = get(pre + "mlp.gate_up_proj.weight")  # (2I, H), gate first
        inter = gu.shape[0] // 2
        return "mlp", {"gate_proj": {"w": cast(gu[:inter].t())},
                       "up_proj": {"w": cast(gu[inter:].t())},
                       "down_proj": {"w": cast(get(pre + "mlp.down_proj.weight").t())}}

    # the attention output's norm onto the shared sandwich key before the
    # dense converter reads it
    sd = dict(state_dict)
    L = arch.num_layers
    for i in range(L):
        for pre in ("", "model."):
            key = f"{pre}layers.{i}.post_self_attn_layernorm.weight"
            if key in state_dict:
                sd[f"{pre}layers.{i}.post_attention_layernorm.weight"] = state_dict[key]
    params = dense.convert_hf_state_dict(sd, config, arch, ff_converter=ff)
    dt = to_torch_dtype(arch.dtype)
    params["layers"]["pre_feedforward_layernorm"] = torch.stack(
        [src(f"layers.{i}.post_attention_layernorm.weight") for i in range(L)]).to(dt)
    params["layers"]["post_feedforward_layernorm"] = torch.stack(
        [src(f"layers.{i}.post_mlp_layernorm.weight") for i in range(L)]).to(dt)
    return params
