"""InternLM3 family (counterpart of
``nxdi_tpu/models/internlm3/modeling_internlm3.py``): the Llama geometry
with split bias switches: ``qkv_bias`` for the q/k/v biases, ``bias`` for
the o_proj and MLP biases.
"""

from __future__ import annotations

from typing import Any, Dict

from nxdi_tpu_torch.config import InferenceConfig
from nxdi_tpu_torch.models import dense
from nxdi_tpu_torch.models.base import DecoderArch

build_inv_freq = dense.build_inv_freq


class InternLM3InferenceConfig(dense.DenseInferenceConfig):
    def add_derived_config(self):
        if not hasattr(self, "qkv_bias"):
            self.qkv_bias = False
        if not hasattr(self, "bias"):
            self.bias = False
        super().add_derived_config()


def build_arch(config: InferenceConfig, **overrides) -> DecoderArch:
    kwargs = dict(
        attention_bias=bool(getattr(config, "qkv_bias", False)),
        attention_o_bias=bool(getattr(config, "bias", False)),
        mlp_bias=bool(getattr(config, "bias", False)),
    )
    kwargs.update(overrides)
    return dense.build_arch(config, **kwargs)


def convert_hf_state_dict(state_dict: Dict[str, Any], config: InferenceConfig) -> Dict[str, Any]:
    return dense.convert_hf_state_dict(state_dict, config, build_arch(config))
