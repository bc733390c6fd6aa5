"""Seed-OSS family (counterpart of ``nxdi_tpu/models/seed_oss/modeling_seed_oss.py``):
q/k/v biases under ``attention_bias``, an o_proj bias under its own
``attention_out_bias``, and an explicit ``head_dim``.
"""

from __future__ import annotations

from typing import Any, Dict

from nxdi_tpu_torch.config import InferenceConfig
from nxdi_tpu_torch.models import dense
from nxdi_tpu_torch.models.base import DecoderArch

build_inv_freq = dense.build_inv_freq


class SeedOssInferenceConfig(dense.DenseInferenceConfig):
    def add_derived_config(self):
        super().add_derived_config()
        for k, v in (("attention_bias", True), ("attention_out_bias", False),
                     ("mlp_bias", False)):
            if getattr(self, k, None) is None:
                setattr(self, k, v)


def build_arch(config: InferenceConfig, **overrides) -> DecoderArch:
    kwargs = dict(
        attention_bias=bool(getattr(config, "attention_bias", True)),
        attention_o_bias=bool(getattr(config, "attention_out_bias", False)),
        mlp_bias=bool(getattr(config, "mlp_bias", False)),
    )
    kwargs.update(overrides)
    return dense.build_arch(config, **kwargs)


def convert_hf_state_dict(state_dict: Dict[str, Any], config: InferenceConfig) -> Dict[str, Any]:
    return dense.convert_hf_state_dict(state_dict, config, build_arch(config))
