"""Arcee (AFM) family (counterpart of ``nxdi_tpu/models/arcee/modeling_arcee.py``):
the Llama geometry with a non-gated squared-ReLU MLP (``up_proj`` and
``down_proj`` only). The fused MLP kernel takes gated MLPs only, so
``mlp_kernel_enabled`` raises on it (the JAX rule).
"""

from __future__ import annotations

from typing import Any, Dict

from nxdi_tpu_torch.config import InferenceConfig
from nxdi_tpu_torch.models import dense
from nxdi_tpu_torch.models.base import DecoderArch

build_inv_freq = dense.build_inv_freq


class ArceeInferenceConfig(dense.DenseInferenceConfig):
    def add_derived_config(self):
        if not hasattr(self, "hidden_act"):
            self.hidden_act = "relu2"
        super().add_derived_config()


def build_arch(config: InferenceConfig, **overrides) -> DecoderArch:
    kwargs = dict(
        gated_mlp=False,
        hidden_act=getattr(config, "hidden_act", "relu2"),
        attention_bias=bool(getattr(config, "attention_bias", False)),
        mlp_bias=bool(getattr(config, "mlp_bias", False)),
    )
    kwargs.update(overrides)
    return dense.build_arch(config, **kwargs)


def convert_hf_state_dict(state_dict: Dict[str, Any], config: InferenceConfig) -> Dict[str, Any]:
    arch = build_arch(config)

    def ff(get, has, cast, pre):
        mlp = {name: {"w": cast(get(f"{pre}mlp.{name}.weight").t())}
               for name in ("up_proj", "down_proj")}
        if arch.mlp_bias:
            for name in ("up_proj", "down_proj"):
                mlp[name]["b"] = cast(get(f"{pre}mlp.{name}.bias"))
        return "mlp", mlp

    return dense.convert_hf_state_dict(state_dict, config, arch, ff_converter=ff)
