"""ERNIE 4.5 (dense) family (counterpart of
``nxdi_tpu/models/ernie4_5/modeling_ernie4_5.py``): one ``use_bias`` switch
on every projection (q/k/v/o and gate/up/down) and the adjacent-pair rope.
"""

from __future__ import annotations

from typing import Any, Dict

from nxdi_tpu_torch.config import InferenceConfig
from nxdi_tpu_torch.models import dense
from nxdi_tpu_torch.models.base import DecoderArch

build_inv_freq = dense.build_inv_freq


class Ernie4_5InferenceConfig(dense.DenseInferenceConfig):
    def add_derived_config(self):
        super().add_derived_config()
        if not hasattr(self, "use_bias"):
            self.use_bias = False


def build_arch(config: InferenceConfig, **overrides) -> DecoderArch:
    bias = bool(getattr(config, "use_bias", False))
    kwargs = dict(attention_bias=bias, attention_o_bias=bias, mlp_bias=bias,
                  rope_interleaved=True)
    kwargs.update(overrides)
    return dense.build_arch(config, **kwargs)


def convert_hf_state_dict(state_dict: Dict[str, Any], config: InferenceConfig) -> Dict[str, Any]:
    return dense.convert_hf_state_dict(state_dict, config, build_arch(config))
