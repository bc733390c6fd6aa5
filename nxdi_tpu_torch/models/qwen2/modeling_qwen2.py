"""Qwen2 / Qwen2.5 family (counterpart of ``nxdi_tpu/models/qwen2/modeling_qwen2.py``):
the Llama lineage with q/k/v projection biases, always on (HF Qwen2Attention).
"""

from __future__ import annotations

from typing import Any, Dict

from nxdi_tpu_torch.config import InferenceConfig
from nxdi_tpu_torch.models import dense
from nxdi_tpu_torch.models.base import DecoderArch

build_inv_freq = dense.build_inv_freq


class Qwen2InferenceConfig(dense.DenseInferenceConfig):
    pass


def build_arch(config: InferenceConfig, **overrides) -> DecoderArch:
    return dense.build_arch(config, **{"attention_bias": True, **overrides})


def convert_hf_state_dict(state_dict: Dict[str, Any], config: InferenceConfig) -> Dict[str, Any]:
    return dense.convert_hf_state_dict(state_dict, config, build_arch(config))
