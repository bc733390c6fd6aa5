"""Qwen3 family (counterpart of ``nxdi_tpu/models/qwen3/modeling_qwen3.py``):
per-head q/k RMSNorm (``qk_norm``) and an explicit ``head_dim`` decoupled
from hidden / heads; no attention biases.
"""

from __future__ import annotations

from typing import Any, Dict

from nxdi_tpu_torch.config import InferenceConfig
from nxdi_tpu_torch.models import dense
from nxdi_tpu_torch.models.base import DecoderArch

build_inv_freq = dense.build_inv_freq

# Qwen3-8B at its published widths (HF Qwen/Qwen3-8B config.json)
QWEN3_8B = dict(
    hidden_size=4096,
    intermediate_size=12288,
    num_hidden_layers=36,
    num_attention_heads=32,
    num_key_value_heads=8,
    head_dim=128,
    vocab_size=151936,
    rms_norm_eps=1e-6,
    rope_theta=1000000.0,
    max_position_embeddings=40960,
    tie_word_embeddings=False,
    attention_bias=False,
    hidden_act="silu",
)


class Qwen3InferenceConfig(dense.DenseInferenceConfig):
    pass


def build_arch(config: InferenceConfig, **overrides) -> DecoderArch:
    return dense.build_arch(config, **{"qk_norm": True, **overrides})


def convert_hf_state_dict(state_dict: Dict[str, Any], config: InferenceConfig) -> Dict[str, Any]:
    return dense.convert_hf_state_dict(state_dict, config, build_arch(config))
