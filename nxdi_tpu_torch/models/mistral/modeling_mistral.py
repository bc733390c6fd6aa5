"""Mistral family (counterpart of ``nxdi_tpu/models/mistral/modeling_mistral.py``):
the Llama lineage with sliding-window attention. The window is a mask over
the full-length cache (keys at positions in ``(q - window, q]``), which the
prefill and decode kernels take as a per-call scalar.
"""

from __future__ import annotations

from typing import Any, Dict

from nxdi_tpu_torch.config import InferenceConfig
from nxdi_tpu_torch.models import dense
from nxdi_tpu_torch.models.base import DecoderArch

build_inv_freq = dense.build_inv_freq

# Mistral-7B-v0.1 at its published widths (HF mistralai/Mistral-7B-v0.1
# config.json)
MISTRAL_7B_V01 = dict(
    hidden_size=4096,
    intermediate_size=14336,
    num_hidden_layers=32,
    num_attention_heads=32,
    num_key_value_heads=8,
    head_dim=128,
    vocab_size=32000,
    rms_norm_eps=1e-5,
    rope_theta=10000.0,
    max_position_embeddings=32768,
    sliding_window=4096,
    tie_word_embeddings=False,
    hidden_act="silu",
)


class MistralInferenceConfig(dense.DenseInferenceConfig):
    pass


def build_arch(config: InferenceConfig, **overrides) -> DecoderArch:
    sw = getattr(config, "sliding_window", None)
    return dense.build_arch(config, **{"sliding_window": sw, **overrides})


def convert_hf_state_dict(state_dict: Dict[str, Any], config: InferenceConfig) -> Dict[str, Any]:
    return dense.convert_hf_state_dict(state_dict, config, build_arch(config))
