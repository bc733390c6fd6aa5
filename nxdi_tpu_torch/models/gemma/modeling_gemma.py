"""Gemma (v1) family (counterpart of ``nxdi_tpu/models/gemma/modeling_gemma.py``):
(1 + w) float32 RMSNorms, embeddings scaled by sqrt(hidden), a tied head,
the tanh-approximated GELU in the gated MLP, and head dim 256 at the
published widths. None of Gemma 2's extras (no sandwich norms, no softcaps).
"""

from __future__ import annotations

from typing import Any, Dict

from nxdi_tpu_torch.config import InferenceConfig
from nxdi_tpu_torch.models import dense
from nxdi_tpu_torch.models.base import DecoderArch

build_inv_freq = dense.build_inv_freq

# Gemma-2B at its published widths (HF google/gemma-2b config.json; its
# "gelu" runs as the tanh approximation, as HF Gemma and the JAX package
# run it)
GEMMA_2B = dict(
    hidden_size=2048,
    intermediate_size=16384,
    num_hidden_layers=18,
    num_attention_heads=8,
    num_key_value_heads=1,
    head_dim=256,
    vocab_size=256000,
    rms_norm_eps=1e-6,
    rope_theta=10000.0,
    max_position_embeddings=8192,
    tie_word_embeddings=True,
    hidden_act="gelu_pytorch_tanh",
)


class GemmaInferenceConfig(dense.DenseInferenceConfig):
    REQUIRED = dense.DenseInferenceConfig.REQUIRED + ["head_dim"]

    def add_derived_config(self):
        if getattr(self, "hidden_activation", None):
            self.hidden_act = self.hidden_activation
        elif not hasattr(self, "hidden_act"):
            self.hidden_act = "gelu_pytorch_tanh"
        super().add_derived_config()


def build_arch(config: InferenceConfig, **overrides) -> DecoderArch:
    kwargs = dict(
        gemma_norm=True,
        embed_scale=float(config.hidden_size) ** 0.5,
        tie_word_embeddings=bool(getattr(config, "tie_word_embeddings", True)),
    )
    kwargs.update(overrides)
    return dense.build_arch(config, **kwargs)


def convert_hf_state_dict(state_dict: Dict[str, Any], config: InferenceConfig) -> Dict[str, Any]:
    return dense.convert_hf_state_dict(state_dict, config, build_arch(config))
