"""MiniCPM family (counterpart of ``nxdi_tpu/models/minicpm/modeling_minicpm.py``):
the Llama geometry with mu-P scalings: embeddings times ``scale_emb``, each
block output times ``scale_depth / sqrt(L)`` before the residual add, and
the logits divided by ``hidden_size / dim_model_base``.
"""

from __future__ import annotations

import math
from typing import Any, Dict

from nxdi_tpu_torch.config import InferenceConfig
from nxdi_tpu_torch.models import dense
from nxdi_tpu_torch.models.base import DecoderArch

build_inv_freq = dense.build_inv_freq


class MiniCPMInferenceConfig(dense.DenseInferenceConfig):
    def add_derived_config(self):
        for name, default in (("scale_emb", 1.0), ("scale_depth", 1.0),
                              ("dim_model_base", None)):
            if not hasattr(self, name):
                setattr(self, name, default)
        super().add_derived_config()


def build_arch(config: InferenceConfig, **overrides) -> DecoderArch:
    dim_base = getattr(config, "dim_model_base", None) or config.hidden_size
    kwargs = dict(
        embed_scale=float(getattr(config, "scale_emb", 1.0)),
        residual_multiplier=(float(getattr(config, "scale_depth", 1.0))
                             / math.sqrt(config.num_hidden_layers)),
        logits_scaling=float(config.hidden_size) / float(dim_base),
        tie_word_embeddings=bool(getattr(config, "tie_word_embeddings", False)),
    )
    kwargs.update(overrides)
    return dense.build_arch(config, **kwargs)


def convert_hf_state_dict(state_dict: Dict[str, Any], config: InferenceConfig) -> Dict[str, Any]:
    return dense.convert_hf_state_dict(state_dict, config, build_arch(config))
