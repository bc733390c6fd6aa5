"""Granite family (counterpart of ``nxdi_tpu/models/granite/modeling_granite.py``):
the Llama lineage with scalar multipliers: ``embedding_multiplier`` on the
embeddings, ``attention_multiplier`` as the softmax scale (1.0 when the HF
config leaves it out, HF GraniteConfig's default), ``residual_multiplier``
on every block output before the residual add, and ``logits_scaling``
dividing the logits.
"""

from __future__ import annotations

from typing import Any, Dict

from nxdi_tpu_torch.config import InferenceConfig
from nxdi_tpu_torch.models import dense
from nxdi_tpu_torch.models.base import DecoderArch

build_inv_freq = dense.build_inv_freq


class GraniteInferenceConfig(dense.DenseInferenceConfig):
    pass


def build_arch(config: InferenceConfig, **overrides) -> DecoderArch:
    attn_mult = getattr(config, "attention_multiplier", None)
    kwargs = dict(
        embed_scale=float(getattr(config, "embedding_multiplier", 1.0)),
        attention_scale=1.0 if attn_mult is None else float(attn_mult),
        residual_multiplier=float(getattr(config, "residual_multiplier", 1.0)),
        logits_scaling=float(getattr(config, "logits_scaling", 1.0)),
    )
    kwargs.update(overrides)
    return dense.build_arch(config, **kwargs)


def convert_hf_state_dict(state_dict: Dict[str, Any], config: InferenceConfig) -> Dict[str, Any]:
    return dense.convert_hf_state_dict(state_dict, config, build_arch(config))
