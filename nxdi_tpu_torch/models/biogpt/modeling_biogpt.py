"""BioGPT family (counterpart of ``nxdi_tpu/models/biogpt/modeling_biogpt.py``):
the fairseq decoder (``models/fairseq_dense.py``) with learned positions
(offset 2, cut at conversion), the sqrt(H) embedding scale
(``scale_embedding``), a GELU ``fc1`` / ``fc2`` MLP (HF's ``"gelu"`` is the
exact one: :func:`dense.exact_gelu`), a final ``layer_norm`` and a tied
``output_projection``."""

from __future__ import annotations

from typing import Any, Dict

from nxdi_tpu_torch.config import InferenceConfig
from nxdi_tpu_torch.models import dense, fairseq_dense
from nxdi_tpu_torch.models.base import DecoderArch

build_inv_freq = fairseq_dense.build_inv_freq


class BioGptInferenceConfig(fairseq_dense.FairseqInferenceConfig):
    REQUIRED = ["hidden_size", "num_attention_heads", "num_hidden_layers", "vocab_size",
                "intermediate_size"]

    def add_derived_config(self):
        self.num_key_value_heads = self.num_attention_heads
        self.rms_norm_eps = 1e-5  # nn.LayerNorm's default
        self.tie_word_embeddings = bool(getattr(self, "tie_word_embeddings", True))
        super().add_derived_config()


def build_arch(config: InferenceConfig, **overrides) -> DecoderArch:
    kwargs = dict(
        hidden_act=dense.exact_gelu(getattr(config, "hidden_act", "gelu")),
        tie_word_embeddings=bool(getattr(config, "tie_word_embeddings", True)),
        embed_scale=(float(config.hidden_size) ** 0.5
                     if getattr(config, "scale_embedding", True) else None),
    )
    kwargs.update(overrides)
    return fairseq_dense.build_arch(config, **kwargs)


def convert_hf_state_dict(state_dict: Dict[str, Any], config: InferenceConfig) -> Dict[str, Any]:
    return fairseq_dense.convert_hf_state_dict(state_dict, config, build_arch(config),
                                               prefix="biogpt.", final_norm_key="layer_norm")


def random_params(config: InferenceConfig, seed: int = 0, device=None) -> Dict[str, Any]:
    return fairseq_dense.random_params(config, build_arch(config),
                                       config.max_position_embeddings, seed, device)
