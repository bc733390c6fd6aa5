"""XGLM family (counterpart of ``nxdi_tpu/models/xglm/modeling_xglm.py``):
the fairseq decoder (``models/fairseq_dense.py``) with FIXED sinusoidal
positions (HF XGLMSinusoidalPositionalEmbedding: [sin | cos] halves, offset
2, the padding row zeroed), made at conversion into the position table; the
sqrt(H) embedding scale, a GELU ``fc1`` / ``fc2`` MLP (HF's ``"gelu"`` is
the exact one: :func:`dense.exact_gelu`), a final ``layer_norm`` and a tied
head."""

from __future__ import annotations

from typing import Any, Dict

from nxdi_tpu_torch.config import InferenceConfig
from nxdi_tpu_torch.models import dense, fairseq_dense
from nxdi_tpu_torch.models.base import DecoderArch

build_inv_freq = fairseq_dense.build_inv_freq
OFFSET = 2  # the fairseq offset of the sinusoid's rows


class XGLMInferenceConfig(fairseq_dense.FairseqInferenceConfig):
    REQUIRED = ["d_model", "attention_heads", "num_layers", "vocab_size", "ffn_dim"]

    def add_derived_config(self):
        self.hidden_size = self.d_model
        self.num_attention_heads = self.attention_heads
        self.num_hidden_layers = self.num_layers
        self.num_key_value_heads = self.attention_heads
        self.intermediate_size = self.ffn_dim
        self.rms_norm_eps = 1e-5  # nn.LayerNorm's default
        self.hidden_act = getattr(self, "activation_function", "gelu")
        self.tie_word_embeddings = bool(getattr(self, "tie_word_embeddings", True))
        super().add_derived_config()


def build_arch(config: InferenceConfig, **overrides) -> DecoderArch:
    kwargs = dict(
        hidden_act=dense.exact_gelu(getattr(config, "activation_function", "gelu")),
        tie_word_embeddings=bool(getattr(config, "tie_word_embeddings", True)),
        embed_scale=(float(config.d_model) ** 0.5
                     if getattr(config, "scale_embedding", True) else None),
    )
    kwargs.update(overrides)
    return fairseq_dense.build_arch(config, **kwargs)


def convert_hf_state_dict(state_dict: Dict[str, Any], config: InferenceConfig) -> Dict[str, Any]:
    table = fairseq_dense.sinusoid_table(config.max_position_embeddings + OFFSET,
                                         config.d_model, getattr(config, "pad_token_id", 1))
    return fairseq_dense.convert_hf_state_dict(
        state_dict, config, build_arch(config), prefix="model.", pos_table=lambda: table,
        pos_offset=OFFSET, final_norm_key="layer_norm")


def random_params(config: InferenceConfig, seed: int = 0, device=None) -> Dict[str, Any]:
    return fairseq_dense.random_params(config, build_arch(config),
                                       config.max_position_embeddings, seed, device)
