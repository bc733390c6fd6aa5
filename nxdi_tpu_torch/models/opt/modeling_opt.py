"""OPT family (counterpart of ``nxdi_tpu/models/opt/modeling_opt.py``): the
fairseq decoder (``models/fairseq_dense.py``) with learned positions
(offset 2, cut at conversion), a ReLU ``fc1`` / ``fc2`` MLP and a tied head.
The post-norm 350m variant (``do_layer_norm_before=False``) and the
projected embedding (``word_embed_proj_dim != hidden_size``) are refused, as
the JAX package refuses them."""

from __future__ import annotations

from typing import Any, Dict

from nxdi_tpu_torch.config import InferenceConfig
from nxdi_tpu_torch.models import fairseq_dense
from nxdi_tpu_torch.models.base import DecoderArch

build_inv_freq = fairseq_dense.build_inv_freq


class OPTInferenceConfig(fairseq_dense.FairseqInferenceConfig):
    REQUIRED = ["hidden_size", "num_attention_heads", "num_hidden_layers", "vocab_size"]

    def add_derived_config(self):
        self.num_key_value_heads = self.num_attention_heads
        self.intermediate_size = getattr(self, "ffn_dim", 4 * self.hidden_size)
        self.rms_norm_eps = 1e-5  # nn.LayerNorm's default
        self.hidden_act = getattr(self, "activation_function", "relu")
        self.tie_word_embeddings = bool(getattr(self, "tie_word_embeddings", True))
        super().add_derived_config()
        if not getattr(self, "do_layer_norm_before", True):
            raise NotImplementedError(
                "OPT post-norm variant (do_layer_norm_before=False) is not supported")
        wepd = getattr(self, "word_embed_proj_dim", None)
        if wepd is not None and wepd != self.hidden_size:
            raise NotImplementedError(
                "OPT word_embed_proj_dim != hidden_size (project_in/out) is not supported")


def build_arch(config: InferenceConfig, **overrides) -> DecoderArch:
    kwargs = dict(hidden_act=getattr(config, "activation_function", "relu"),
                  tie_word_embeddings=bool(getattr(config, "tie_word_embeddings", True)))
    kwargs.update(overrides)
    return fairseq_dense.build_arch(config, **kwargs)


def convert_hf_state_dict(state_dict: Dict[str, Any], config: InferenceConfig) -> Dict[str, Any]:
    return fairseq_dense.convert_hf_state_dict(state_dict, config, build_arch(config),
                                               prefix="model.decoder.")


def random_params(config: InferenceConfig, seed: int = 0, device=None) -> Dict[str, Any]:
    return fairseq_dense.random_params(config, build_arch(config),
                                       config.max_position_embeddings, seed, device)
