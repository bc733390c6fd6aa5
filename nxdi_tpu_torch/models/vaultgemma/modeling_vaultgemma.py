"""VaultGemma family (counterpart of
``nxdi_tpu/models/vaultgemma/modeling_vaultgemma.py``): Gemma-2's soft caps
and alternating windows WITHOUT the sandwich norms. Two norms a layer: the
input norm and ``pre_feedforward_layernorm``, which maps onto the
``post_attention_layernorm`` slot (the pre-MLP norm of the Llama layout);
(1 + w) float32 norms, sqrt(hidden) embedding scale,
``query_pre_attn_scalar`` softmax scaling, ``layer_types`` windows, one rope
table. Held at test widths only: the published widths wait for VaultGemma's
``config.json`` in the repository.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from nxdi_tpu_torch.config import InferenceConfig
from nxdi_tpu_torch.models import dense
from nxdi_tpu_torch.models.base import DecoderArch

build_inv_freq = dense.build_inv_freq


class VaultGemmaInferenceConfig(dense.DenseInferenceConfig):
    REQUIRED = dense.DenseInferenceConfig.REQUIRED + ["head_dim"]

    def add_derived_config(self):
        if getattr(self, "hidden_activation", None):
            self.hidden_act = self.hidden_activation
        elif not hasattr(self, "hidden_act"):
            self.hidden_act = "gelu_pytorch_tanh"
        super().add_derived_config()
        defaults = {
            "query_pre_attn_scalar": self.head_dim,
            "sliding_window": None,
            "attn_logit_softcapping": None,
            "final_logit_softcapping": None,
        }
        for k, v in defaults.items():
            if not hasattr(self, k):
                setattr(self, k, v)
        if getattr(self, "layer_types", None) is None:
            self.layer_types = ["sliding_attention" if i % 2 == 0 else "full_attention"
                                for i in range(self.num_hidden_layers)]


def sliding_flags(config: InferenceConfig) -> Tuple[bool, ...]:
    return tuple(t == "sliding_attention" for t in config.layer_types)


def build_arch(config: InferenceConfig, **overrides) -> DecoderArch:
    sw = getattr(config, "sliding_window", None)
    kwargs = dict(
        gemma_norm=True,
        embed_scale=float(config.hidden_size) ** 0.5,
        sliding_window=sw,
        # window_sized_kv: the full-attention layers stay off the ring
        kv_window_pattern=sliding_flags(config) if sw else None,
        attention_scale=float(config.query_pre_attn_scalar) ** -0.5,
        attn_logit_softcap=getattr(config, "attn_logit_softcapping", None),
        final_logit_softcap=getattr(config, "final_logit_softcapping", None),
        tie_word_embeddings=bool(getattr(config, "tie_word_embeddings", True)),
    )
    kwargs.update(overrides)
    return dense.build_arch(config, **kwargs)


def _add_flags(params: Dict[str, Any], config: InferenceConfig) -> Dict[str, Any]:
    """A mixed stack's ``use_sliding_window`` flags (none when every layer
    slides, as in the JAX package)."""
    flags = sliding_flags(config)
    if getattr(config, "sliding_window", None) and not all(flags):
        params["layers"]["use_sliding_window"] = torch.tensor(flags,
                                                              device=params["norm"].device)
    return params


def convert_hf_state_dict(state_dict: Dict[str, Any], config: InferenceConfig) -> Dict[str, Any]:
    sd = {k.replace("pre_feedforward_layernorm", "post_attention_layernorm"): v
          for k, v in state_dict.items()}
    return _add_flags(dense.convert_hf_state_dict(sd, config, build_arch(config)), config)


def random_params(config: InferenceConfig, seed: int = 0, device=None) -> Dict[str, Any]:
    """Random weights with the window flags, on ``device``."""
    return _add_flags(dense.random_params(build_arch(config), seed=seed, device=device), config)
