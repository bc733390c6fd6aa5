"""Phi (phi-1, 1.5, 2) family (counterpart of
``nxdi_tpu/models/phi/modeling_phi.py``): the parallel block under ONE
shared LayerNorm (aliased onto the MLP's norm at conversion), rope over
``head_dim * partial_rotary_factor`` channels, biases everywhere, the tanh
GELU ``fc1`` / ``fc2`` MLP, a final LayerNorm and a biased LM head
(``params["lm_head_bias"]``, float32, added to the logits)."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from nxdi_tpu_torch.config import InferenceConfig, to_torch_dtype
from nxdi_tpu_torch.models import dense
from nxdi_tpu_torch.models.base import DecoderArch
from nxdi_tpu_torch.ops.rope import default_inv_freq


class PhiInferenceConfig(dense.DenseInferenceConfig):
    REQUIRED = ["hidden_size", "num_attention_heads", "num_hidden_layers", "vocab_size",
                "intermediate_size"]

    def add_derived_config(self):
        if getattr(self, "num_key_value_heads", None) is None:
            self.num_key_value_heads = self.num_attention_heads
        self.rms_norm_eps = getattr(self, "layer_norm_eps", 1e-5)
        if not hasattr(self, "partial_rotary_factor"):
            self.partial_rotary_factor = 0.5
        if not hasattr(self, "hidden_act"):
            self.hidden_act = "gelu_new"
        self.tie_word_embeddings = False
        super().add_derived_config()
        if getattr(self, "qk_layernorm", False):
            raise NotImplementedError("phi qk_layernorm is not supported yet")


def _rotary_dim(config) -> int:
    return int(config.hidden_size // config.num_attention_heads * config.partial_rotary_factor)


def build_arch(config: InferenceConfig, **overrides) -> DecoderArch:
    kwargs = dict(
        layernorm=True,
        parallel_block=True,
        gated_mlp=False,
        attention_bias=True,
        attention_o_bias=True,
        mlp_bias=True,
        rotary_dim=_rotary_dim(config),
        hidden_act=getattr(config, "hidden_act", "gelu_new"),
        tie_word_embeddings=False,
        lm_head_bias=True,
    )
    kwargs.update(overrides)
    return dense.build_arch(config, **kwargs)


def build_inv_freq(config: InferenceConfig) -> np.ndarray:
    return default_inv_freq(_rotary_dim(config), getattr(config, "rope_theta", 10000.0))


def convert_hf_state_dict(state_dict: Dict[str, Any], config: InferenceConfig) -> Dict[str, Any]:
    arch = build_arch(config)

    def src(name):
        return dense.state_tensor(state_dict, name)

    sd = {"embed_tokens.weight": src("embed_tokens.weight"),
          "norm.weight": src("final_layernorm.weight"),
          "lm_head.weight": state_dict["lm_head.weight"]}
    L = arch.num_layers
    for i in range(L):
        pre = f"layers.{i}."
        for proj in "qkv":
            for kind in ("weight", "bias"):
                sd[f"{pre}self_attn.{proj}_proj.{kind}"] = src(f"{pre}self_attn.{proj}_proj.{kind}")
        for kind in ("weight", "bias"):
            sd[f"{pre}self_attn.o_proj.{kind}"] = src(f"{pre}self_attn.dense.{kind}")
        # ONE norm: aliased onto both of the parallel block's norms
        sd[pre + "input_layernorm.weight"] = src(pre + "input_layernorm.weight")
        sd[pre + "post_attention_layernorm.weight"] = src(pre + "input_layernorm.weight")

    def ff(get, has, cast, pre):
        return "mlp", {"up_proj": {"w": cast(src(pre + "mlp.fc1.weight").t()),
                                   "b": cast(src(pre + "mlp.fc1.bias"))},
                       "down_proj": {"w": cast(src(pre + "mlp.fc2.weight").t()),
                                     "b": cast(src(pre + "mlp.fc2.bias"))}}

    params = dense.convert_hf_state_dict(sd, config, arch, ff_converter=ff)
    biases = [src(f"layers.{i}.input_layernorm.bias") for i in range(L)]
    dense.attach_norm_biases(params, biases, biases, src("final_layernorm.bias"),
                             to_torch_dtype(arch.dtype))
    head_bias = torch.as_tensor(state_dict["lm_head.bias"]).float()
    if arch.vocab_pad:
        head_bias = torch.cat([head_bias, head_bias.new_zeros(arch.vocab_pad)])
    params["lm_head_bias"] = head_bias
    return params


def random_params(config: InferenceConfig, seed: int = 0, device=None) -> Dict[str, Any]:
    """Random weights (dense.random_params) with the biased norms and the
    head's bias."""
    arch = build_arch(config)
    return dense.random_params(arch, seed=seed, device=device,
                               shapes=dense.param_shapes(arch, norm_bias=True))
