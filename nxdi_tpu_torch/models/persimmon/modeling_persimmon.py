"""Persimmon family (counterpart of
``nxdi_tpu/models/persimmon/modeling_persimmon.py``): a ``query_key_value``
of per-head [q | k | v] blocks (de-interleaved at conversion), per-head
biased q / k LayerNorms over head_dim before rope (``{"w", "b"}`` dicts on
``attn.q_norm`` / ``attn.k_norm``), rope over ``head_dim *
partial_rotary_factor`` channels, the squared-ReLU ``dense_h_to_4h`` /
``dense_4h_to_h`` MLP, biases everywhere, biased block norms and an untied
head."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from nxdi_tpu_torch.config import InferenceConfig, to_torch_dtype
from nxdi_tpu_torch.models import dense
from nxdi_tpu_torch.models.base import DecoderArch
from nxdi_tpu_torch.models.gpt_neox.modeling_gpt_neox import deinterleave
from nxdi_tpu_torch.ops.rope import default_inv_freq


class PersimmonInferenceConfig(dense.DenseInferenceConfig):
    REQUIRED = ["hidden_size", "num_attention_heads", "num_hidden_layers", "vocab_size",
                "intermediate_size"]

    def add_derived_config(self):
        self.num_key_value_heads = self.num_attention_heads
        self.rms_norm_eps = getattr(self, "layer_norm_eps", 1e-5)
        for key, default in (("partial_rotary_factor", 0.5), ("qk_layernorm", True),
                             ("hidden_act", "relu2"), ("rope_theta", 25000.0)):
            if not hasattr(self, key):
                setattr(self, key, default)
        self.tie_word_embeddings = False
        super().add_derived_config()


def _rotary_dim(config) -> int:
    return int(config.hidden_size // config.num_attention_heads * config.partial_rotary_factor)


def build_arch(config: InferenceConfig, **overrides) -> DecoderArch:
    kwargs = dict(
        layernorm=True,
        gated_mlp=False,
        attention_bias=True,
        attention_o_bias=True,
        mlp_bias=True,
        qk_norm=bool(getattr(config, "qk_layernorm", True)),
        rotary_dim=_rotary_dim(config),
        hidden_act=getattr(config, "hidden_act", "relu2"),
        tie_word_embeddings=False,
    )
    kwargs.update(overrides)
    return dense.build_arch(config, **kwargs)


def build_inv_freq(config: InferenceConfig) -> np.ndarray:
    return default_inv_freq(_rotary_dim(config), getattr(config, "rope_theta", 25000.0))


def convert_hf_state_dict(state_dict: Dict[str, Any], config: InferenceConfig) -> Dict[str, Any]:
    arch = build_arch(config)
    heads = config.num_attention_heads
    D = config.hidden_size // heads
    L = arch.num_layers
    dt = to_torch_dtype(arch.dtype)

    def src(name):
        return dense.state_tensor(state_dict, name)

    sd = {"embed_tokens.weight": src("embed_tokens.weight"),
          "norm.weight": src("final_layernorm.weight"),
          "lm_head.weight": state_dict["lm_head.weight"]}
    for i in range(L):
        pre = f"layers.{i}."
        for kind in ("weight", "bias"):
            qkv = deinterleave(src(f"{pre}self_attn.query_key_value.{kind}"), heads, D)
            for name, t in zip("qkv", qkv):
                sd[f"{pre}self_attn.{name}_proj.{kind}"] = t
            sd[f"{pre}self_attn.o_proj.{kind}"] = src(f"{pre}self_attn.dense.{kind}")
        for key in ("input_layernorm", "post_attention_layernorm"):
            sd[f"{pre}{key}.weight"] = src(f"{pre}{key}.weight")

    def ff(get, has, cast, pre):
        return "mlp", {"up_proj": {"w": cast(src(pre + "mlp.dense_h_to_4h.weight").t()),
                                   "b": cast(src(pre + "mlp.dense_h_to_4h.bias"))},
                       "down_proj": {"w": cast(src(pre + "mlp.dense_4h_to_h.weight").t()),
                                     "b": cast(src(pre + "mlp.dense_4h_to_h.bias"))}}

    # the per-head biased q / k norms: {"w", "b"} dicts, which _norm takes as
    # a biased LayerNorm (the block norms' eps)
    qk = arch.qk_norm
    arch_plain = build_arch(config, qk_norm=False)
    params = dense.convert_hf_state_dict(sd, config, arch_plain if qk else arch, ff_converter=ff)
    dense.attach_norm_biases(
        params, [src(f"layers.{i}.input_layernorm.bias") for i in range(L)],
        [src(f"layers.{i}.post_attention_layernorm.bias") for i in range(L)],
        src("final_layernorm.bias"), dt)
    if qk:
        attn = params["layers"]["attn"]
        for ours, hf in (("q_norm", "q_layernorm"), ("k_norm", "k_layernorm")):
            attn[ours] = {k: torch.stack([src(f"layers.{i}.self_attn.{hf}.{kind}")
                                          for i in range(L)]).to(dt)
                          for k, kind in (("w", "weight"), ("b", "bias"))}
    return params


def random_params(config: InferenceConfig, seed: int = 0, device=None) -> Dict[str, Any]:
    """Random weights (dense.random_params) with the biased block and q / k
    norms."""
    arch = build_arch(config)
    shapes = dense.param_shapes(arch, norm_bias=True)
    attn = shapes["layers"]["attn"]
    if arch.qk_norm:
        for key in ("q_norm", "k_norm"):
            attn[key] = {"w": attn[key], "b": attn[key]}
    return dense.random_params(arch, seed=seed, device=device, shapes=shapes)
