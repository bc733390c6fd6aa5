"""Falcon family (counterpart of ``nxdi_tpu/models/falcon/modeling_falcon.py``):
a fused ``query_key_value`` in three historical layouts, the parallel
attention + MLP block, biased LayerNorms and a non-gated MLP:

- Falcon-7B: ``multi_query`` (one kv head after the query rows) and
  ``parallel_attn`` under ONE shared ``input_layernorm``, which the
  converter aliases onto the parallel block's MLP norm;
- Falcon-40B / 180B (``new_decoder_architecture``): per-kv-group
  [G x q | k | v] rows and two parallel norms (``ln_attn`` / ``ln_mlp``);
- Falcon-RW (neither): per-head [q, k, v] rows, a sequential block.

ALiBi checkpoints are refused (rope only). HF's ``"gelu"`` is the exact GELU
(:func:`dense.exact_gelu`)."""

from __future__ import annotations

from typing import Any, Dict

import torch

from nxdi_tpu_torch.config import InferenceConfig, to_torch_dtype
from nxdi_tpu_torch.models import dense
from nxdi_tpu_torch.models.base import DecoderArch

build_inv_freq = dense.build_inv_freq

# Falcon-7B at its published widths (HF tiiuae/falcon-7b config.json): 71
# query heads of 64 over ONE kv head (G 71), parallel attention under one
# norm, no biases, tied embeddings; the config's defaults give the MLP 4 x
# hidden and rope theta 1e4
FALCON_7B = dict(
    hidden_size=4544,
    num_hidden_layers=32,
    num_attention_heads=71,
    vocab_size=65024,
    layer_norm_epsilon=1e-5,
    multi_query=True,
    parallel_attn=True,
    new_decoder_architecture=False,
    bias=False,
    alibi=False,
    rope_theta=10000.0,
    max_position_embeddings=2048,
    tie_word_embeddings=True,
)


class FalconInferenceConfig(dense.DenseInferenceConfig):
    REQUIRED = ["hidden_size", "num_attention_heads", "num_hidden_layers", "vocab_size"]

    def add_derived_config(self):
        if getattr(self, "new_decoder_architecture", False):
            self.num_key_value_heads = getattr(self, "num_kv_heads", self.num_attention_heads)
        elif getattr(self, "multi_query", True):
            self.num_key_value_heads = 1
        else:
            self.num_key_value_heads = self.num_attention_heads
        self.intermediate_size = getattr(self, "ffn_hidden_size", None) or 4 * self.hidden_size
        self.rms_norm_eps = getattr(self, "layer_norm_epsilon", 1e-5)
        self.hidden_act = getattr(self, "activation", "gelu")
        if not hasattr(self, "tie_word_embeddings"):
            self.tie_word_embeddings = True
        super().add_derived_config()
        if getattr(self, "alibi", False):
            raise NotImplementedError("falcon ALiBi checkpoints are not supported (rope only)")


def _parallel(config) -> bool:
    return bool(getattr(config, "parallel_attn", True)) or bool(
        getattr(config, "new_decoder_architecture", False))


def build_arch(config: InferenceConfig, **overrides) -> DecoderArch:
    bias = bool(getattr(config, "bias", False))
    kwargs = dict(
        layernorm=True,
        gated_mlp=False,
        parallel_block=_parallel(config),
        attention_bias=bias,
        attention_o_bias=bias,
        mlp_bias=bias,
        hidden_act=dense.exact_gelu(getattr(config, "activation", "gelu")),
        tie_word_embeddings=bool(getattr(config, "tie_word_embeddings", True)),
    )
    kwargs.update(overrides)
    return dense.build_arch(config, **kwargs)


def split_qkv(w: torch.Tensor, config, D: int):
    """HF's fused query_key_value rows (a weight or a bias) -> (q, k, v) in
    HF's (out, ...) layout, as FalconAttention._split_heads reads them."""
    heads, rest = config.num_attention_heads, tuple(w.shape[1:])
    if getattr(config, "new_decoder_architecture", False):
        kv = config.num_key_value_heads
        g = heads // kv
        blocks = w.reshape((kv, g + 2, D) + rest)
        return (blocks[:, :g].reshape((heads * D,) + rest),
                blocks[:, g].reshape((kv * D,) + rest),
                blocks[:, g + 1].reshape((kv * D,) + rest))
    if getattr(config, "multi_query", True):
        return w[: heads * D], w[heads * D:(heads + 1) * D], w[(heads + 1) * D:]
    t = w.reshape((heads, 3, D) + rest)
    return tuple(t[:, j].reshape((heads * D,) + rest) for j in range(3))


def convert_hf_state_dict(state_dict: Dict[str, Any], config: InferenceConfig) -> Dict[str, Any]:
    arch = build_arch(config)
    D = config.hidden_size // config.num_attention_heads
    two_ln = bool(getattr(config, "new_decoder_architecture", False)) and (
        getattr(config, "num_ln_in_parallel_attn", None) in (None, 2))

    def src(name):
        return dense.state_tensor(state_dict, name, ("", "transformer."))

    def has(name):
        return name in state_dict or f"transformer.{name}" in state_dict

    sd: Dict[str, torch.Tensor] = {"embed_tokens.weight": src("word_embeddings.weight"),
                                   "norm.weight": src("ln_f.weight")}
    if "lm_head.weight" in state_dict:
        sd["lm_head.weight"] = torch.as_tensor(state_dict["lm_head.weight"])
    ins, posts = [], []
    for i in range(arch.num_layers):
        pre, dst = f"h.{i}.", f"layers.{i}."
        for name, t in zip("qkv", split_qkv(src(pre + "self_attention.query_key_value.weight"),
                                            config, D)):
            sd[f"{dst}self_attn.{name}_proj.weight"] = t
        if arch.attention_bias:
            for name, t in zip("qkv", split_qkv(src(pre + "self_attention.query_key_value.bias"),
                                                config, D)):
                sd[f"{dst}self_attn.{name}_proj.bias"] = t
        sd[dst + "self_attn.o_proj.weight"] = src(pre + "self_attention.dense.weight")
        if arch.attention_o_bias:
            sd[dst + "self_attn.o_proj.bias"] = src(pre + "self_attention.dense.bias")
        if two_ln:
            a, b = "ln_attn", "ln_mlp"
        elif has(pre + "post_attention_layernorm.weight"):  # sequential Falcon-RW
            a, b = "input_layernorm", "post_attention_layernorm"
        else:  # one parallel norm: aliased onto the MLP's
            a = b = "input_layernorm"
        sd[dst + "input_layernorm.weight"] = src(f"{pre}{a}.weight")
        sd[dst + "post_attention_layernorm.weight"] = src(f"{pre}{b}.weight")
        ins.append(src(f"{pre}{a}.bias"))
        posts.append(src(f"{pre}{b}.bias"))

    def ff(get, has_, cast, pre):
        hp = "h." + pre[len("layers."):]
        mlp = {"up_proj": {"w": cast(src(hp + "mlp.dense_h_to_4h.weight").t())},
               "down_proj": {"w": cast(src(hp + "mlp.dense_4h_to_h.weight").t())}}
        if arch.mlp_bias:
            mlp["up_proj"]["b"] = cast(src(hp + "mlp.dense_h_to_4h.bias"))
            mlp["down_proj"]["b"] = cast(src(hp + "mlp.dense_4h_to_h.bias"))
        return "mlp", mlp

    params = dense.convert_hf_state_dict(sd, config, arch, ff_converter=ff)
    return dense.attach_norm_biases(params, ins, posts, src("ln_f.bias"),
                                    to_torch_dtype(arch.dtype))


def random_params(config: InferenceConfig, seed: int = 0, device=None) -> Dict[str, Any]:
    """Random weights (dense.random_params) with the biased norms (unit
    weights and zero biases, so the parallel block's two norms agree as the
    converter's alias does)."""
    arch = build_arch(config)
    return dense.random_params(arch, seed=seed, device=device,
                               shapes=dense.param_shapes(arch, norm_bias=True))
