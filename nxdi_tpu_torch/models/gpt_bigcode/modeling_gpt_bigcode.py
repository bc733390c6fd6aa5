"""GPTBigCode (SantaCoder, StarCoder) family (counterpart of
``nxdi_tpu/models/gpt_bigcode/modeling_gpt_bigcode.py``): GPT-2's layout
with multi-query attention. ``c_attn`` is an nn.Linear whose rows are
[q heads | k | v] with ONE kv head under ``multi_query`` (StarCoder: 48
query heads of 128 on one kv head, G 48), else per-head [q, k, v] blocks;
learned ``wpe`` positions (no offset), biased LayerNorms, a non-gated
tanh-GELU MLP and a tied head."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from nxdi_tpu_torch.config import InferenceConfig, to_torch_dtype
from nxdi_tpu_torch.models import dense, fairseq_dense
from nxdi_tpu_torch.models.base import DecoderArch
from nxdi_tpu_torch.models.gpt_neox.modeling_gpt_neox import deinterleave
from nxdi_tpu_torch.ops.rope import default_inv_freq


class GPTBigCodeInferenceConfig(dense.DenseInferenceConfig):
    REQUIRED = ["n_embd", "n_head", "n_layer", "vocab_size", "n_positions"]

    def add_derived_config(self):
        self.hidden_size = self.n_embd
        self.num_attention_heads = self.n_head
        self.num_hidden_layers = self.n_layer
        self.num_key_value_heads = 1 if getattr(self, "multi_query", True) else self.n_head
        self.intermediate_size = getattr(self, "n_inner", None) or 4 * self.n_embd
        self.rms_norm_eps = getattr(self, "layer_norm_epsilon", 1e-5)
        self.hidden_act = getattr(self, "activation_function", "gelu_pytorch_tanh")
        self.tie_word_embeddings = True
        super().add_derived_config()
        fairseq_dense.check_positions(self, self.n_positions)


def build_arch(config: InferenceConfig, **overrides) -> DecoderArch:
    kwargs = dict(
        learned_pos_embeds=True,
        no_rope=True,
        layernorm=True,
        gated_mlp=False,
        attention_bias=True,
        attention_o_bias=True,
        mlp_bias=True,
        tie_word_embeddings=True,
        hidden_act=getattr(config, "activation_function", "gelu_pytorch_tanh"),
    )
    kwargs.update(overrides)
    return dense.build_arch(config, **kwargs)


def build_inv_freq(config: InferenceConfig) -> np.ndarray:
    # unread (no_rope); the forward's signature takes a table
    return default_inv_freq(config.n_embd // config.n_head, 10000.0)


def convert_hf_state_dict(state_dict: Dict[str, Any], config: InferenceConfig) -> Dict[str, Any]:
    arch = build_arch(config)
    H = config.hidden_size
    heads = config.num_attention_heads
    D = H // heads
    kv_dim = config.num_key_value_heads * D
    L = arch.num_layers

    def src(name):
        return dense.state_tensor(state_dict, name, ("", "transformer."))

    sd = {"embed_tokens.weight": src("wte.weight"), "norm.weight": src("ln_f.weight")}
    for i in range(L):
        pre, dst = f"h.{i}.", f"layers.{i}."
        for kind in ("weight", "bias"):
            ca = src(f"{pre}attn.c_attn.{kind}")  # (H + 2 kv, ...) rows
            qkv = ((ca[:H], ca[H:H + kv_dim], ca[H + kv_dim:])
                   if getattr(config, "multi_query", True) else deinterleave(ca, heads, D))
            for name, t in zip("qkv", qkv):
                sd[f"{dst}self_attn.{name}_proj.{kind}"] = t
            sd[f"{dst}self_attn.o_proj.{kind}"] = src(f"{pre}attn.c_proj.{kind}")
        sd[dst + "input_layernorm.weight"] = src(pre + "ln_1.weight")
        sd[dst + "post_attention_layernorm.weight"] = src(pre + "ln_2.weight")

    def ff(get, has, cast, pre):
        hp = "h." + pre[len("layers."):]
        return "mlp", {"up_proj": {"w": cast(src(hp + "mlp.c_fc.weight").t()),
                                   "b": cast(src(hp + "mlp.c_fc.bias"))},
                       "down_proj": {"w": cast(src(hp + "mlp.c_proj.weight").t()),
                                     "b": cast(src(hp + "mlp.c_proj.bias"))}}

    params = dense.convert_hf_state_dict(sd, config, arch, ff_converter=ff)
    dt = to_torch_dtype(arch.dtype)
    dense.attach_norm_biases(params, [src(f"h.{i}.ln_1.bias") for i in range(L)],
                             [src(f"h.{i}.ln_2.bias") for i in range(L)], src("ln_f.bias"), dt)
    params["position_embeddings"] = src("wpe.weight").to(dt).contiguous()
    return params


def random_params(config: InferenceConfig, seed: int = 0, device=None) -> Dict[str, Any]:
    """Random weights (dense.random_params) with the biased norms and an
    ``n_positions``-row position table."""
    return fairseq_dense.random_params(config, build_arch(config), config.n_positions, seed,
                                       device)
