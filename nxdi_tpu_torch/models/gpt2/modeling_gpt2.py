"""GPT-2 family (counterpart of ``nxdi_tpu/models/gpt2/modeling_gpt2.py``):
learned position embeddings (``wpe``, no offset, no rope), biased pre-norm
LayerNorms, a fused ``c_attn`` stored in Conv1D's (in, out) orientation, a
non-gated tanh-GELU MLP and a tied head. A ``seq_len`` past ``n_positions``
is refused (the JAX package's rule)."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from nxdi_tpu_torch.config import InferenceConfig, to_torch_dtype
from nxdi_tpu_torch.models import dense, fairseq_dense
from nxdi_tpu_torch.models.base import DecoderArch
from nxdi_tpu_torch.ops.rope import default_inv_freq


class GPT2InferenceConfig(dense.DenseInferenceConfig):
    REQUIRED = ["n_embd", "n_head", "n_layer", "vocab_size", "n_positions"]

    def add_derived_config(self):
        self.hidden_size = self.n_embd
        self.num_attention_heads = self.n_head
        self.num_hidden_layers = self.n_layer
        self.num_key_value_heads = self.n_head
        self.intermediate_size = getattr(self, "n_inner", None) or 4 * self.n_embd
        self.rms_norm_eps = getattr(self, "layer_norm_epsilon", 1e-5)
        self.hidden_act = getattr(self, "activation_function", "gelu_new")
        self.tie_word_embeddings = True
        self.rope_theta = 10000.0  # unread (no_rope)
        self.rope_scaling = None
        super().add_derived_config()
        fairseq_dense.check_positions(self, self.n_positions)


def build_arch(config: InferenceConfig, **overrides) -> DecoderArch:
    kwargs = dict(
        learned_pos_embeds=True,
        no_rope=True,
        gated_mlp=False,
        attention_bias=True,
        attention_o_bias=True,
        mlp_bias=True,
        tie_word_embeddings=True,
    )
    kwargs.update(overrides)
    return dense.build_arch(config, **kwargs)


def build_inv_freq(config: InferenceConfig) -> np.ndarray:
    # unread (no_rope); the forward's signature takes a table
    return default_inv_freq(config.hidden_size // config.num_attention_heads, 10000.0)


def convert_hf_state_dict(state_dict: Dict[str, Any], config: InferenceConfig) -> Dict[str, Any]:
    """GPT-2's HF layout into the dense one. Conv1D weights are stored (in,
    out), the dense converter takes HF's (out, in): the splits transpose."""
    arch = build_arch(config)
    H = config.hidden_size
    L = arch.num_layers

    def src(name):
        return dense.state_tensor(state_dict, name, ("", "transformer."))

    sd = {"embed_tokens.weight": src("wte.weight"), "norm.weight": src("ln_f.weight")}
    for i in range(L):
        pre, dst = f"h.{i}.", f"layers.{i}."
        ca_w, ca_b = src(pre + "attn.c_attn.weight"), src(pre + "attn.c_attn.bias")
        for j, name in enumerate("qkv"):
            sd[f"{dst}self_attn.{name}_proj.weight"] = ca_w[:, j * H:(j + 1) * H].t()
            sd[f"{dst}self_attn.{name}_proj.bias"] = ca_b[j * H:(j + 1) * H]
        sd[dst + "self_attn.o_proj.weight"] = src(pre + "attn.c_proj.weight").t()
        sd[dst + "self_attn.o_proj.bias"] = src(pre + "attn.c_proj.bias")
        sd[dst + "input_layernorm.weight"] = src(pre + "ln_1.weight")
        sd[dst + "post_attention_layernorm.weight"] = src(pre + "ln_2.weight")

    def ff(get, has, cast, pre):
        hp = "h." + pre[len("layers."):]
        return "mlp", {"up_proj": {"w": cast(src(hp + "mlp.c_fc.weight")),
                                   "b": cast(src(hp + "mlp.c_fc.bias"))},
                       "down_proj": {"w": cast(src(hp + "mlp.c_proj.weight")),
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
