"""GPT-NeoX (Pythia) family (counterpart of
``nxdi_tpu/models/gpt_neox/modeling_gpt_neox.py``): the parallel residual
(``use_parallel_residual``, default on: x + attn(ln1(x)) + mlp(ln2(x));
off: the sequential block), a ``query_key_value`` of per-head [q | k | v]
blocks, de-interleaved at conversion, rope over ``head_dim * rotary_pct``
channels, biased LayerNorms, a non-gated MLP with biases, ``embed_in`` /
``embed_out``. HF's ``"gelu"`` is the exact GELU (:func:`dense.exact_gelu`)."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from nxdi_tpu_torch.config import InferenceConfig, to_torch_dtype
from nxdi_tpu_torch.models import dense
from nxdi_tpu_torch.models.base import DecoderArch
from nxdi_tpu_torch.ops.rope import default_inv_freq


class GPTNeoXInferenceConfig(dense.DenseInferenceConfig):
    def add_derived_config(self):
        self.rms_norm_eps = getattr(self, "layer_norm_eps", 1e-5)
        self.num_key_value_heads = self.num_attention_heads  # NeoX is multi-head
        if not hasattr(self, "rotary_pct"):
            self.rotary_pct = 0.25
        if not hasattr(self, "use_parallel_residual"):
            self.use_parallel_residual = True
        if not hasattr(self, "hidden_act"):
            self.hidden_act = "gelu"
        super().add_derived_config()


def _rotary_dim(config) -> int:
    return int(config.hidden_size // config.num_attention_heads * config.rotary_pct)


def build_arch(config: InferenceConfig, **overrides) -> DecoderArch:
    bias = bool(getattr(config, "attention_bias", True))
    kwargs = dict(
        parallel_block=bool(getattr(config, "use_parallel_residual", True)),
        layernorm=True,
        gated_mlp=False,
        attention_bias=bias,
        attention_o_bias=bias,
        mlp_bias=True,
        rotary_dim=_rotary_dim(config),
        hidden_act=dense.exact_gelu(getattr(config, "hidden_act", "gelu")),
    )
    kwargs.update(overrides)
    return dense.build_arch(config, **kwargs)


def build_inv_freq(config: InferenceConfig) -> np.ndarray:
    theta = getattr(config, "rope_theta", None) or getattr(config, "rotary_emb_base", 10000.0)
    return default_inv_freq(_rotary_dim(config), float(theta))


def deinterleave(w, heads: int, D: int):
    """(heads * 3 * D, ...) rows of per-head [q, k, v] blocks -> three
    (heads * D, ...) tensors (GPT-NeoX, Persimmon, multi-head BigCode)."""
    rest = tuple(w.shape[1:])
    t = w.reshape((heads, 3, D) + rest)
    return tuple(t[:, j].reshape((heads * D,) + rest) for j in range(3))


def convert_hf_state_dict(state_dict: Dict[str, Any], config: InferenceConfig) -> Dict[str, Any]:
    arch = build_arch(config)
    H = config.num_attention_heads
    D = config.hidden_size // H

    def src(name):
        return dense.state_tensor(state_dict, name, ("", "gpt_neox."))

    sd = {"embed_tokens.weight": src("embed_in.weight"),
          "norm.weight": src("final_layer_norm.weight")}
    if "embed_out.weight" in state_dict:
        sd["lm_head.weight"] = state_dict["embed_out.weight"]
    for i in range(arch.num_layers):
        p = f"layers.{i}."
        for name, t in zip("qkv", deinterleave(src(p + "attention.query_key_value.weight"), H, D)):
            sd[f"{p}self_attn.{name}_proj.weight"] = t
        if arch.attention_bias:
            for name, t in zip("qkv", deinterleave(src(p + "attention.query_key_value.bias"),
                                                   H, D)):
                sd[f"{p}self_attn.{name}_proj.bias"] = t
            sd[p + "self_attn.o_proj.bias"] = src(p + "attention.dense.bias")
        sd[p + "self_attn.o_proj.weight"] = src(p + "attention.dense.weight")
        for key in ("input_layernorm", "post_attention_layernorm"):
            sd[f"{p}{key}.weight"] = src(f"{p}{key}.weight")

    def ff(get, has, cast, pre):
        return "mlp", {"up_proj": {"w": cast(src(pre + "mlp.dense_h_to_4h.weight").t()),
                                   "b": cast(src(pre + "mlp.dense_h_to_4h.bias"))},
                       "down_proj": {"w": cast(src(pre + "mlp.dense_4h_to_h.weight").t()),
                                     "b": cast(src(pre + "mlp.dense_4h_to_h.bias"))}}

    params = dense.convert_hf_state_dict(sd, config, arch, ff_converter=ff)
    L = arch.num_layers
    return dense.attach_norm_biases(
        params, [src(f"layers.{i}.input_layernorm.bias") for i in range(L)],
        [src(f"layers.{i}.post_attention_layernorm.bias") for i in range(L)],
        src("final_layer_norm.bias"), to_torch_dtype(arch.dtype))


def random_params(config: InferenceConfig, seed: int = 0, device=None) -> Dict[str, Any]:
    """Random weights (dense.random_params) with the biased norms."""
    arch = build_arch(config)
    return dense.random_params(arch, seed=seed, device=device,
                               shapes=dense.param_shapes(arch, norm_bias=True))
