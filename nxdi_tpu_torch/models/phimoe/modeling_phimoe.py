"""Phi-3.5-MoE family (counterpart of
``nxdi_tpu/models/phimoe/modeling_phimoe.py``): the Llama lineage with
biased LayerNorms (the ``{"w", "b"}`` norm params of ``models/base._norm``)
in every layer and at the end, q / k / v and o projections with biases,
sparsemixer top-2 routing (``ops/moe.py``) over Mixtral-style experts
(``w1`` / ``w3`` / ``w2``), and optional LongRoPE through the Phi-3 family's
frequency sets.

LongRoPE's cos / sin scale follows HF ``PhimoeRotaryEmbedding``: the
config's ``short_mscale`` / ``long_mscale`` when given, else the LongRoPE
attention factor. The JAX package applies no scale here (ROADMAP Queue 3),
so a LongRoPE Phi-3.5-MoE is held to HF. A scale that differs between the
two regimes is not ported (the config raises).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from nxdi_tpu_torch.config import InferenceConfig, to_torch_dtype
from nxdi_tpu_torch.models import dense
from nxdi_tpu_torch.models.base import DecoderArch
from nxdi_tpu_torch.models.phi3 import modeling_phi3 as phi3
from nxdi_tpu_torch.ops.moe import MoEArch, convert_hf_experts

build_inv_freq = phi3.build_inv_freq

# HF Phimoe expert projections: w1 = gate, w3 = up, w2 = down
_W_NAMES = {"gate": "w1", "up": "w3", "down": "w2"}

# Phi-3.5-MoE at its published widths (HF microsoft/Phi-3.5-MoE-instruct
# config.json) without its LongRoPE factor lists, which only that file holds
PHI_3_5_MOE = dict(
    hidden_size=4096,
    intermediate_size=6400,
    num_hidden_layers=32,
    num_attention_heads=32,
    num_key_value_heads=8,
    vocab_size=32064,
    rms_norm_eps=1e-5,
    rope_theta=10000.0,
    max_position_embeddings=131072,
    original_max_position_embeddings=4096,
    num_local_experts=16,
    num_experts_per_tok=2,
    router_jitter_noise=0.01,
    attention_bias=True,
    lm_head_bias=False,
    sliding_window=None,
    tie_word_embeddings=False,
    hidden_act="silu",
)


class PhimoeInferenceConfig(dense.DenseInferenceConfig):
    def add_derived_config(self):
        super().add_derived_config()
        if getattr(self, "lm_head_bias", False):
            raise NotImplementedError("phimoe lm_head_bias is not supported yet")
        if not hasattr(self, "rms_norm_eps"):
            self.rms_norm_eps = 1e-5
        rs = phi3.longrope_scaling(self)
        if rs is not None and rs.get("short_mscale") != rs.get("long_mscale"):
            raise NotImplementedError(
                "phimoe LongRoPE with short_mscale != long_mscale (a cos/sin scale that "
                "changes with the regime) is not ported")


def _moe_arch(config: InferenceConfig) -> MoEArch:
    return MoEArch(
        num_experts=config.num_local_experts,
        top_k=config.num_experts_per_tok,
        intermediate_size=config.intermediate_size,
        norm_topk_prob=False,
        sparsemixer=True,
        router_jitter=float(getattr(config, "router_jitter_noise", 0.01)),
        dispatch=config.tpu_config.moe_dispatch,
    )


def rope_mscale(config: InferenceConfig) -> float:
    """HF ``PhimoeRotaryEmbedding``'s cos / sin scale under LongRoPE."""
    rs = phi3.longrope_scaling(config)
    if rs is None:
        return 1.0
    if rs.get("short_mscale") is not None:
        return float(rs["short_mscale"])
    return phi3.longrope_tables(config)[1]


def build_arch(config: InferenceConfig, **overrides) -> DecoderArch:
    kwargs: Dict[str, Any] = dict(moe=_moe_arch(config), attention_bias=True,
                                  attention_o_bias=True, layernorm=True)
    if phi3.longrope_scaling(config) is not None:
        kwargs["longrope_original_max"] = int(
            getattr(config, "original_max_position_embeddings", config.max_position_embeddings))
        kwargs["rope_mscale"] = rope_mscale(config)
    kwargs.update(overrides)
    return dense.build_arch(config, **kwargs)


def convert_hf_state_dict(state_dict: Dict[str, Any], config: InferenceConfig) -> Dict[str, Any]:
    arch = build_arch(config)

    def ff(get, has, cast, pre):
        return "moe", convert_hf_experts(
            get, cast, arch.moe.num_experts, pre + "block_sparse_moe.gate.weight",
            lambda j, proj: f"{pre}block_sparse_moe.experts.{j}.{_W_NAMES[proj]}.weight")

    params = dense.convert_hf_state_dict(state_dict, config, arch, ff_converter=ff)

    def src(name):
        for k in (name, f"model.{name}"):
            if k in state_dict:
                return torch.as_tensor(state_dict[k])
        raise KeyError(name)

    # biased LayerNorms: each weight array becomes {"w", "b"}
    dt = to_torch_dtype(arch.dtype)
    layers = params["layers"]
    for key in ("input_layernorm", "post_attention_layernorm"):
        layers[key] = {"w": layers[key], "b": torch.stack(
            [src(f"layers.{i}.{key}.bias") for i in range(arch.num_layers)]).to(dt)}
    params["norm"] = {"w": params["norm"], "b": src("norm.bias").to(dt)}
    return params


def random_params(config: InferenceConfig, seed: int = 0, device=None) -> Dict[str, Any]:
    """Random weights (dense.random_params) with the biased norms, on
    ``device``."""
    arch = build_arch(config)
    return dense.random_params(arch, seed=seed, device=device,
                               shapes=dense.param_shapes(arch, norm_bias=True))
