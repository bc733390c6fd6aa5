"""MiniMax-M2 family (counterpart of
``nxdi_tpu/models/minimax_m2/modeling_minimax_m2.py``): 256 sigmoid-routed
experts in every layer (selection over scores plus
``e_score_correction_bias``, weights from the uncorrected scores,
renormalised), RMSNorm over the FLAT q / k projections before the head
reshape (``qk_norm_flat``: q's mean square over the true, unpadded width),
and partial rotary (``rotary_dim`` 64 of head dim 128, the frequency table
built at ``rotary_dim``). Multi-token-prediction weights in a checkpoint
are dropped: the causal trunk serves.

HF layout: Llama attention with flat ``q_norm`` / ``k_norm`` vectors, and
``block_sparse_moe`` with ``gate``, ``experts.{j}.w1`` / ``w3`` / ``w2``
(gate / up / down) and ``e_score_correction_bias``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from nxdi_tpu_torch.config import InferenceConfig, to_torch_dtype
from nxdi_tpu_torch.models import dense
from nxdi_tpu_torch.models.base import DecoderArch
from nxdi_tpu_torch.ops.moe import MoEArch, convert_hf_experts
from nxdi_tpu_torch.ops.rope import inv_freq_from_hf_config
from nxdi_tpu_torch.parallel import gqa

_W_NAMES = {"gate": "w1", "up": "w3", "down": "w2"}

# MiniMax-M2 at its published widths (HF MiniMaxAI/MiniMax-M2 config.json)
MINIMAX_M2 = dict(
    hidden_size=3072,
    intermediate_size=1536,
    num_hidden_layers=62,
    num_attention_heads=48,
    num_key_value_heads=8,
    head_dim=128,
    rotary_dim=64,
    use_qk_norm=True,
    num_local_experts=256,
    num_experts_per_tok=8,
    vocab_size=200064,
    rms_norm_eps=1e-6,
    rope_theta=5000000.0,
    max_position_embeddings=196608,
    tie_word_embeddings=False,
    hidden_act="silu",
)


class MiniMaxM2InferenceConfig(dense.DenseInferenceConfig):
    REQUIRED = dense.DenseInferenceConfig.REQUIRED + [
        "num_local_experts",
        "num_experts_per_tok",
        "rotary_dim",
        "use_qk_norm",
    ]


def _moe_arch(config: InferenceConfig) -> MoEArch:
    return MoEArch(
        num_experts=config.num_local_experts,
        top_k=config.num_experts_per_tok,
        intermediate_size=config.intermediate_size,
        hidden_act=getattr(config, "hidden_act", "silu"),
        norm_topk_prob=True,
        sigmoid_routing=True,
        correction_bias=True,
        dispatch=config.tpu_config.moe_dispatch,
    )


def build_arch(config: InferenceConfig, **overrides) -> DecoderArch:
    rd = int(getattr(config, "rotary_dim", 0) or 0)
    kwargs: Dict[str, Any] = {"moe": _moe_arch(config)}
    if rd and rd < dense.head_dim_of(config):
        kwargs["rotary_dim"] = rd
    if getattr(config, "use_qk_norm", False):
        kwargs["qk_norm_flat"] = True
        kwargs["qk_norm_flat_qdim"] = config.num_attention_heads * dense.head_dim_of(config)
    kwargs.update(overrides)
    return dense.build_arch(config, **kwargs)


def build_inv_freq(config: InferenceConfig) -> np.ndarray:
    rd = int(getattr(config, "rotary_dim", 0) or 0) or dense.head_dim_of(config)
    return inv_freq_from_hf_config(
        rd, getattr(config, "rope_theta", 10000.0), None,
        max_position_embeddings=getattr(config, "max_position_embeddings", 4096))


def convert_hf_state_dict(state_dict: Dict[str, Any], config: InferenceConfig) -> Dict[str, Any]:
    arch = build_arch(config)
    state_dict = {k: v for k, v in state_dict.items() if ".mtp" not in k and "mtp_" not in k}

    def ff(get, has, cast, pre):
        moe = convert_hf_experts(
            get, cast, arch.moe.num_experts, pre + "block_sparse_moe.gate.weight",
            lambda j, proj: f"{pre}block_sparse_moe.experts.{j}.{_W_NAMES[proj]}.weight")
        # the selection-only bias stays float32 (a rounding flips near ties)
        moe["router"]["e_bias"] = get(pre + "block_sparse_moe.e_score_correction_bias").float()
        return "moe", moe

    params = dense.convert_hf_state_dict(state_dict, config, arch, ff_converter=ff)
    if arch.qk_norm_flat:
        # the flat norm weights follow the projections' GQA layout: q's
        # zero-padded interleave, k's per-head replication
        plan = dense.gqa_plan(config)
        dt = to_torch_dtype(arch.dtype)

        def grab(i, side, conv):
            w = torch.as_tensor(state_dict[f"model.layers.{i}.self_attn.{side}.weight"])
            return conv(w[:, None], arch.head_dim, plan)[:, 0].to(dt)

        attn = params["layers"]["attn"]
        attn["q_norm"] = torch.stack([grab(i, "q_norm", gqa.convert_q)
                                      for i in range(arch.num_layers)])
        attn["k_norm"] = torch.stack([grab(i, "k_norm", gqa.convert_kv)
                                      for i in range(arch.num_layers)])
    return params
