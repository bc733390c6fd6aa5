"""Qwen3-MoE family (counterpart of
``nxdi_tpu/models/qwen3_moe/modeling_qwen3_moe.py``): Qwen3's attention
(per-head q/k RMSNorm, an explicit ``head_dim``) over a sparse
mixture-of-experts feed-forward in every layer: a full softmax, top-k,
renormalised when ``norm_topk_prob``, experts ``moe_intermediate_size``
wide. Dense-layer interleaving (``mlp_only_layers``, ``decoder_sparse_step``)
raises, as in the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict

from nxdi_tpu_torch.config import InferenceConfig
from nxdi_tpu_torch.models import dense
from nxdi_tpu_torch.models.base import DecoderArch
from nxdi_tpu_torch.ops.moe import MoEArch, convert_hf_experts

build_inv_freq = dense.build_inv_freq

# Qwen3-30B-A3B at its published widths (HF Qwen/Qwen3-30B-A3B config.json)
QWEN3_30B_A3B = dict(
    hidden_size=2048,
    intermediate_size=6144,
    moe_intermediate_size=768,
    num_hidden_layers=48,
    num_attention_heads=32,
    num_key_value_heads=4,
    head_dim=128,
    num_experts=128,
    num_experts_per_tok=8,
    norm_topk_prob=True,
    decoder_sparse_step=1,
    mlp_only_layers=[],
    vocab_size=151936,
    rms_norm_eps=1e-6,
    rope_theta=1000000.0,
    max_position_embeddings=40960,
    tie_word_embeddings=False,
    attention_bias=False,
    hidden_act="silu",
)


class Qwen3MoeInferenceConfig(dense.DenseInferenceConfig):
    REQUIRED = dense.DenseInferenceConfig.REQUIRED + [
        "num_experts",
        "num_experts_per_tok",
        "moe_intermediate_size",
    ]

    def add_derived_config(self):
        super().add_derived_config()
        if not hasattr(self, "norm_topk_prob"):
            # HF Qwen3MoeConfig's default: saved configs omit default values
            self.norm_topk_prob = False
        if getattr(self, "mlp_only_layers", None):
            raise NotImplementedError("qwen3_moe mlp_only_layers not supported yet")
        if getattr(self, "decoder_sparse_step", 1) != 1:
            raise NotImplementedError("qwen3_moe decoder_sparse_step != 1 not supported yet")


def _moe_arch(config: InferenceConfig) -> MoEArch:
    return MoEArch(
        num_experts=config.num_experts,
        top_k=config.num_experts_per_tok,
        intermediate_size=config.moe_intermediate_size,
        hidden_act=getattr(config, "hidden_act", "silu"),
        norm_topk_prob=config.norm_topk_prob,
        dispatch=config.tpu_config.moe_dispatch,
    )


def build_arch(config: InferenceConfig, **overrides) -> DecoderArch:
    return dense.build_arch(config, **{"qk_norm": True, "moe": _moe_arch(config), **overrides})


def convert_hf_state_dict(state_dict: Dict[str, Any], config: InferenceConfig) -> Dict[str, Any]:
    arch = build_arch(config)

    def ff(get, has, cast, pre):
        return "moe", convert_hf_experts(
            get, cast, arch.moe.num_experts, pre + "mlp.gate.weight",
            lambda j, proj: f"{pre}mlp.experts.{j}.{proj}_proj.weight")

    return dense.convert_hf_state_dict(state_dict, config, arch, ff_converter=ff)
