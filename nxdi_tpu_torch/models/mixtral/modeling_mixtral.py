"""Mixtral family (counterpart of ``nxdi_tpu/models/mixtral/modeling_mixtral.py``):
the llama lineage with a sparse mixture-of-experts feed-forward
(``ops/moe.py``) in every layer.

HF weight layout: ``block_sparse_moe.gate`` is the router, each expert's
``w1`` the gate, ``w3`` the up and ``w2`` the down projection. Routing: a
full softmax, top-k, always renormalised. A ``sliding_window`` in the HF
config masks attention to the window, as Mistral's does.
"""

from __future__ import annotations

from typing import Any, Dict

from nxdi_tpu_torch.config import InferenceConfig
from nxdi_tpu_torch.models import dense
from nxdi_tpu_torch.models.base import DecoderArch
from nxdi_tpu_torch.ops.moe import MoEArch, convert_hf_experts

build_inv_freq = dense.build_inv_freq

# HF Mixtral expert projections: w1 = gate, w3 = up, w2 = down
_W_NAMES = {"gate": "w1", "up": "w3", "down": "w2"}

# Mixtral-8x7B at its published widths (HF mistralai/Mixtral-8x7B-v0.1
# config.json)
MIXTRAL_8X7B = dict(
    hidden_size=4096,
    intermediate_size=14336,
    num_hidden_layers=32,
    num_attention_heads=32,
    num_key_value_heads=8,
    head_dim=128,
    vocab_size=32000,
    rms_norm_eps=1e-5,
    rope_theta=1e6,
    max_position_embeddings=32768,
    num_local_experts=8,
    num_experts_per_tok=2,
    sliding_window=None,
    tie_word_embeddings=False,
    hidden_act="silu",
)


class MixtralInferenceConfig(dense.DenseInferenceConfig):
    REQUIRED = dense.DenseInferenceConfig.REQUIRED + [
        "num_local_experts",
        "num_experts_per_tok",
    ]


def _moe_arch(config: InferenceConfig) -> MoEArch:
    return MoEArch(
        num_experts=config.num_local_experts,
        top_k=config.num_experts_per_tok,
        intermediate_size=config.intermediate_size,
        hidden_act=getattr(config, "hidden_act", "silu"),
        norm_topk_prob=True,
        dispatch=config.tpu_config.moe_dispatch,
    )


def build_arch(config: InferenceConfig, **overrides) -> DecoderArch:
    sw = getattr(config, "sliding_window", None)
    return dense.build_arch(
        config, **{"moe": _moe_arch(config), "sliding_window": sw, **overrides})


def convert_hf_state_dict(state_dict: Dict[str, Any], config: InferenceConfig) -> Dict[str, Any]:
    arch = build_arch(config)

    def ff(get, has, cast, pre):
        return "moe", convert_hf_experts(
            get,
            cast,
            arch.moe.num_experts,
            pre + "block_sparse_moe.gate.weight",
            lambda j, proj: f"{pre}block_sparse_moe.experts.{j}.{_W_NAMES[proj]}.weight",
        )

    return dense.convert_hf_state_dict(state_dict, config, arch, ff_converter=ff)
