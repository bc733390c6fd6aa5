"""DBRX family (counterpart of ``nxdi_tpu/models/dbrx/modeling_dbrx.py``):
16 experts top-4 whose weights renormalise by their sum (Mixtral's router),
weight-only LayerNorm (``DecoderArch.layernorm``), a fused ``Wqkv``
projection whose outputs are clamped to ±``clip_qkv``, and packed expert
weights (``experts.mlp.w1`` / ``v1`` / ``w2``: every expert stacked on the
rows). The HF config nests its attention and feed-forward settings under
``attn_config`` / ``ffn_config``; the config class flattens them to the
shared names.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from nxdi_tpu_torch.config import InferenceConfig
from nxdi_tpu_torch.models import dense
from nxdi_tpu_torch.models.base import DecoderArch
from nxdi_tpu_torch.ops.moe import MoEArch

build_inv_freq = dense.build_inv_freq

# DBRX at its published widths (HF databricks/dbrx-instruct config.json)
DBRX = dict(
    d_model=6144,
    n_heads=48,
    n_layers=40,
    max_seq_len=32768,
    vocab_size=100352,
    attn_config=dict(kv_n_heads=8, clip_qkv=8, rope_theta=500000),
    ffn_config=dict(ffn_hidden_size=10752, moe_num_experts=16, moe_top_k=4,
                    ffn_act_fn=dict(name="silu")),
)


class DbrxInferenceConfig(dense.DenseInferenceConfig):
    REQUIRED = ["d_model", "n_heads", "n_layers", "vocab_size"]

    def add_derived_config(self):
        # flatten DBRX's nested config blocks into the shared names
        attn = dict(getattr(self, "attn_config", None) or {})
        ffn = dict(getattr(self, "ffn_config", None) or {})
        self.hidden_size = self.d_model
        self.num_attention_heads = self.n_heads
        self.num_hidden_layers = self.n_layers
        self.num_key_value_heads = attn.get("kv_n_heads", self.n_heads)
        self.rope_theta = attn.get("rope_theta", 10000.0)
        self.clip_qkv = attn.get("clip_qkv")
        self.intermediate_size = ffn.get("ffn_hidden_size", 4 * self.d_model)
        self.num_local_experts = ffn.get("moe_num_experts", 16)
        self.num_experts_per_tok = ffn.get("moe_top_k", 4)
        self.hidden_act = (ffn.get("ffn_act_fn") or {}).get("name", "silu")
        self.rms_norm_eps = 1e-5  # the LayerNorm's eps (HF nn.LayerNorm's default)
        self.rope_scaling = None
        self.tie_word_embeddings = False
        super().add_derived_config()


def _moe_arch(config: InferenceConfig) -> MoEArch:
    return MoEArch(
        num_experts=config.num_local_experts,
        top_k=config.num_experts_per_tok,
        intermediate_size=config.intermediate_size,
        hidden_act=config.hidden_act,
        norm_topk_prob=True,  # DBRX: / sum(top weights) (the p=1 norm of the softmax)
        dispatch=config.tpu_config.moe_dispatch,
    )


def build_arch(config: InferenceConfig, **overrides) -> DecoderArch:
    return dense.build_arch(config, **{"moe": _moe_arch(config), "layernorm": True,
                                       "clip_qkv": getattr(config, "clip_qkv", None),
                                       **overrides})


def convert_hf_state_dict(state_dict: Dict[str, Any], config: InferenceConfig) -> Dict[str, Any]:
    """The HF layout (``transformer.blocks.{i}...``) renamed into the dense
    layout, ``Wqkv`` split into q / k / v and the packed experts into the
    (E, in, out) stacks; then the dense converter (GQA padding etc.)."""
    arch = build_arch(config)
    E = arch.moe.num_experts
    inter, hs = arch.moe.intermediate_size, config.hidden_size
    kv_dim = config.num_key_value_heads * (hs // config.num_attention_heads)

    def t(name):
        return torch.as_tensor(state_dict[name])

    sd: Dict[str, torch.Tensor] = {
        "embed_tokens.weight": t("transformer.wte.weight"),
        "norm.weight": t("transformer.norm_f.weight"),
        "lm_head.weight": t("lm_head.weight"),
    }
    for i in range(arch.num_layers):
        src, dst = f"transformer.blocks.{i}.norm_attn_norm.", f"layers.{i}."
        qkv = t(src + "attn.Wqkv.weight")  # (hs + 2 kv_dim, hs)
        sd[dst + "self_attn.q_proj.weight"] = qkv[:hs]
        sd[dst + "self_attn.k_proj.weight"] = qkv[hs: hs + kv_dim]
        sd[dst + "self_attn.v_proj.weight"] = qkv[hs + kv_dim:]
        sd[dst + "self_attn.o_proj.weight"] = t(src + "attn.out_proj.weight")
        sd[dst + "input_layernorm.weight"] = t(src + "norm_1.weight")
        sd[dst + "post_attention_layernorm.weight"] = t(src + "norm_2.weight")

    def ff(get, has, cast, pre):
        src = f"transformer.blocks.{int(pre.split('.')[1])}.ffn."
        # packed (E * inter, hs) rows -> the (E, hs, inter) stacks; w2's rows
        # are each expert's (inter, hs) already (x @ w2)
        w1 = t(src + "experts.mlp.w1").reshape(E, inter, hs)
        v1 = t(src + "experts.mlp.v1").reshape(E, inter, hs)
        w2 = t(src + "experts.mlp.w2").reshape(E, inter, hs)
        return "moe", {
            "router": {"w": cast(t(src + "router.layer.weight").t())},
            "experts": {
                "gate_proj": {"w": cast(w1.transpose(1, 2))},
                "up_proj": {"w": cast(v1.transpose(1, 2))},
                "down_proj": {"w": cast(w2)},
            },
        }

    return dense.convert_hf_state_dict(sd, config, arch, ff_converter=ff)
