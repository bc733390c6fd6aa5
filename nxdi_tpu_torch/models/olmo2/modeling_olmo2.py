"""OLMo-2 family (counterpart of ``nxdi_tpu/models/olmo2/modeling_olmo2.py``):
no input norms; RMSNorm on the attention and MLP outputs before the
residual add (``post_block_norm``), and RMSNorm over the flat q/k
projections before the head reshape (``qk_norm_flat``). The conversion
aliases HF's ``post_attention_layernorm`` onto the layer key
``input_layernorm`` (the attention's post-norm) and
``post_feedforward_layernorm`` onto ``post_attention_layernorm`` (the MLP's).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from nxdi_tpu_torch.config import InferenceConfig, to_torch_dtype
from nxdi_tpu_torch.models import dense
from nxdi_tpu_torch.models.base import DecoderArch
from nxdi_tpu_torch.parallel import gqa

build_inv_freq = dense.build_inv_freq


class Olmo2InferenceConfig(dense.DenseInferenceConfig):
    pass


def build_arch(config: InferenceConfig, **overrides) -> DecoderArch:
    kwargs = dict(
        post_block_norm=True,
        qk_norm_flat=True,
        qk_norm_flat_qdim=config.num_attention_heads * dense.head_dim_of(config),
    )
    kwargs.update(overrides)
    return dense.build_arch(config, **kwargs)


def convert_hf_state_dict(state_dict: Dict[str, Any], config: InferenceConfig) -> Dict[str, Any]:
    arch = build_arch(config)
    sd = dict(state_dict)
    for i in range(config.num_hidden_layers):
        p = f"model.layers.{i}."
        sd[p + "input_layernorm.weight"] = sd[p + "post_attention_layernorm.weight"]
        sd[p + "post_attention_layernorm.weight"] = sd.pop(p + "post_feedforward_layernorm.weight")
    params = dense.convert_hf_state_dict(sd, config, arch)
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
