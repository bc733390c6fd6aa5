"""Phi-3 family (counterpart of ``nxdi_tpu/models/phi3/modeling_phi3.py``):
the Llama lineage whose checkpoints fuse the projections — ``qkv_proj``
holds Q | K | V on its output rows, ``gate_up_proj`` gate | up — which the
conversion splits into the shared dense layout. The 128k-context LongRoPE
variant (``rope_scaling`` of type ``longrope``) ships [short, long]
frequency sets (``ops/rope.longrope_inv_freq``) that a forward picks from
its true last position (``DecoderArch.longrope_original_max``), with the
attention factor on ``DecoderArch.rope_mscale``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from nxdi_tpu_torch.config import InferenceConfig
from nxdi_tpu_torch.models import dense
from nxdi_tpu_torch.models.base import DecoderArch
from nxdi_tpu_torch.ops.rope import longrope_inv_freq


class Phi3InferenceConfig(dense.DenseInferenceConfig):
    pass


def longrope_scaling(config: InferenceConfig) -> Optional[dict]:
    rs = getattr(config, "rope_scaling", None)
    if rs and rs.get("rope_type", rs.get("type")) == "longrope":
        return rs
    return None


def original_max(config: InferenceConfig) -> int:
    """The pretrained window past which LongRoPE takes its long set."""
    return (getattr(config, "original_max_position_embeddings", None)
            or config.max_position_embeddings)


def longrope_tables(config: InferenceConfig):
    """(the stacked [short, long] table, the attention factor) of a LongRoPE
    config."""
    return longrope_inv_freq(dense.head_dim_of(config), getattr(config, "rope_theta", 10000.0),
                             longrope_scaling(config), config.max_position_embeddings,
                             original_max(config))


def build_inv_freq(config: InferenceConfig) -> np.ndarray:
    """The frequency table: (2, D/2) [short, long] under LongRoPE, else the
    dense lineage's."""
    if longrope_scaling(config) is None:
        return dense.build_inv_freq(config)
    return longrope_tables(config)[0]


def build_arch(config: InferenceConfig, **overrides) -> DecoderArch:
    kwargs: Dict[str, Any] = {"sliding_window": getattr(config, "sliding_window", None)}
    if longrope_scaling(config) is not None:
        kwargs["longrope_original_max"] = original_max(config)
        kwargs["rope_mscale"] = longrope_tables(config)[1]
    kwargs.update(overrides)
    return dense.build_arch(config, **kwargs)


def split_fused(state_dict: Dict[str, Any], config: InferenceConfig, head_dim: int
                ) -> Dict[str, Any]:
    """The checkpoint with ``qkv_proj`` and ``gate_up_proj`` split into the
    dense layout's q / k / v and gate / up weights."""
    q_dim = config.num_attention_heads * head_dim
    kv_dim = config.num_key_value_heads * head_dim
    inter = config.intermediate_size
    sd = {}
    for k, v in state_dict.items():
        key = k[len("model."):] if k.startswith("model.") else k
        if key.endswith("self_attn.qkv_proj.weight"):
            pre = key[: -len("qkv_proj.weight")]
            sd[pre + "q_proj.weight"] = v[:q_dim]
            sd[pre + "k_proj.weight"] = v[q_dim: q_dim + kv_dim]
            sd[pre + "v_proj.weight"] = v[q_dim + kv_dim:]
        elif key.endswith("mlp.gate_up_proj.weight"):
            pre = key[: -len("gate_up_proj.weight")]
            sd[pre + "gate_proj.weight"] = v[:inter]
            sd[pre + "up_proj.weight"] = v[inter:]
        else:
            sd[key] = v
    return sd


def convert_hf_state_dict(state_dict: Dict[str, Any], config: InferenceConfig) -> Dict[str, Any]:
    arch = build_arch(config)
    return dense.convert_hf_state_dict(split_fused(state_dict, config, arch.head_dim), config,
                                       arch)
