"""HunYuan dense v1 family (counterpart of
``nxdi_tpu/models/hunyuan/modeling_hunyuan.py``): the Llama geometry with
per-head q/k RMSNorms, which HF names ``query_layernorm`` /
``key_layernorm`` (renamed onto ``qk_norm``'s keys), and an explicit
``head_dim``.
"""

from __future__ import annotations

from typing import Any, Dict

from nxdi_tpu_torch.config import InferenceConfig
from nxdi_tpu_torch.models import dense
from nxdi_tpu_torch.models.base import DecoderArch

build_inv_freq = dense.build_inv_freq


class HunYuanInferenceConfig(dense.DenseInferenceConfig):
    pass


def build_arch(config: InferenceConfig, **overrides) -> DecoderArch:
    return dense.build_arch(config, **{"qk_norm": True, **overrides})


def convert_hf_state_dict(state_dict: Dict[str, Any], config: InferenceConfig) -> Dict[str, Any]:
    sd = dict(state_dict)
    for k in list(sd):
        if "self_attn.query_layernorm." in k:
            sd[k.replace("query_layernorm", "q_norm")] = sd.pop(k)
        elif "self_attn.key_layernorm." in k:
            sd[k.replace("key_layernorm", "k_norm")] = sd.pop(k)
    return dense.convert_hf_state_dict(sd, config, build_arch(config))
