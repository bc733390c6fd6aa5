"""Llama 4 (text) family, registered as ``llama4`` and ``llama4_text``
(counterpart of the text decoder of ``nxdi_tpu/models/llama4/modeling_llama4.py``):

- adjacent-pair (GPT-J) rope, skipped on every ``no_rope_layer_interval``-th
  layer (or where HF's ``no_rope_layers`` holds 0): the NoPE layers, marked
  by the per-layer ``use_rope`` flags;
- chunked attention (``attention_chunk_size``) on the rope layers only; the
  NoPE layers attend globally. ``DecoderArch.rope_pattern`` carries the
  pattern on the host, so each layer's kernel launch on the card takes its
  own chunk (:meth:`~nxdi_tpu_torch.models.base.DecoderArch.layer_chunk`);
- the unweighted L2 q / k norm after rope on the rope layers
  (``use_qk_norm``) and the query temperature on the NoPE layers
  (``attn_temperature_tuning``, ``floor_scale``, ``attn_scale``);
- a mixture of experts in every layer: top-k logits -> sigmoid scores that
  scale the expert INPUT, plus an always-on shared expert
  (``ops/moe.py``'s ``llama4_router``).

A composite (vision + text) checkpoint's ``text_config`` is promoted and its
``language_model.`` prefixes stripped. The dense/MoE interleaved stack
(``interleave_moe_layer_step > 1``, the 128-expert model) raises, as in the
JAX package; the vision tower is not ported.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from nxdi_tpu_torch.config import InferenceConfig, promote_text_config
from nxdi_tpu_torch.models import dense
from nxdi_tpu_torch.models.base import DecoderArch
from nxdi_tpu_torch.ops.moe import MoEArch

build_inv_freq = dense.build_inv_freq

# Llama-4-Scout at its published widths (HF meta-llama/Llama-4-Scout-17B-16E
# config.json, text_config): 40 query heads over 8 kv heads of 128 (G 5), 16
# experts top 1 and a shared expert, both 8192 wide, chunks of 8192 on the
# rope layers, every fourth layer NoPE (no_rope_layers), rope theta 5e5
# with llama3 scaling (factor 16 over 8192 positions)
LLAMA_4_SCOUT = dict(
    hidden_size=5120,
    intermediate_size=8192,
    intermediate_size_mlp=16384,
    num_hidden_layers=48,
    num_attention_heads=40,
    num_key_value_heads=8,
    head_dim=128,
    num_local_experts=16,
    num_experts_per_tok=1,
    interleave_moe_layer_step=1,
    vocab_size=202048,
    rms_norm_eps=1e-5,
    rope_theta=500000.0,
    rope_scaling=dict(rope_type="llama3", factor=16.0, low_freq_factor=1.0,
                      high_freq_factor=1.0, original_max_position_embeddings=8192),
    max_position_embeddings=10485760,
    attention_chunk_size=8192,
    no_rope_layer_interval=4,
    use_qk_norm=True,
    attn_temperature_tuning=True,
    floor_scale=8192.0,
    attn_scale=0.1,
    attention_bias=False,
    tie_word_embeddings=False,
    hidden_act="silu",
)


class Llama4InferenceConfig(dense.DenseInferenceConfig):
    REQUIRED = dense.DenseInferenceConfig.REQUIRED + ["num_local_experts", "num_experts_per_tok"]

    def add_derived_config(self):
        promote_text_config(self)  # a composite llama4 checkpoint's text side
        super().add_derived_config()
        defaults = {
            "no_rope_layers": None,
            "attention_chunk_size": None,
            "use_qk_norm": True,
            "attn_temperature_tuning": True,
            "floor_scale": 8192.0,
            "attn_scale": 0.1,
            "interleave_moe_layer_step": 1,
        }
        for k, v in defaults.items():
            if not hasattr(self, k):
                setattr(self, k, v)


def _moe_arch(config: InferenceConfig) -> MoEArch:
    step = getattr(config, "interleave_moe_layer_step", 1) or 1
    if step != 1:
        raise NotImplementedError(
            "llama4 with interleave_moe_layer_step > 1 (dense/MoE interleaved stack, the "
            "128-expert model) is not supported yet: the JAX package's layer scan needs a "
            "homogeneous stack")
    return MoEArch(
        num_experts=config.num_local_experts,
        top_k=config.num_experts_per_tok,
        intermediate_size=config.intermediate_size,
        llama4_router=True,
        shared_expert_intermediate_size=config.intermediate_size,
        dispatch=config.tpu_config.moe_dispatch,
    )


def use_rope_flags(config: InferenceConfig) -> Tuple[bool, ...]:
    """Per layer, whether it applies rope: HF ``no_rope_layers`` (1 = rope)
    or every ``no_rope_layer_interval``-th layer (4) NoPE."""
    nrl = getattr(config, "no_rope_layers", None)
    if nrl:
        return tuple(bool(v) for v in nrl)
    interval = getattr(config, "no_rope_layer_interval", 4) or 4
    return tuple((i + 1) % interval != 0 for i in range(config.num_hidden_layers))


def build_arch(config: InferenceConfig, **overrides) -> DecoderArch:
    kwargs = dict(
        moe=_moe_arch(config),
        rope_interleaved=True,
        qk_l2norm=bool(getattr(config, "use_qk_norm", True)),
        chunk_size=getattr(config, "attention_chunk_size", None),
        attn_temperature_tuning=bool(getattr(config, "attn_temperature_tuning", True)),
        floor_scale=float(getattr(config, "floor_scale", 8192.0)),
        attn_scale=float(getattr(config, "attn_scale", 0.1)),
        rope_pattern=use_rope_flags(config),
    )
    kwargs.update(overrides)
    return dense.build_arch(config, **kwargs)


_PREFIXES = ("model.language_model.", "language_model.model.", "language_model.")


def text_state_dict(state_dict: Dict[str, Any]) -> Dict[str, Any]:
    """A composite checkpoint's text decoder under the text-only names: the
    ``language_model.`` prefixes stripped, the head kept, the vision tower
    and projector dropped. A text-only checkpoint is returned as it is."""
    if not any(k.startswith(("language_model.", "model.language_model.")) for k in state_dict):
        return state_dict
    out = {}
    for k, v in state_dict.items():
        for prefix in _PREFIXES:
            if k.startswith(prefix):
                out[k[len(prefix):]] = v
                break
        else:
            if k in ("lm_head.weight", "language_model.lm_head.weight"):
                out["lm_head.weight"] = v
    return out


def convert_hf_state_dict(state_dict: Dict[str, Any], config: InferenceConfig) -> Dict[str, Any]:
    """HF Llama 4 (text-only or composite) -> the layer-stacked params: each
    layer's ``feed_forward`` becomes ``moe`` with the router (H, E), the
    experts' fused ``gate_up_proj`` (E, H, 2I) split into [gate | up], the
    ``down_proj`` (E, I, H) as stored, and the shared expert; the
    ``use_rope`` flags join the stack."""
    state_dict = text_state_dict(state_dict)
    arch = build_arch(config)
    inter = arch.moe.intermediate_size

    def ff(get, has, cast, pre):
        src = pre + "feed_forward."
        gu = get(src + "experts.gate_up_proj")
        shared = {name: {"w": cast(get(f"{src}shared_expert.{name}.weight").t())}
                  for name in ("gate_proj", "up_proj", "down_proj")}
        return "moe", {
            "router": {"w": cast(get(src + "router.weight").t())},
            "experts": {
                "gate_proj": {"w": cast(gu[..., :inter])},
                "up_proj": {"w": cast(gu[..., inter:])},
                "down_proj": {"w": cast(get(src + "experts.down_proj"))},
            },
            "shared_expert": shared,
        }

    params = dense.convert_hf_state_dict(state_dict, config, arch, ff_converter=ff)
    params["layers"]["use_rope"] = torch.tensor(use_rope_flags(config))
    return params


def random_params(config: InferenceConfig, seed: int = 0, device=None) -> Dict[str, Any]:
    """Random weights (dense.random_params: the experts and the shared
    expert included) with the ``use_rope`` flags, on ``device``."""
    params = dense.random_params(build_arch(config), seed=seed, device=device)
    params["layers"]["use_rope"] = torch.tensor(use_rope_flags(config),
                                                device=params["norm"].device)
    return params
