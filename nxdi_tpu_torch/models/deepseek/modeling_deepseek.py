"""DeepSeek family, V2/V3 lineage (counterpart of
``nxdi_tpu/models/deepseek/modeling_deepseek.py``): Multi-head Latent
Attention (``ops/mla.py``) with q-LoRA, the latent KV cache and YaRN rope,
and V3's mixture of experts (``ops/moe.py``: sigmoid-scored grouped top-k
with a learned correction bias, ``routed_scaling``, one wide shared expert).

The first ``first_k_dense_replace`` layers keep a dense MLP; when that is
neither none nor all of the layers, ``params["layers"]`` is a list of two
layer-stacked segments, [dense head, MoE tail], which ``models/base.py``
runs in order over their slices of the stacked cache.

Refused, as in the JAX package: the block KV layout (the latent cache needs
different K and V widths, which the paged pool lacks). Not ported yet:
speculation with an MLA model, LoRA and weight quantization on a segmented
stack (the applications raise, ROADMAP Queue 1), and the JAX package's
``param_specs`` / ``param_shape_struct`` sharding helpers (Queue 1 item 4).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from nxdi_tpu_torch.config import InferenceConfig, to_torch_dtype
from nxdi_tpu_torch.models import dense
from nxdi_tpu_torch.models.base import DecoderArch, layer_segments
from nxdi_tpu_torch.ops.mla import (
    MLAArch,
    deinterleave_rope_columns,
    mla_param_shapes,
    rope_deinterleave_perm,
)
from nxdi_tpu_torch.ops.moe import MoEArch, convert_hf_experts
from nxdi_tpu_torch.ops.rope import (
    default_inv_freq,
    rope_type_of,
    yarn_get_mscale,
    yarn_inv_freq,
)

# DeepSeek-V3 at its published widths (HF deepseek-ai/DeepSeek-V3 config.json)
DEEPSEEK_V3 = dict(
    hidden_size=7168,
    intermediate_size=18432,
    moe_intermediate_size=2048,
    num_hidden_layers=61,
    num_attention_heads=128,
    num_key_value_heads=128,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    n_routed_experts=256,
    num_experts_per_tok=8,
    n_group=8,
    topk_group=4,
    scoring_func="sigmoid",
    norm_topk_prob=True,
    routed_scaling_factor=2.5,
    n_shared_experts=1,
    first_k_dense_replace=3,
    vocab_size=129280,
    rms_norm_eps=1e-6,
    rope_theta=10000.0,
    max_position_embeddings=163840,
    rope_scaling=dict(type="yarn", factor=40, mscale=1.0, mscale_all_dim=1.0,
                      original_max_position_embeddings=4096, beta_fast=32, beta_slow=1),
    tie_word_embeddings=False,
    hidden_act="silu",
)


class DeepseekInferenceConfig(dense.DenseInferenceConfig):
    REQUIRED = [
        "hidden_size",
        "num_attention_heads",
        "num_hidden_layers",
        "vocab_size",
        "intermediate_size",
        "rms_norm_eps",
        "kv_lora_rank",
        "qk_rope_head_dim",
        "qk_nope_head_dim",
        "v_head_dim",
    ]

    def add_derived_config(self):
        if not hasattr(self, "num_key_value_heads"):
            self.num_key_value_heads = self.num_attention_heads
        super().add_derived_config()
        for k, v in {
            "q_lora_rank": None,
            "rope_interleave": True,
            "attention_bias": False,
        }.items():
            if not hasattr(self, k):
                setattr(self, k, v)


def _mla_arch(config: InferenceConfig) -> MLAArch:
    if config.tpu_config.is_block_kv_layout:
        raise ValueError(
            "MLA does not support the block KV layout yet: the latent cache "
            "needs asymmetric k/v slot widths the block pool lacks"
        )
    qk_head_dim = config.qk_nope_head_dim + config.qk_rope_head_dim
    scale = qk_head_dim ** -0.5
    rs = getattr(config, "rope_scaling", None)
    if rs:
        mscale_all_dim = rs.get("mscale_all_dim", 0)
        if mscale_all_dim:
            m = yarn_get_mscale(rs["factor"], mscale_all_dim)
            scale = scale * m * m
    return MLAArch(
        num_heads=config.num_attention_heads,
        q_lora_rank=getattr(config, "q_lora_rank", None),
        kv_lora_rank=config.kv_lora_rank,
        qk_nope_head_dim=config.qk_nope_head_dim,
        qk_rope_head_dim=config.qk_rope_head_dim,
        v_head_dim=config.v_head_dim,
        softmax_scale=scale,
    )


def _moe_arch(config: InferenceConfig) -> Optional[MoEArch]:
    """The V3/V2 MoE from the HF config (None for an all-dense model): HF
    ``DeepseekV3TopkRouter``'s sigmoid scores, selection over bias-corrected
    scores by grouped top-k, weights from the uncorrected scores,
    renormalised and scaled by ``routed_scaling_factor``; the
    ``n_shared_experts`` plain MLPs fused into one wide shared MLP."""
    E = getattr(config, "n_routed_experts", None)
    if not E:
        return None
    scoring = getattr(config, "scoring_func", "sigmoid")
    if scoring not in ("sigmoid", "softmax"):
        raise ValueError(f"deepseek scoring_func {scoring!r} not supported")
    n_shared = getattr(config, "n_shared_experts", None) or 0
    return MoEArch(
        num_experts=E,
        top_k=config.num_experts_per_tok,
        intermediate_size=config.moe_intermediate_size,
        hidden_act=getattr(config, "hidden_act", "silu"),
        norm_topk_prob=bool(getattr(config, "norm_topk_prob", True)),
        sigmoid_routing=scoring == "sigmoid",
        n_group=getattr(config, "n_group", None),
        topk_group=getattr(config, "topk_group", None),
        routed_scaling=float(getattr(config, "routed_scaling_factor", 1.0)),
        correction_bias=scoring == "sigmoid",
        shared_expert_intermediate_size=(
            n_shared * config.moe_intermediate_size if n_shared else None
        ),
        dispatch=config.tpu_config.moe_dispatch,
    )


def _first_k_dense(config: InferenceConfig) -> int:
    if getattr(config, "n_routed_experts", None):
        return int(getattr(config, "first_k_dense_replace", 0) or 0)
    return 0


def build_arch(config: InferenceConfig, **overrides) -> DecoderArch:
    """The yarn attention factor (``rope_mscale``) comes from
    ``dense.build_arch``. A stack with a dense head takes
    ``mlp_kernel_enabled`` there; an all-MoE stack refuses it."""
    moe = _moe_arch(config)
    k_dense = _first_k_dense(config)
    if moe is not None and k_dense >= config.num_hidden_layers:
        moe = None  # every layer is dense: no MoE layer exists in the model
    kwargs = dict(mla=_mla_arch(config), moe=moe)
    kwargs.update(overrides)
    return dense.build_arch(config, has_dense_mlp=k_dense > 0, **kwargs)


def build_inv_freq(config: InferenceConfig):
    rs = getattr(config, "rope_scaling", None)
    theta = getattr(config, "rope_theta", 10000.0)
    if rs and rope_type_of(rs) == "yarn":
        return yarn_inv_freq(
            config.qk_rope_head_dim, theta, rs,
            getattr(config, "max_position_embeddings", 4096),
        )[0]
    return default_inv_freq(config.qk_rope_head_dim, theta)


def _segment_archs(config: InferenceConfig, arch: DecoderArch):
    """(dense-head arch, MoE-tail arch) for a segmented stack, or None when
    the stack is homogeneous."""
    k = _first_k_dense(config)
    if arch.moe is None or not (0 < k < arch.num_layers):
        return None
    head = dataclasses.replace(arch, num_layers=k, moe=None)
    tail = dataclasses.replace(arch, num_layers=arch.num_layers - k)
    return head, tail


def segmented(config: InferenceConfig) -> bool:
    """Whether ``params["layers"]`` is a list of segments for ``config``."""
    return _segment_archs(config, build_arch(config)) is not None


# ---------------------------------------------------------------------------
# Conversion
# ---------------------------------------------------------------------------


def _dense_mlp(get, has, cast, pre):
    if not has(pre + "mlp.gate_proj.weight"):
        raise ValueError(
            f"deepseek layer {pre.rstrip('.')} has no dense mlp weights; "
            "MoE layers require n_routed_experts in the config"
        )
    return {name: {"w": cast(get(f"{pre}mlp.{name}.weight").t())}
            for name in ("gate_proj", "up_proj", "down_proj")}


def _moe_layer(get, cast, pre, moe: MoEArch):
    out = convert_hf_experts(
        get, cast, moe.num_experts, pre + "mlp.gate.weight",
        lambda j, proj: f"{pre}mlp.experts.{j}.{proj}_proj.weight")
    if moe.correction_bias:
        # the selection-only bias stays float32 as in HF (a bf16 rounding
        # flips near-tie expert selections)
        out["router"]["e_bias"] = get(pre + "mlp.gate.e_score_correction_bias").float()
    if moe.shared_expert_intermediate_size:
        out["shared_expert"] = {
            name: {"w": cast(get(f"{pre}mlp.shared_experts.{name}.weight").t())}
            for name in ("gate_proj", "up_proj", "down_proj")
        }
    return out


def _stack_layers(config: InferenceConfig, arch: DecoderArch, layers):
    """One stacked dict, or [dense head, MoE tail] for a segmented stack."""
    k_dense = _first_k_dense(config)
    if arch.moe is not None and 0 < k_dense < arch.num_layers:
        return [dense._stack(layers[:k_dense]), dense._stack(layers[k_dense:])]
    return dense._stack(layers)


def convert_hf_state_dict(state_dict: Dict[str, Any], config: InferenceConfig) -> Dict[str, Any]:
    """HF DeepSeek V2/V3 checkpoint (tensors or numpy arrays) -> the params
    dict on the CPU in the arch's dtype: the interleaved-rope columns of
    ``q_proj`` / ``q_b`` and of ``kv_a``'s rope part permuted to rotate-half
    (``rope_interleave``), the dense and MoE layers split into segments."""
    arch = build_arch(config)
    mla: MLAArch = arch.mla
    dt = to_torch_dtype(arch.dtype)
    interleave = bool(getattr(config, "rope_interleave", True))

    def get(name):
        for k in (name, f"model.{name}"):
            if k in state_dict:
                return torch.as_tensor(state_dict[k])
        raise KeyError(f"Missing weight {name}; available sample: {list(state_dict)[:8]}")

    def has(name):
        return name in state_dict or f"model.{name}" in state_dict

    def cast(x):
        return x.to(dt).contiguous()

    layers = []
    for i in range(arch.num_layers):
        pre = f"layers.{i}."
        attn: Dict[str, Any] = {
            "kv_a": {"w": cast(get(pre + "self_attn.kv_a_proj_with_mqa.weight").t())},
            "kv_a_norm": cast(get(pre + "self_attn.kv_a_layernorm.weight")),
            "kv_b": {"w": cast(get(pre + "self_attn.kv_b_proj.weight").t())},
            "o_proj": {"w": cast(get(pre + "self_attn.o_proj.weight").t())},
        }
        if mla.q_lora_rank is None:
            attn["q_proj"] = {"w": cast(get(pre + "self_attn.q_proj.weight").t())}
            q_key = "q_proj"
        else:
            attn["q_a"] = {"w": cast(get(pre + "self_attn.q_a_proj.weight").t())}
            attn["q_a_norm"] = cast(get(pre + "self_attn.q_a_layernorm.weight"))
            attn["q_b"] = {"w": cast(get(pre + "self_attn.q_b_proj.weight").t())}
            q_key = "q_b"
        if interleave:
            # the interleaved-rope channel permutation, folded into the weights
            attn[q_key]["w"] = deinterleave_rope_columns(
                attn[q_key]["w"], mla.qk_head_dim, mla.qk_nope_head_dim,
                mla.qk_rope_head_dim).contiguous()
            kv_a = attn["kv_a"]["w"]
            perm = torch.from_numpy(rope_deinterleave_perm(mla.qk_rope_head_dim))
            attn["kv_a"]["w"] = torch.cat(
                [kv_a[:, : mla.kv_lora_rank], kv_a[:, mla.kv_lora_rank:][:, perm]], dim=1
            ).contiguous()
        layer = {
            "input_layernorm": cast(get(pre + "input_layernorm.weight")),
            "post_attention_layernorm": cast(get(pre + "post_attention_layernorm.weight")),
            "attn": attn,
        }
        if arch.moe is not None and i >= _first_k_dense(config):
            layer["moe"] = _moe_layer(get, cast, pre, arch.moe)
        else:
            layer["mlp"] = _dense_mlp(get, has, cast, pre)
        layers.append(layer)

    embed = get("embed_tokens.weight")
    if arch.vocab_pad:
        embed = torch.cat([embed, embed.new_zeros((arch.vocab_pad, embed.shape[1]))])
    params: Dict[str, Any] = {
        "embed_tokens": cast(embed),
        "layers": _stack_layers(config, arch, layers),
        "norm": cast(get("norm.weight")),
    }
    if not arch.tie_word_embeddings:
        head = get("lm_head.weight") if has("lm_head.weight") else embed[: config.vocab_size]
        if arch.vocab_pad:
            head = torch.cat([head, head.new_zeros((arch.vocab_pad, head.shape[1]))])
        params["lm_head"] = cast(head.t())
    return params


# ---------------------------------------------------------------------------
# Shapes and random weights
# ---------------------------------------------------------------------------


def _layer_shapes(arch: DecoderArch, num_layers: int, moe_layers: bool) -> Dict[str, Any]:
    L, hs = num_layers, arch.hidden_size
    shapes: Dict[str, Any] = {
        "input_layernorm": (L, hs),
        "post_attention_layernorm": (L, hs),
        "attn": mla_param_shapes(arch.mla, hs, L),
    }
    if moe_layers:
        moe = arch.moe
        m = dense.moe_param_shapes(moe, hs, L)
        if moe.correction_bias:
            m["router"]["e_bias"] = (L, moe.num_experts)
        if moe.shared_expert_intermediate_size:
            Is = moe.shared_expert_intermediate_size
            m["shared_expert"] = {"gate_proj": {"w": (L, hs, Is)}, "up_proj": {"w": (L, hs, Is)},
                                  "down_proj": {"w": (L, Is, hs)}}
        shapes["moe"] = m
    else:
        inter = arch.intermediate_size
        shapes["mlp"] = {"gate_proj": {"w": (L, hs, inter)}, "up_proj": {"w": (L, hs, inter)},
                         "down_proj": {"w": (L, inter, hs)}}
    return shapes


def param_shapes(config: InferenceConfig) -> Dict[str, Any]:
    """Shape tree matching :func:`convert_hf_state_dict` (``layers`` a list
    of segments for a segmented stack)."""
    arch = build_arch(config)
    segs = _segment_archs(config, arch)
    if segs is None:
        layers = _layer_shapes(arch, arch.num_layers, arch.moe is not None)
    else:
        layers = [_layer_shapes(a, a.num_layers, a.moe is not None) for a in segs]
    shapes = {"embed_tokens": (arch.vocab_size, arch.hidden_size), "layers": layers,
              "norm": (arch.hidden_size,)}
    if not arch.tie_word_embeddings:
        shapes["lm_head"] = (arch.hidden_size, arch.vocab_size)
    return shapes


def random_params(config: InferenceConfig, seed: int = 0, std: float = 0.02, device=None):
    """Random weights from a seed (``dense.random_params`` over
    :func:`param_shapes`; the large expert tensors are drawn in pieces), on
    ``device`` (the card unless the CPU is asked for); the routers'
    correction bias in float32, as the converter keeps it."""
    arch = build_arch(config)
    params = dense.random_params(arch, seed=seed, std=std, device=device,
                                 shapes=param_shapes(config))
    for seg in layer_segments(params["layers"]):
        if "moe" in seg and "e_bias" in seg["moe"]["router"]:
            seg["moe"]["router"]["e_bias"] = seg["moe"]["router"]["e_bias"].float()
    return params
