"""AFMoE family, Arcee Trinity (counterpart of
``nxdi_tpu/models/afmoe/modeling_afmoe.py``): per-head q / k RMSNorm, the
attention's context gated by ``sigmoid(attention input @ gate_proj)``
before ``o_proj`` (``attn_out_gate``), sandwich norms around both blocks
(HF's ``pre_mlp`` / ``post_mlp`` norms on the ``pre_`` /
``post_feedforward_layernorm`` keys), embeddings times sqrt(hidden)
(``mup_enabled``), rope ONLY on the sliding-window layers (every
``global_attn_every_n_layers``-th layer is full attention and NoPE: the
``use_rope`` and ``use_sliding_window`` flags), and a dense head of
``num_dense_layers`` layers before MoE layers whose sigmoid router selects
over scores plus the expert bias, weights by the raw scores (renormalised
under ``route_norm``, times ``route_scale``) and adds a shared expert.
A stack with both kinds is a list of two segments, [dense head, MoE tail]
(``models/base.py`` runs them in order).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from nxdi_tpu_torch.config import InferenceConfig, to_torch_dtype
from nxdi_tpu_torch.models import dense
from nxdi_tpu_torch.models.base import DecoderArch, layer_segments, segment_len
from nxdi_tpu_torch.ops.moe import MoEArch
from nxdi_tpu_torch.parallel import gqa

build_inv_freq = dense.build_inv_freq


class AfmoeInferenceConfig(dense.DenseInferenceConfig):
    def add_derived_config(self):
        defaults = {
            "num_dense_layers": 2,
            "num_experts_per_tok": 8,
            "num_shared_experts": 1,
            "route_norm": True,
            "route_scale": 1.0,
            "score_func": "sigmoid",
            "global_attn_every_n_layers": 4,
            "sliding_window": 2048,
            "mup_enabled": True,
        }
        for k, v in defaults.items():
            if not hasattr(self, k):
                setattr(self, k, v)
        if not hasattr(self, "num_local_experts"):
            self.num_local_experts = getattr(self, "num_experts", 128)
        if not hasattr(self, "moe_intermediate_size"):
            self.moe_intermediate_size = self.intermediate_size
        super().add_derived_config()
        if self.score_func != "sigmoid":
            raise NotImplementedError(
                f"afmoe score_func {self.score_func!r} not supported (sigmoid only)")
        if getattr(self, "layer_types", None) is None:
            n = self.global_attn_every_n_layers
            self.layer_types = ["sliding_attention" if (i + 1) % n else "full_attention"
                                for i in range(self.num_hidden_layers)]


def _moe_arch(config: InferenceConfig) -> MoEArch:
    n_shared = getattr(config, "num_shared_experts", 0) or 0
    return MoEArch(
        num_experts=config.num_local_experts,
        top_k=config.num_experts_per_tok,
        intermediate_size=config.moe_intermediate_size,
        hidden_act=getattr(config, "hidden_act", "silu"),
        norm_topk_prob=bool(getattr(config, "route_norm", True)),
        sigmoid_routing=True,
        routed_scaling=float(getattr(config, "route_scale", 1.0)),
        correction_bias=True,  # the expert bias: selection only
        shared_expert_intermediate_size=(
            n_shared * config.moe_intermediate_size if n_shared else None),
        dispatch=config.tpu_config.moe_dispatch,
    )


def _n_dense(config: InferenceConfig) -> int:
    return int(getattr(config, "num_dense_layers", 0) or 0)


def sliding_flags(config: InferenceConfig) -> Tuple[bool, ...]:
    return tuple(t == "sliding_attention"
                 for t in config.layer_types[: config.num_hidden_layers])


def build_arch(config: InferenceConfig, **overrides) -> DecoderArch:
    k_dense = _n_dense(config)
    moe = _moe_arch(config) if k_dense < config.num_hidden_layers else None
    sw = getattr(config, "sliding_window", None)
    kwargs = dict(
        qk_norm=True,
        attn_out_gate=True,
        sandwich_norm=True,
        sliding_window=sw,
        embed_scale=math.sqrt(config.hidden_size) if getattr(config, "mup_enabled", True)
        else None,
        moe=moe,
        kv_window_pattern=sliding_flags(config) if sw else None,
    )
    kwargs.update(overrides)
    return dense.build_arch(config, has_dense_mlp=k_dense > 0, **kwargs)


def _segment_archs(config: InferenceConfig, arch: DecoderArch):
    """(dense-head arch, MoE-tail arch) of a segmented stack, or None."""
    k = _n_dense(config)
    if arch.moe is None or not (0 < k < arch.num_layers):
        return None
    return (dataclasses.replace(arch, num_layers=k, moe=None),
            dataclasses.replace(arch, num_layers=arch.num_layers - k))


def segmented(config: InferenceConfig) -> bool:
    """Whether ``params["layers"]`` is a list of segments for ``config``."""
    return _segment_archs(config, build_arch(config)) is not None


def _with_flags(config: InferenceConfig, layers, device=None):
    """``layers`` (one stacked dict, or the segment list) with each
    segment's ``use_sliding_window`` flags and its equal ``use_rope`` flags
    (a full-attention layer is NoPE)."""
    flags = torch.tensor(sliding_flags(config), device=device)
    off = 0
    for seg in layer_segments(layers):
        n = segment_len(seg)
        seg["use_sliding_window"] = flags[off:off + n].clone()
        seg["use_rope"] = flags[off:off + n].clone()
        off += n
    return layers


def convert_hf_state_dict(state_dict: Dict[str, Any], config: InferenceConfig) -> Dict[str, Any]:
    arch = build_arch(config)
    dt = to_torch_dtype(arch.dtype)
    plan = dense.gqa_plan(config)
    D = arch.head_dim
    k_dense = _n_dense(config)

    def get(name):
        for k in (name, f"model.{name}"):
            if k in state_dict:
                return torch.as_tensor(state_dict[k])
        raise KeyError(name)

    def cast(x):
        return x.to(dt).contiguous()

    def proj(pre, name, conv):
        return {"w": cast(conv(get(f"{pre}self_attn.{name}.weight"), D, plan).t())}

    layers: List[Dict[str, Any]] = []
    for i in range(arch.num_layers):
        pre = f"layers.{i}."
        attn = {
            "q_proj": proj(pre, "q_proj", gqa.convert_q),
            "k_proj": proj(pre, "k_proj", gqa.convert_kv),
            "v_proj": proj(pre, "v_proj", gqa.convert_kv),
            "o_proj": {"w": cast(gqa.convert_o(get(pre + "self_attn.o_proj.weight"), D,
                                               plan).t())},
            # the output gate's columns are q-shaped: the same interleave
            "gate_proj": proj(pre, "gate_proj", gqa.convert_q),
            "q_norm": cast(get(pre + "self_attn.q_norm.weight")),
            "k_norm": cast(get(pre + "self_attn.k_norm.weight")),
        }
        layer: Dict[str, Any] = {
            "input_layernorm": cast(get(pre + "input_layernorm.weight")),
            "post_attention_layernorm": cast(get(pre + "post_attention_layernorm.weight")),
            "pre_feedforward_layernorm": cast(get(pre + "pre_mlp_layernorm.weight")),
            "post_feedforward_layernorm": cast(get(pre + "post_mlp_layernorm.weight")),
            "attn": attn,
        }
        if arch.moe is not None and i >= k_dense:
            moe = arch.moe
            mo: Dict[str, Any] = {
                "router": {
                    "w": cast(get(pre + "mlp.router.gate.weight")).t(),
                    # the selection-only bias stays float32 (near-tie flips)
                    "e_bias": get(pre + "mlp.expert_bias").float(),
                },
                "experts": {
                    p: {"w": cast(torch.stack([get(f"{pre}mlp.experts.{j}.{p}.weight").t()
                                               for j in range(moe.num_experts)]))}
                    for p in ("gate_proj", "up_proj", "down_proj")
                },
            }
            if moe.shared_expert_intermediate_size:
                mo["shared_expert"] = {
                    p: {"w": cast(get(f"{pre}mlp.shared_experts.{p}.weight")).t()}
                    for p in ("gate_proj", "up_proj", "down_proj")
                }
            layer["moe"] = mo
        else:
            layer["mlp"] = {p: {"w": cast(get(f"{pre}mlp.{p}.weight")).t()}
                            for p in ("gate_proj", "up_proj", "down_proj")}
        layers.append(layer)

    if _segment_archs(config, arch) is not None:
        stacked: Any = [dense._stack(layers[:k_dense]), dense._stack(layers[k_dense:])]
    else:
        stacked = dense._stack(layers)
    embed = get("embed_tokens.weight")
    if arch.vocab_pad:
        embed = torch.cat([embed, embed.new_zeros((arch.vocab_pad, embed.shape[1]))])
    head = get("lm_head.weight") if ("lm_head.weight" in state_dict) else embed[
        : config.vocab_size]
    if arch.vocab_pad:
        head = torch.cat([head, head.new_zeros((arch.vocab_pad, head.shape[1]))])
    return {"embed_tokens": cast(embed), "layers": _with_flags(config, stacked),
            "norm": cast(get("norm.weight")), "lm_head": cast(head.t())}


def param_shapes(config: InferenceConfig) -> Dict[str, Any]:
    """Shape tree matching :func:`convert_hf_state_dict`, without the
    per-layer flags (``layers`` a list of segments for a segmented stack)."""
    arch = build_arch(config)
    shapes = dense.param_shapes(arch)
    segs = _segment_archs(config, arch)
    if segs is not None:
        shapes["layers"] = [dense.param_shapes(a)["layers"] for a in segs]
    shapes["lm_head"] = (arch.hidden_size, arch.vocab_size)
    return shapes


def random_params(config: InferenceConfig, seed: int = 0, std: float = 0.02,
                  device: Optional[Any] = None) -> Dict[str, Any]:
    """Random weights (dense.random_params over :func:`param_shapes`) with
    the layer-type flags, on ``device``."""
    arch = build_arch(config)
    params = dense.random_params(arch, seed=seed, std=std, device=device,
                                 shapes=param_shapes(config))
    _with_flags(config, params["layers"], device=params["norm"].device)
    return params
