"""Shared implementation for dense decoder families (counterpart of
``nxdi_tpu/models/dense.py``): arch building, rope tables, vocab padding and
the HF-checkpoint conversion into the layer-stacked params dict.

The params dict has the JAX package's layout exactly — same keys, weights
stored (in, out), layer-stacked along a leading axis — only the leaves are
torch tensors:

    {"embed_tokens": (V, H), "norm": (H,), ["lm_head": (H, V)],
     "layers": {"input_layernorm": (L, H), "post_attention_layernorm": (L, H),
                "attn": {"q_proj": {"w": (L, H, Hq*D)}, "k_proj": ..., "v_proj": ...,
                         "o_proj": {"w": (L, Hq*D, H)}},
                         # under fused_qkv, q/k/v become one
                         # "qkv_proj": {"w": (L, H, Hq*D + 2*KV*D)}
                "mlp": {"gate_proj": {"w": (L, H, I)}, "up_proj": ..., "down_proj": ...}}}

The family switches add leaves: biases ``"b"`` beside a projection's
``"w"`` (``attention_bias``: q/k/v; ``attention_o_bias``: o; ``mlp_bias``),
``attn.q_norm`` / ``attn.k_norm`` ((L, D) per-head under ``qk_norm``;
(L, Hq*D) / (L, KV*D) under ``qk_norm_flat``), and per-layer bool flags
``layers.use_rope`` / ``layers.use_sliding_window`` (L,). A non-gated MLP
(Arcee) has no ``gate_proj``. The MoE families add ``attn.sink`` (L, Hq)
(``attention_sink``), ``attn.gate_proj`` {"w": (L, H, Hq*D)}
(``attn_out_gate``), ``layers.pre_feedforward_layernorm`` /
``post_feedforward_layernorm`` (L, H) (``sandwich_norm``), and biased
LayerNorms as ``{"w", "b"}`` dicts in place of a norm's array (Phi-3.5-MoE).

An MoE family (``models/mixtral``) replaces each layer's ``mlp`` through
``convert_hf_state_dict``'s ``ff_converter`` hook, here by ``"moe"``:
``{"router": {"w": (L, H, E)}, "experts": {"gate_proj": {"w": (L, E, H, I)},
"up_proj": ..., "down_proj": {"w": (L, E, I, H)}}}`` (``ops/moe.py``); a
non-gated family (Arcee) by its own ``"mlp"``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch

from nxdi_tpu_torch.config import InferenceConfig, dtype_name, to_torch_dtype
from nxdi_tpu_torch.models.base import DecoderArch
from nxdi_tpu_torch.ops.rope import inv_freq_from_hf_config, rope_type_of, yarn_inv_freq
from nxdi_tpu_torch.parallel import gqa
from nxdi_tpu_torch.runtime.device import resolve_device


def gqa_plan(config: InferenceConfig) -> gqa.GQAPlan:
    return gqa.plan_gqa_sharding(
        config.tpu_config.tp_degree, config.num_attention_heads, config.num_key_value_heads
    )


def planned_head_counts(config: InferenceConfig):
    plan = gqa_plan(config)
    return plan.target_heads, plan.target_kv


def padded_vocab(config: InferenceConfig):
    tp = config.tpu_config.tp_degree
    padded = math.ceil(config.vocab_size / tp) * tp
    return padded, padded - config.vocab_size


def head_dim_of(config: InferenceConfig) -> int:
    hd = getattr(config, "head_dim", None)
    return hd if hd is not None else config.hidden_size // config.num_attention_heads


def rope_mscale_from_config(config: InferenceConfig) -> float:
    """YaRN's attention factor for the cos/sin scaling (1.0 for other
    ropes). It depends only on the scaling config, not on which head dim the
    frequencies use."""
    rs = getattr(config, "rope_scaling", None)
    if rs and rope_type_of(rs) == "yarn":
        return yarn_inv_freq(
            head_dim_of(config),
            getattr(config, "rope_theta", 10000.0),
            rs,
            getattr(config, "max_position_embeddings", 4096),
        )[1]
    return 1.0


def build_arch(config: InferenceConfig, has_dense_mlp: bool = False, **overrides) -> DecoderArch:
    """The arch of ``config``; ``overrides`` set its fields (a family's MoE
    or MLA). ``has_dense_mlp``: an MoE model whose stack also holds dense-MLP
    layers (DeepSeek's first layers), which ``mlp_kernel_enabled`` serves."""
    heads, kv_heads = planned_head_counts(config)
    vocab, vocab_pad = padded_vocab(config)
    tc = config.tpu_config
    kwargs = dict(
        num_layers=config.num_hidden_layers,
        hidden_size=config.hidden_size,
        num_attention_heads=heads,
        num_kv_heads=kv_heads,
        head_dim=head_dim_of(config),
        intermediate_size=config.intermediate_size,
        vocab_size=vocab,
        vocab_pad=vocab_pad,
        rms_norm_eps=config.rms_norm_eps,
        hidden_act=getattr(config, "hidden_act", "silu"),
        attention_bias=getattr(config, "attention_bias", False),
        mlp_bias=getattr(config, "mlp_bias", False),
        tie_word_embeddings=getattr(config, "tie_word_embeddings", False),
        dtype=dtype_name(tc.dtype),
        attn_kernel_enabled=bool(tc.attn_kernel_enabled),
        attn_tkg_kernel_enabled=bool(tc.attn_tkg_kernel_enabled),
        attn_block_tkg_kernel_enabled=bool(tc.attn_block_tkg_kernel_enabled),
        fused_qkv=bool(tc.fused_qkv),
        qkv_kernel_enabled=bool(tc.qkv_kernel_enabled),
        mlp_kernel_enabled=bool(tc.mlp_kernel_enabled),
        act_quant=tc.activation_quantization_type,
        act_clamp=tc.quantize_clamp_bound,
        kv_quant_dtype=tc.kv_quant_config.dtype if tc.kv_quant_config is not None else None,
        rope_mscale=rope_mscale_from_config(config),
    )
    kwargs.update(overrides)
    if kwargs.get("moe") is not None and kwargs["mlp_kernel_enabled"] and not has_dense_mlp:
        raise NotImplementedError(
            "mlp_kernel_enabled: this model has no dense MLP (its layers are mixture-of-"
            "experts); set mlp_kernel_enabled=False"
        )
    return DecoderArch(**kwargs)


def build_inv_freq(config: InferenceConfig) -> np.ndarray:
    return inv_freq_from_hf_config(
        head_dim_of(config),
        getattr(config, "rope_theta", 10000.0),
        getattr(config, "rope_scaling", None),
        max_position_embeddings=getattr(config, "max_position_embeddings", 4096),
    )


def fuse_qkv_weights(ws, tp: int) -> np.ndarray:
    """Interleave q/k/v weights (each (H_in, out)) into one fused weight whose
    column-shards are self-contained per tp rank: [rank0: q|k|v | rank1: ...].
    The port runs tp = 1, where the fused weight is [q | k | v]."""
    h_in = ws[0].shape[0]
    outs = [w.shape[1] for w in ws]
    for o in outs:
        if o % tp:
            raise ValueError(
                f"fused_qkv: projection width {o} is not divisible by "
                f"tp_degree {tp} — disable fused_qkv for this model/tp"
            )
    parts = [np.asarray(w).reshape(h_in, tp, o // tp) for w, o in zip(ws, outs)]
    return np.concatenate(parts, axis=-1).reshape(h_in, sum(outs))


def fuse_qkv_biases(bs, tp: int) -> np.ndarray:
    parts = [np.asarray(b).reshape(tp, b.shape[0] // tp) for b in bs]
    return np.concatenate(parts, axis=-1).reshape(-1)


def _fuse_qkv(attn: Dict[str, Any], tp: int) -> None:
    """Replace q/k/v_proj of one layer's attention dict by the fused
    ``qkv_proj`` (numpy interleave; bfloat16 goes through its bits, which the
    interleave only moves)."""
    qp, kp, vp = attn.pop("q_proj"), attn.pop("k_proj"), attn.pop("v_proj")

    def fuse(fn, key):
        ts = [p[key] for p in (qp, kp, vp)]
        bits = [t.view(torch.int16) if t.dtype == torch.bfloat16 else t for t in ts]
        out = torch.from_numpy(np.ascontiguousarray(fn([b.numpy() for b in bits], tp)))
        return out.view(torch.bfloat16) if ts[0].dtype == torch.bfloat16 else out

    fused = {"w": fuse(fuse_qkv_weights, "w")}
    if "b" in qp:
        fused["b"] = fuse(fuse_qkv_biases, "b")
    attn["qkv_proj"] = fused


def _stack(layers):
    """Stack a list of identical nested dicts along a new leading axis."""
    first = layers[0]
    return {
        k: _stack([lay[k] for lay in layers]) if isinstance(first[k], dict)
        else torch.stack([lay[k] for lay in layers])
        for k in first
    }


def convert_hf_state_dict(
    state_dict: Dict[str, Any], config: InferenceConfig, arch: DecoderArch,
    ff_converter=None,
) -> Dict[str, Any]:
    """HF llama-layout checkpoint (tensors or numpy arrays) -> layer-stacked
    params dict on the CPU, in the arch's dtype. MoE families (and Arcee's
    non-gated MLP) pass ``ff_converter(get, has, cast, layer_prefix) -> (key,
    params)`` to replace the dense MLP's conversion per layer (e.g.
    ``("moe", {...})``)."""
    dt = to_torch_dtype(arch.dtype)
    plan = gqa_plan(config)
    D = arch.head_dim

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
        q = gqa.convert_q(get(pre + "self_attn.q_proj.weight"), D, plan)
        k = gqa.convert_kv(get(pre + "self_attn.k_proj.weight"), D, plan)
        v = gqa.convert_kv(get(pre + "self_attn.v_proj.weight"), D, plan)
        o = gqa.convert_o(get(pre + "self_attn.o_proj.weight"), D, plan)
        attn: Dict[str, Any] = {
            "q_proj": {"w": cast(q.t())},
            "k_proj": {"w": cast(k.t())},
            "v_proj": {"w": cast(v.t())},
            "o_proj": {"w": cast(o.t())},
        }
        if arch.attention_bias:
            for name, fn in (("q_proj", gqa.convert_q), ("k_proj", gqa.convert_kv),
                             ("v_proj", gqa.convert_kv)):
                attn[name]["b"] = cast(fn(get(f"{pre}self_attn.{name}.bias")[:, None], D, plan)[:, 0])
        if arch.attention_o_bias:
            attn["o_proj"]["b"] = cast(get(pre + "self_attn.o_proj.bias"))
        if arch.qk_norm:
            attn["q_norm"] = cast(get(pre + "self_attn.q_norm.weight"))
            attn["k_norm"] = cast(get(pre + "self_attn.k_norm.weight"))
        if arch.fused_qkv:
            _fuse_qkv(attn, 1)  # tp_degree is 1: one rank block
        layer = {
            "input_layernorm": cast(get(pre + "input_layernorm.weight")),
            "post_attention_layernorm": cast(get(pre + "post_attention_layernorm.weight")),
            "attn": attn,
        }
        if ff_converter is not None:
            key, ff = ff_converter(get, has, cast, pre)
            layer[key] = ff
        else:
            mlp = {
                name: {"w": cast(get(f"{pre}mlp.{name}.weight").t())}
                for name in ("gate_proj", "up_proj", "down_proj")
            }
            if arch.mlp_bias:
                for name in ("gate_proj", "up_proj", "down_proj"):
                    mlp[name]["b"] = cast(get(f"{pre}mlp.{name}.bias"))
            layer["mlp"] = mlp
        layers.append(layer)

    embed = get("embed_tokens.weight")
    if arch.vocab_pad:
        embed = torch.cat([embed, embed.new_zeros((arch.vocab_pad, embed.shape[1]))])
    params: Dict[str, Any] = {
        "embed_tokens": cast(embed),
        "layers": _stack(layers),
        "norm": cast(get("norm.weight")),
    }
    if not arch.tie_word_embeddings:
        head = get("lm_head.weight") if has("lm_head.weight") else embed[: config.vocab_size]
        if arch.vocab_pad:
            head = torch.cat([head, head.new_zeros((arch.vocab_pad, head.shape[1]))])
        params["lm_head"] = cast(head.t())
    return params


def exact_gelu(act: str) -> str:
    """HF's ``ACT2FN["gelu"]`` is the exact (erf) GELU: the families whose
    configs name it so (Falcon, GPT-NeoX, BioGPT, XGLM) run the port's
    ``"gelu_exact"``, where the JAX package gives them its tanh ``"gelu"``
    (ROADMAP Queue 3). Other names pass through."""
    return "gelu_exact" if act == "gelu" else act


def state_tensor(state_dict: Dict[str, Any], name: str, prefixes=("", "model.")) -> torch.Tensor:
    """The checkpoint's tensor ``name`` under the first of ``prefixes`` it
    carries (a family's HF submodule path: ``transformer.``, ``gpt_neox.``,
    ...)."""
    for pre in prefixes:
        if pre + name in state_dict:
            return torch.as_tensor(state_dict[pre + name])
    raise KeyError(f"Missing weight {name} (prefixes {prefixes}); available sample: "
                   f"{list(state_dict)[:8]}")


def attach_norm_biases(params: Dict[str, Any], input_biases, post_biases, final_bias,
                       dtype: torch.dtype) -> Dict[str, Any]:
    """The biased-LayerNorm families (the learned-position lineage, Falcon,
    Persimmon, Phi, ...): the weight-only block norms and the final norm
    become ``{"w", "b"}`` dicts (the :func:`~nxdi_tpu_torch.models.base._norm`
    contract) from per-layer bias lists and the final norm's bias."""
    layers = params["layers"]
    for key, biases in (("input_layernorm", input_biases),
                        ("post_attention_layernorm", post_biases)):
        layers[key] = {"w": layers[key],
                       "b": torch.stack([torch.as_tensor(b) for b in biases]).to(dtype)}
    params["norm"] = {"w": params["norm"], "b": torch.as_tensor(final_bias).to(dtype)}
    return params


def param_shapes(arch: DecoderArch, norm_bias: bool = False,
                 positions: Optional[int] = None) -> Dict[str, Any]:
    """Shape tree matching :func:`convert_hf_state_dict` (random-weight
    builds and tests); ``norm_bias``: every norm a biased LayerNorm
    ``{"w", "b"}`` (Phi-3.5-MoE, the LayerNorm families); ``positions``: the
    rows of a learned position table (``learned_pos_embeds``). A biased head
    (``lm_head_bias``) and Apertus's xIELU scalars follow the arch."""
    H, KV, D = arch.num_attention_heads, arch.num_kv_heads, arch.head_dim
    hs, inter, V, L = arch.hidden_size, arch.intermediate_size, arch.vocab_size, arch.num_layers
    params: Dict[str, Any] = {
        "embed_tokens": (V, hs),
        "layers": {
            "input_layernorm": (L, hs),
            "post_attention_layernorm": (L, hs),
            "attn": {
                "q_proj": {"w": (L, hs, H * D)},
                "k_proj": {"w": (L, hs, KV * D)},
                "v_proj": {"w": (L, hs, KV * D)},
                "o_proj": {"w": (L, H * D, hs)},
            },
            "mlp": {
                "gate_proj": {"w": (L, hs, inter)},
                "up_proj": {"w": (L, hs, inter)},
                "down_proj": {"w": (L, inter, hs)},
            },
        },
        "norm": (hs,),
    }
    attn, mlp = params["layers"]["attn"], params["layers"]["mlp"]
    if arch.attention_bias:
        for name, n in (("q_proj", H), ("k_proj", KV), ("v_proj", KV)):
            attn[name]["b"] = (L, n * D)
    if arch.attention_o_bias:
        attn["o_proj"]["b"] = (L, hs)
    if arch.qk_norm:
        attn["q_norm"], attn["k_norm"] = (L, D), (L, D)
    elif arch.qk_norm_flat:
        attn["q_norm"], attn["k_norm"] = (L, H * D), (L, KV * D)
    if arch.attention_sink:
        attn["sink"] = (L, H)
    if arch.attn_out_gate:
        attn["gate_proj"] = {"w": (L, hs, H * D)}
    if arch.sandwich_norm:
        params["layers"]["pre_feedforward_layernorm"] = (L, hs)
        params["layers"]["post_feedforward_layernorm"] = (L, hs)
    if arch.fused_qkv:
        qkv = {"w": (L, hs, (H + 2 * KV) * D)}
        if arch.attention_bias:
            qkv["b"] = (L, (H + 2 * KV) * D)
        for name in ("q_proj", "k_proj", "v_proj"):
            del attn[name]
        attn["qkv_proj"] = qkv
    if not arch.gated_mlp:
        del mlp["gate_proj"]
    if arch.mlp_bias:
        for name, p in mlp.items():
            p["b"] = (L, hs if name == "down_proj" else inter)
    if arch.moe is not None:
        del params["layers"]["mlp"]
        params["layers"]["moe"] = moe_param_shapes(arch.moe, hs, L)
    if not arch.tie_word_embeddings:
        params["lm_head"] = (hs, V)
    if norm_bias:
        layers = params["layers"]
        for key in [k for k in layers if k.endswith("layernorm")]:
            layers[key] = {"w": layers[key], "b": layers[key]}
        params["norm"] = {"w": (hs,), "b": (hs,)}
    if arch.learned_pos_embeds:
        params["position_embeddings"] = (positions, hs)
    if arch.lm_head_bias:
        params["lm_head_bias"] = (V,)
    if arch.hidden_act == "xielu":
        mlp["xielu"] = {"alpha_p": (L, 1), "alpha_n": (L, 1)}
    return params


def moe_param_shapes(moe, hidden_size: int, num_layers: int) -> Dict[str, Any]:
    """Shapes of the layer-stacked MoE params (the router and experts of the
    JAX package's ``moe_shape_struct``): the router's bias (``router_bias``)
    and selection-only correction bias ``e_bias`` (``correction_bias``),
    the experts' biases (``expert_bias``) and the shared expert where the
    arch has them."""
    E, H, I, L = moe.num_experts, hidden_size, moe.intermediate_size, num_layers
    shapes: Dict[str, Any] = {
        "router": {"w": (L, H, E)},
        "experts": {
            "gate_proj": {"w": (L, E, H, I)},
            "up_proj": {"w": (L, E, H, I)},
            "down_proj": {"w": (L, E, I, H)},
        },
    }
    if moe.router_bias:
        shapes["router"]["b"] = (L, E)
    if moe.correction_bias:
        shapes["router"]["e_bias"] = (L, E)
    if moe.expert_bias:
        ex = shapes["experts"]
        ex["gate_proj"]["b"], ex["up_proj"]["b"], ex["down_proj"]["b"] = (L, E, I), (L, E, I), (
            L, E, H)
    if moe.shared_expert_intermediate_size:
        Is = moe.shared_expert_intermediate_size
        shapes["shared_expert"] = {"gate_proj": {"w": (L, H, Is)}, "up_proj": {"w": (L, H, Is)},
                                   "down_proj": {"w": (L, Is, H)}}
    return shapes


# a weight whose float32 draw would exceed this is drawn in pieces of
# _DRAW_PIECE elements (DeepSeek-V3's expert tensors: 15 GB in float32)
_DRAW_WHOLE_BYTES = 2 ** 31
_DRAW_PIECE = 2 ** 28


def random_params(arch: DecoderArch, seed: int = 0, std: float = 0.02, device=None,
                  shapes=None):
    """Random weights in the arch's dtype from one ``torch.Generator`` seed,
    on ``device`` (the card unless the CPU is asked for): projections,
    embeddings, sinks and biases N(0, std), norm weights one and norm biases
    zero (HF's init), so activations keep unit scale and greedy tokens are
    well separated; a router's selection-only ``e_bias``, a head bias and
    the xIELU scalars (0.8 after softplus, HF's init) in float32, as the
    converters keep them. ``shapes`` (default :func:`param_shapes`) is a shape
    tree whose ``layers`` may be a list of segments. A weight too large to
    draw in float32 at once is drawn in pieces, each cast as it is drawn."""
    device = resolve_device(device)
    dt = to_torch_dtype(arch.dtype)
    gen = torch.Generator(device=device).manual_seed(seed)

    def make(path, shape):
        if len(path) > 1 and path[-2] == "xielu":
            return torch.full(shape, 0.8, dtype=torch.float32, device=device)
        if len(path) > 1 and path[-2].endswith("norm") and path[-1] in ("w", "b"):
            # a biased LayerNorm {"w", "b"}: unit weight, zero bias
            fill = torch.ones if path[-1] == "w" else torch.zeros
            return fill(shape, dtype=dt, device=device)
        if path[-1].endswith("norm"):
            # a gemma-style norm multiplies by 1 + w: a zero offset is unit scale
            fill = torch.zeros if arch.gemma_norm else torch.ones
            return fill(shape, dtype=dt, device=device)
        if math.prod(shape) * 4 <= _DRAW_WHOLE_BYTES:
            x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device) * std
            return x.to(dt)
        out = torch.empty(shape, dtype=dt, device=device)
        flat = out.view(-1)
        for a in range(0, flat.numel(), _DRAW_PIECE):
            n = min(_DRAW_PIECE, flat.numel() - a)
            flat[a:a + n] = torch.randn((n,), generator=gen, dtype=torch.float32,
                                        device=device) * std
        return out

    def walk(tree, path):
        if isinstance(tree, list):
            return [walk(v, path + (str(i),)) for i, v in enumerate(tree)]
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        leaf = make(path, tree)
        return leaf.float() if path[-1] in ("e_bias", "lm_head_bias") else leaf

    return walk(param_shapes(arch) if shapes is None else shapes, ())


class DenseInferenceConfig(InferenceConfig):
    """Common hyperparameter surface for the llama lineage."""

    REQUIRED = [
        "hidden_size",
        "num_attention_heads",
        "num_hidden_layers",
        "num_key_value_heads",
        "vocab_size",
        "intermediate_size",
        "rms_norm_eps",
    ]

    def add_derived_config(self):
        super().add_derived_config()
        defaults = {
            "rope_theta": 10000.0,
            "rope_scaling": None,
            "tie_word_embeddings": False,
            "hidden_act": "silu",
            "attention_bias": False,
            "mlp_bias": False,
        }
        for k, v in defaults.items():
            if not hasattr(self, k):
                setattr(self, k, v)
