"""MiMo-V2-Flash (counterpart of ``nxdi_tpu/models/mimo_v2/modeling_mimo_v2.py``):
a hybrid decoder of full-attention and sliding-window layers, each type with
its own head counts, head widths and rope theta, whose values are narrower
than its queries and keys, and a per-layer choice of a dense MLP or a
sigmoid-routed mixture of experts.

- ``hybrid_layer_pattern``: two per-type :class:`~nxdi_tpu_torch.models.base.DecoderArch`
  variants walked in depth order over segments (:class:`MiMoV2Arch`), each
  type with its own layer-stacked cache: ``k`` / ``v`` (full attention) and
  ``k_swa`` / ``v_swa`` (the sliding window). Under ``window_sized_kv`` only
  the sliding-window stack shrinks, to a ring (``application.py``).
- the value width apart from q/k's (192 against 128 at the published widths):
  ``DecoderArch.v_head_dim``; the V stack of the cache takes it. No attention
  kernel takes it (the JAX rule): attention is plain, the commit kernel lands
  the decode's rows.
- partial rotary per type (``partial_rotary_factor``, rounded down to even):
  ``DecoderArch.rotary_dim``.
- ``moe_layer_freq``: the segments also split where a layer's feed-forward
  changes between dense and MoE; the router scores by sigmoid and renormalizes
  its top-k (``ops/moe.py``).

HF weight layout: Llama-style attention; the router ``mlp.gate``; experts
``mlp.experts.{i}.gate/up/down_proj``; dense layers ``mlp.gate/up/down_proj``.
The JAX package's ``param_specs`` belongs to parallelism (ROADMAP Queue 1);
:func:`random_params` takes the place of its ``param_shape_struct``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F

from nxdi_tpu_torch.config import InferenceConfig, to_torch_dtype
from nxdi_tpu_torch.kvcache.kv_cache import DEFAULT_KV_LAYOUT, WindowKVLayout
from nxdi_tpu_torch.models import dense
from nxdi_tpu_torch.models.base import (
    CACHE_INPUT_KEYS,
    DecoderArch,
    lm_head_outputs,
    run_decoder_layers,
)
from nxdi_tpu_torch.ops.moe import MoEArch, convert_hf_experts
from nxdi_tpu_torch.ops.rope import inv_freq_from_hf_config, rope_cos_sin
from nxdi_tpu_torch.parallel import gqa

# MiMo-V2-Flash at its published widths (HF XiaomiMiMo/MiMo-V2-Flash
# config.json), its depth cut to four layers: the first (full attention, a
# dense MLP), then three sliding-window MoE layers
MIMO_V2_FLASH = dict(
    model_type="mimo_v2",
    hidden_size=4096,
    num_hidden_layers=4,
    hybrid_layer_pattern=[0, 1, 1, 1],
    moe_layer_freq=[0, 1, 1, 1],
    num_attention_heads=64,
    num_key_value_heads=4,
    head_dim=192,
    v_head_dim=128,
    swa_num_attention_heads=64,
    swa_num_key_value_heads=8,
    swa_head_dim=192,
    swa_v_head_dim=128,
    sliding_window=128,
    partial_rotary_factor=0.334,
    rope_theta=5000000.0,
    swa_rope_theta=10000.0,
    n_routed_experts=256,
    num_experts_per_tok=8,
    moe_intermediate_size=2048,
    intermediate_size=16384,
    scoring_func="sigmoid",
    norm_topk_prob=True,
    vocab_size=152576,
    max_position_embeddings=262144,
    layernorm_epsilon=1e-5,
    hidden_act="silu",
    tie_word_embeddings=False,
)


class MiMoV2InferenceConfig(dense.DenseInferenceConfig):
    REQUIRED = [
        "hidden_size", "num_hidden_layers", "num_attention_heads",
        "num_key_value_heads", "head_dim", "v_head_dim", "vocab_size",
        "hybrid_layer_pattern", "moe_layer_freq", "n_routed_experts",
        "num_experts_per_tok", "moe_intermediate_size", "partial_rotary_factor",
        "sliding_window", "swa_head_dim", "swa_v_head_dim",
        "swa_num_attention_heads", "swa_num_key_value_heads", "swa_rope_theta",
        "rope_theta",
    ]

    def add_derived_config(self):
        if not hasattr(self, "rms_norm_eps"):
            self.rms_norm_eps = getattr(self, "layernorm_epsilon", 1e-6)
        if not hasattr(self, "intermediate_size"):
            # the dense layers' width; the experts take moe_intermediate_size
            self.intermediate_size = getattr(
                self, "dense_intermediate_size", self.moe_intermediate_size)
        super().add_derived_config()


def _rope_dim(head_dim: int, factor: float) -> int:
    rd = int(head_dim * factor)
    return rd - (rd % 2)


@dataclass(frozen=True)
class MiMoV2Arch:
    """The two per-type decoder arches and the depth-ordered segment walk.

    Each schedule entry is (attention type, type-local first layer, type-local
    end, index of its params segment in ``params["segments"]``): a half-open
    range into that type's stacked cache."""

    full: DecoderArch
    swa: DecoderArch
    schedule: Tuple[Tuple[str, int, int, int], ...]
    swa_theta: float

    def kv_cache_spec(self, batch_size: int, max_len: int):
        return self.full.kv_cache_spec(batch_size, max_len)

    @property
    def num_layers(self) -> int:
        return self.full.num_layers + self.swa.num_layers

    @property
    def kv_window_pattern(self) -> Tuple[bool, ...]:
        """Depth-ordered window flags: the layout choice keeps the contiguous
        layout primary under ``window_sized_kv``, only the sliding-window stack
        rides the ring."""
        flags: List[bool] = []
        for kind, lo, hi, _ in self.schedule:
            flags.extend([kind == "swa"] * (hi - lo))
        return tuple(flags)

    @property
    def sliding_window(self):
        """The sliding-window layers' window (the ring's lower bound)."""
        return self.swa.sliding_window if self.swa.num_layers else None

    def interleaved_split(self):
        """(full layers, window layers) when both types are present."""
        if self.full.num_layers and self.swa.num_layers:
            return self.full.num_layers, self.swa.num_layers
        return None

    def __getattr__(self, name):
        # the runtime reads the generic decoder fields (vocab, dtype, the
        # family switches) off the full-attention arch
        return getattr(object.__getattribute__(self, "full"), name)


def _moe_arch(config: InferenceConfig) -> MoEArch:
    return MoEArch(
        num_experts=config.n_routed_experts,
        top_k=config.num_experts_per_tok,
        intermediate_size=config.moe_intermediate_size,
        hidden_act=getattr(config, "hidden_act", "silu"),
        norm_topk_prob=bool(getattr(config, "norm_topk_prob", True)),
        sigmoid_routing=str(getattr(config, "scoring_func", "sigmoid")) == "sigmoid",
        dispatch=config.tpu_config.moe_dispatch,
    )


def _layer_types(config) -> List[str]:
    return ["swa" if p == 1 else "full" for p in config.hybrid_layer_pattern]


def _layer_moe(config) -> List[bool]:
    return [bool(f) for f in config.moe_layer_freq]


def build_arch(config: InferenceConfig, **overrides) -> MiMoV2Arch:
    tp = config.tpu_config.tp_degree
    prf = float(config.partial_rotary_factor)
    types = _layer_types(config)
    moe = _moe_arch(config)
    # the fused MLP serves the dense layers (the JAX rule); MoE layers never
    # run it
    has_dense = not all(_layer_moe(config))

    def type_arch(kind: str) -> DecoderArch:
        if kind == "swa":
            heads, kv = config.swa_num_attention_heads, config.swa_num_key_value_heads
            hd, vd = config.swa_head_dim, config.swa_v_head_dim
            window = config.sliding_window
        else:
            heads, kv = config.num_attention_heads, config.num_key_value_heads
            hd, vd = config.head_dim, config.v_head_dim
            window = None
        plan = gqa.plan_gqa_sharding(tp, heads, kv)
        rd = _rope_dim(hd, prf)
        return dense.build_arch(
            config,
            has_dense_mlp=has_dense,
            num_layers=types.count(kind),
            num_attention_heads=plan.target_heads,
            num_kv_heads=plan.target_kv,
            head_dim=hd,
            v_head_dim=None if vd == hd else vd,
            sliding_window=window,
            rotary_dim=rd if rd < hd else None,
            moe=moe,
            **overrides,
        )

    # the depth walk, a new segment where (type, MoE) changes
    schedule: List[Tuple[str, int, int, int]] = []
    counters = {"full": 0, "swa": 0}
    prev = None
    for kind, use_moe in zip(types, _layer_moe(config)):
        lo = counters[kind]
        if (kind, use_moe) == prev:
            t, a, b, s = schedule[-1]
            schedule[-1] = (t, a, b + 1, s)
        else:
            schedule.append((kind, lo, lo + 1, len(schedule)))
            prev = (kind, use_moe)
        counters[kind] += 1
    return MiMoV2Arch(
        full=type_arch("full"),
        swa=type_arch("swa"),
        schedule=tuple(schedule),
        swa_theta=float(getattr(config, "swa_rope_theta", 10000.0)),
    )


def build_inv_freq(config: InferenceConfig) -> Dict[str, Any]:
    """The two types' frequency tables: partial rotary widths, two thetas."""
    prf = float(config.partial_rotary_factor)
    return {
        "full": inv_freq_from_hf_config(_rope_dim(config.head_dim, prf), config.rope_theta, None),
        "swa": inv_freq_from_hf_config(_rope_dim(config.swa_head_dim, prf),
                                       getattr(config, "swa_rope_theta", 10000.0), None),
    }


# ---------------------------------------------------------------------------
# The forward: a segment walk over two attention types
# ---------------------------------------------------------------------------


def causal_lm_forward(arch: MiMoV2Arch, inv_freq, params: Dict[str, Any],
                      cache: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor], *,
                      attend_to_cache: bool, kv_window=None, layout=DEFAULT_KV_LAYOUT,
                      **head_kwargs):
    """One submodel forward: the segments in depth order, each over its
    type-local slice of its type's stack (views: the writes land in place),
    full layers under ``layout``, sliding-window layers under it too or,
    when ``k_swa`` holds fewer slots than ``k`` (``window_sized_kv``), under
    a :class:`WindowKVLayout` of its slots; then the decoder's head
    (:func:`~nxdi_tpu_torch.models.base.lm_head_outputs`)."""
    t = arch.full
    input_ids, position_ids = batch["input_ids"], batch["position_ids"]
    hidden = F.embedding(input_ids.long(), params["embed_tokens"]).to(to_torch_dtype(t.dtype))
    rope = {kind: rope_cos_sin(position_ids, inv_freq[kind], dtype=torch.float32)
            for kind in ("full", "swa")}
    layouts = {"full": layout, "swa": layout}
    if cache["k_swa"].shape[3] < cache["k"].shape[3]:
        layouts["swa"] = WindowKVLayout(window=cache["k_swa"].shape[3],
                                        route_by_seq_id=getattr(layout, "route_by_seq_id",
                                                                False))
    stacks = {"full": ("k", "v"), "swa": ("k_swa", "v_swa")}
    # the layout inputs, collected once: seq_ids (continuous batching), the
    # verify's write positions, last_token_index (the ring's keep mask)
    cache_inputs = {k: batch[k] for k in CACHE_INPUT_KEYS if k in batch}
    for kind, lo, hi, seg_idx in arch.schedule:
        ta = arch.full if kind == "full" else arch.swa
        ck, cv = (cache[name] for name in stacks[kind])
        spec = ta.kv_cache_spec(ck.shape[1], ck.shape[3])
        cos, sin = rope[kind]
        hidden, _ = run_decoder_layers(
            ta, params["segments"][seg_idx], hidden, cos, sin, {"k": ck[lo:hi], "v": cv[lo:hi]},
            position_ids, spec, attend_to_cache, kv_window=kv_window, layout=layouts[kind],
            cache_inputs=cache_inputs)
    return lm_head_outputs(t, params, batch, hidden, cache, **head_kwargs)


# ---------------------------------------------------------------------------
# Conversion and random weights
# ---------------------------------------------------------------------------


def _convert_layer(get, config, arch: MiMoV2Arch, i: int, kind: str, use_moe: bool):
    ta = arch.full if kind == "full" else arch.swa
    tp = config.tpu_config.tp_degree
    if kind == "swa":
        plan = gqa.plan_gqa_sharding(tp, config.swa_num_attention_heads,
                                     config.swa_num_key_value_heads)
    else:
        plan = gqa.plan_gqa_sharding(tp, config.num_attention_heads, config.num_key_value_heads)
    D = ta.head_dim
    Dv = ta.v_head_dim or D
    dt = to_torch_dtype(ta.dtype)

    def cast(x):
        return x.to(dt).contiguous()

    pre = f"layers.{i}."
    layer = {
        "input_layernorm": cast(get(pre + "input_layernorm.weight")),
        "post_attention_layernorm": cast(get(pre + "post_attention_layernorm.weight")),
        "attn": {
            "q_proj": {"w": cast(gqa.convert_q(get(pre + "self_attn.q_proj.weight"), D, plan).t())},
            "k_proj": {"w": cast(gqa.convert_kv(get(pre + "self_attn.k_proj.weight"), D, plan).t())},
            "v_proj": {"w": cast(gqa.convert_kv(get(pre + "self_attn.v_proj.weight"), Dv,
                                                plan).t())},
            "o_proj": {"w": cast(gqa.convert_o(get(pre + "self_attn.o_proj.weight"), Dv,
                                               plan).t())},
        },
    }
    if use_moe:
        layer["moe"] = convert_hf_experts(
            get, cast, arch.full.moe.num_experts, pre + "mlp.gate.weight",
            lambda j, proj: f"{pre}mlp.experts.{j}.{proj}_proj.weight")
    else:
        layer["mlp"] = {name: {"w": cast(get(f"{pre}mlp.{name}.weight").t())}
                        for name in ("gate_proj", "up_proj", "down_proj")}
    return layer


def convert_hf_state_dict(state_dict: Dict[str, Any], config: InferenceConfig) -> Dict[str, Any]:
    """HF checkpoint (tensors or numpy arrays) -> ``{"embed_tokens",
    "segments": [one layer-stacked dict per schedule segment], "norm",
    ["lm_head"]}`` on the CPU in the arch's dtype, leaf for leaf the JAX
    package's."""
    arch = build_arch(config)
    t = arch.full
    dt = to_torch_dtype(t.dtype)

    def get(name):
        for k in (f"model.{name}", name):
            if k in state_dict:
                return torch.as_tensor(state_dict[k])
        raise KeyError(f"Missing weight {name}; available sample: {list(state_dict)[:8]}")

    segments: List[Any] = []
    bucket: List[Any] = []
    prev = None
    for i, key in enumerate(zip(_layer_types(config), _layer_moe(config))):
        if prev is not None and key != prev:
            segments.append(dense._stack(bucket))
            bucket = []
        bucket.append(_convert_layer(get, config, arch, i, *key))
        prev = key
    segments.append(dense._stack(bucket))

    embed = get("embed_tokens.weight")
    if t.vocab_pad:
        embed = torch.cat([embed, embed.new_zeros((t.vocab_pad, embed.shape[1]))])
    params: Dict[str, Any] = {
        "embed_tokens": embed.to(dt).contiguous(),
        "segments": segments,
        "norm": get("norm.weight").to(dt).contiguous(),
    }
    if not t.tie_word_embeddings:
        head = torch.as_tensor(state_dict["lm_head.weight"])
        if t.vocab_pad:
            head = torch.cat([head, head.new_zeros((t.vocab_pad, head.shape[1]))])
        params["lm_head"] = head.t().to(dt).contiguous()
    return params


def param_shapes(config: InferenceConfig) -> Dict[str, Any]:
    """Shape tree matching :func:`convert_hf_state_dict`."""
    arch = build_arch(config)
    t = arch.full
    hs = t.hidden_size
    order = []
    for key in zip(_layer_types(config), _layer_moe(config)):
        if not order or order[-1][0] != key:
            order.append([key, 0])
        order[-1][1] += 1
    segments = []
    for (kind, use_moe), n in order:
        ta = arch.full if kind == "full" else arch.swa
        H, KV, D = ta.num_attention_heads, ta.num_kv_heads, ta.head_dim
        Dv = ta.v_head_dim or D
        seg: Dict[str, Any] = {
            "input_layernorm": (n, hs),
            "post_attention_layernorm": (n, hs),
            "attn": {"q_proj": {"w": (n, hs, H * D)}, "k_proj": {"w": (n, hs, KV * D)},
                     "v_proj": {"w": (n, hs, KV * Dv)}, "o_proj": {"w": (n, H * Dv, hs)}},
        }
        if use_moe:
            seg["moe"] = dense.moe_param_shapes(ta.moe, hs, n)
        else:
            inter = ta.intermediate_size
            seg["mlp"] = {"gate_proj": {"w": (n, hs, inter)}, "up_proj": {"w": (n, hs, inter)},
                          "down_proj": {"w": (n, inter, hs)}}
        segments.append(seg)
    shapes = {"embed_tokens": (t.vocab_size, hs), "segments": segments, "norm": (hs,)}
    if not t.tie_word_embeddings:
        shapes["lm_head"] = (hs, t.vocab_size)
    return shapes


def random_params(config: InferenceConfig, seed: int = 0, std: float = 0.02, device=None):
    """Random weights from a seed (``dense.random_params`` over
    :func:`param_shapes`), on ``device`` (the card unless the CPU is asked
    for)."""
    return dense.random_params(build_arch(config).full, seed=seed, std=std, device=device,
                               shapes=param_shapes(config))


class MiMoV2ForCausalLM:
    def __new__(cls, *args, **kwargs):
        from nxdi_tpu_torch.models.mimo_v2.application import MiMoV2Application

        return MiMoV2Application(*args, **kwargs)


def __getattr__(name):
    # APPLICATION_CLS, lazily: application.py imports this module
    if name == "APPLICATION_CLS":
        from nxdi_tpu_torch.models.mimo_v2.application import MiMoV2Application

        return MiMoV2Application
    raise AttributeError(name)
