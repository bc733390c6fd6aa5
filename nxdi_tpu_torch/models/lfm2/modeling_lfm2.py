"""LFM2 (Liquid; counterpart of ``nxdi_tpu/models/lfm2/modeling_lfm2.py``): a
hybrid of gated short-convolution layers and full-attention layers, with a
per-layer walk over two kinds of state:

- ``k`` / ``v``: (n_attn, B_cache, KV, S, D) stacks for the attention layers,
  written at each row's positions;
- ``conv``: (n_conv, B_cache, hidden, L_cache) tails of the conv layers.

HF ``modeling_lfm2.py``'s semantics, as the JAX package matches them:

- every layer: x + op(operator_norm(x)), then x + mlp(ffn_norm(x)); a SwiGLU
  MLP (w1 / w3 / w2, no biases) at the block-adjusted width (:func:`_ff_dim`);
- attention layers: GQA without biases, a per-head q / k RMSNorm before the
  rope, ``out_proj``;
- conv layers: ``in_proj`` -> thirds (B, C, x); B * x through a depthwise
  causal conv of kernel ``conv_L_cache``; C * conv -> ``out_proj``; the decode
  state keeps the last L_cache B * x columns;
- a final ``embedding_norm``; embeddings tied by default.

Right padding: the saved conv tail keeps each row's last L_cache real
columns (by ``last_token_index``), as the JAX package does.

Continuous batching (``seq_ids``): row i reads and writes cache line
``seq_ids[i]`` in both kinds of state (``models/state_routing.py``). The
JAX package writes the attention rows with a scatter into the taken lines;
the port lands them with the commit kernel (``ops/kernels/kv_commit.py``),
with the same drops (a position or a line out of range), so a routed step
stays capturable. A row whose line lies out of range (no request sends
one: padding lanes repeat row 0's line) attends its clipped line without
its own fresh rows, where the JAX package's takes them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from nxdi_tpu_torch.config import InferenceConfig, dtype_name, to_torch_dtype
from nxdi_tpu_torch.kvcache.kv_cache import DEFAULT_KV_LAYOUT
from nxdi_tpu_torch.models.base import lm_head_outputs
from nxdi_tpu_torch.models.state_routing import put_rows, take_rows
from nxdi_tpu_torch.ops import attention as attn_ops
from nxdi_tpu_torch.ops.kernels import kv_commit
from nxdi_tpu_torch.ops.norms import rms_norm
from nxdi_tpu_torch.ops.rope import apply_rotary_pos_emb, default_inv_freq, rope_cos_sin
from nxdi_tpu_torch.runtime.device import resolve_device

# LFM2-1.2B at its published widths (HF LiquidAI/LFM2-1.2B config.json):
# attention at layers 2, 5, 8, 10, 12 and 14, short convs elsewhere;
# intermediate_size 12288 adjusted to 8192 (block_multiple_of 256)
LFM2_1_2B = dict(
    model_type="lfm2",
    hidden_size=2048,
    intermediate_size=12288,
    num_hidden_layers=16,
    num_attention_heads=32,
    num_key_value_heads=8,
    vocab_size=65536,
    max_position_embeddings=128000,
    norm_eps=1e-5,
    rope_theta=1000000.0,
    conv_L_cache=3,
    conv_bias=False,
    block_auto_adjust_ff_dim=True,
    block_ffn_dim_multiplier=1.0,
    block_multiple_of=256,
    layer_types=["full_attention" if i in (2, 5, 8, 10, 12, 14) else "conv"
                 for i in range(16)],
    tie_word_embeddings=True,
)


@dataclass(frozen=True)
class Lfm2Arch:
    num_layers: int
    hidden_size: int
    num_attention_heads: int
    num_kv_heads: int
    head_dim: int
    intermediate_size: int  # block-adjusted
    conv_kernel: int
    conv_bias: bool
    vocab_size: int
    vocab_pad: int
    layer_types: Tuple[str, ...]  # "conv" | "full_attention"
    rms_norm_eps: float
    rope_theta: float
    dtype: str
    # the DecoderArch fields lm_head_outputs reads: a plain RMSNorm, no
    # logit scaling or cap
    layernorm: bool = False
    gemma_norm: bool = False
    logits_scaling: float = 1.0
    final_logit_softcap: Optional[float] = None

    @property
    def n_attn(self) -> int:
        return sum(t == "full_attention" for t in self.layer_types)

    @property
    def n_conv(self) -> int:
        return sum(t != "full_attention" for t in self.layer_types)


class Lfm2InferenceConfig(InferenceConfig):
    REQUIRED = [
        "hidden_size",
        "intermediate_size",
        "num_hidden_layers",
        "num_attention_heads",
        "num_key_value_heads",
        "vocab_size",
    ]

    def add_derived_config(self):
        for k, v in (("conv_L_cache", 3), ("conv_bias", False), ("norm_eps", 1e-5)):
            if not hasattr(self, k):
                setattr(self, k, v)
        if getattr(self, "head_dim", None) is None:
            self.head_dim = self.hidden_size // self.num_attention_heads
        if getattr(self, "layer_types", None) is None:
            self.layer_types = ["full_attention"] * self.num_hidden_layers


def _ff_dim(config: InferenceConfig) -> int:
    """HF ``Lfm2MLP``'s block-adjusted width."""
    inter = config.intermediate_size
    if getattr(config, "block_auto_adjust_ff_dim", True):
        inter = int(2 * inter / 3)
        mult = getattr(config, "block_ffn_dim_multiplier", None)
        if mult is not None:
            inter = int(mult * inter)
        m = getattr(config, "block_multiple_of", 256)
        inter = m * ((inter + m - 1) // m)
    return inter


def build_arch(config: InferenceConfig, **overrides) -> Lfm2Arch:
    kwargs = dict(
        num_layers=config.num_hidden_layers,
        hidden_size=config.hidden_size,
        num_attention_heads=config.num_attention_heads,
        num_kv_heads=config.num_key_value_heads,
        head_dim=config.head_dim,
        intermediate_size=_ff_dim(config),
        conv_kernel=int(config.conv_L_cache),
        conv_bias=bool(config.conv_bias),
        vocab_size=config.vocab_size,
        vocab_pad=0,
        layer_types=tuple(config.layer_types),
        rms_norm_eps=float(getattr(config, "norm_eps", 1e-5)),
        rope_theta=float(getattr(config, "rope_theta", 1000000.0)),
        dtype=dtype_name(config.tpu_config.dtype),
    )
    kwargs.update(overrides)
    return Lfm2Arch(**kwargs)


def build_inv_freq(config: InferenceConfig):
    return default_inv_freq(config.head_dim, float(getattr(config, "rope_theta", 1000000.0)))


def attention_layer(arch: Lfm2Arch, lp, x, cos, sin, k_stack, v_stack, ai: int, position_ids,
                    seq_ids, attend_to_cache: bool, kv_window: Optional[int]):
    """One attention layer over its stack ``ai``: the fresh rows land through
    the commit kernel (positions and lines out of range drop), then a decode
    attends the row's (clipped) line, a prefill its own fresh rows."""
    B, S, _ = x.shape
    H, KV, D = arch.num_attention_heads, arch.num_kv_heads, arch.head_dim
    q = (x @ lp["q_w"]).reshape(B, S, H, D)
    k = (x @ lp["k_w"]).reshape(B, S, KV, D)
    v = (x @ lp["v_w"]).reshape(B, S, KV, D)
    # per-head q / k RMSNorm before the rope (HF Lfm2Attention's q/k_layernorm)
    q = rms_norm(q, lp["q_norm"], arch.rms_norm_eps).transpose(1, 2)
    k = rms_norm(k, lp["k_norm"], arch.rms_norm_eps).transpose(1, 2)
    v = v.transpose(1, 2)
    q, k = apply_rotary_pos_emb(q, k, cos, sin)
    pos = position_ids.to(torch.int32)
    kc, vc = k_stack[ai:ai + 1], v_stack[ai:ai + 1]
    kv_commit.kv_commit_rows(kc, vc, k.to(kc.dtype)[None], v.to(vc.dtype)[None], pos, seq_ids)
    if attend_to_cache:
        W = kv_window if kv_window is not None else kc.shape[3]
        kk = take_rows(k_stack[ai][:, :, :W], seq_ids).to(q.dtype)
        vv = take_rows(v_stack[ai][:, :, :W], seq_ids).to(q.dtype)
        kv_pos = torch.arange(W, dtype=torch.int32, device=q.device)[None, :].expand(B, W)
        ctx = attn_ops.attention_with_positions(q, kk, vv, pos, kv_pos)
    else:
        ctx = attn_ops.attention_with_positions(q, k, v, pos, pos)
    return ctx.transpose(1, 2).reshape(B, S, H * D) @ lp["o_w"]


def conv_layer(arch: Lfm2Arch, lp, x, conv_state, last_token_index, is_decode: bool):
    """HF ``Lfm2ShortConv``: thirds of the projection gate a depthwise causal
    conv. Returns (the output, the new (B, hidden, K) tail)."""
    B, S, _ = x.shape
    K = arch.conv_kernel
    bcx = x @ lp["in_w"]
    if arch.conv_bias:
        bcx = bcx + lp["in_b"]
    Bg, Cg, xg = bcx.chunk(3, dim=-1)
    bx = (Bg * xg).transpose(1, 2)  # (B, hidden, S)
    w = lp["conv_w"]  # (hidden, K)
    if is_decode:
        window = torch.cat([conv_state[:, :, 1:], bx], dim=-1)  # (B, hidden, K)
        out = (window * w[None]).sum(dim=-1)
        if arch.conv_bias:
            out = out + lp["conv_b"]
        conv_out = out[:, None, :]
        new_conv = window
    else:
        padded = F.pad(bx, (K - 1, 0))
        conv = sum(padded[:, :, j:j + S] * w[:, j][None, :, None] for j in range(K))
        if arch.conv_bias:
            conv = conv + lp["conv_b"][None, :, None]
        conv_out = conv.transpose(1, 2)
        # the tail: each row's last K real columns (right padding skipped)
        lti = last_token_index.to(torch.int64)
        idx = lti[:, None] - torch.arange(K - 1, -1, -1, device=x.device)[None, :]
        gathered = torch.gather(F.pad(bx, (0, 1)), 2,
                                idx.clamp(0, S)[:, None, :].expand(B, bx.shape[1], K))
        new_conv = torch.where((idx >= 0)[:, None, :], gathered,
                               torch.zeros((), dtype=gathered.dtype, device=x.device))
        new_conv = new_conv.to(conv_state.dtype)
    y = (Cg * conv_out) @ lp["out_w"]
    if arch.conv_bias:
        y = y + lp["out_b"]
    return y, new_conv


def lfm2_forward(arch: Lfm2Arch, inv_freq, params: Dict[str, Any], cache: Dict[str, torch.Tensor],
                 batch: Dict[str, torch.Tensor], *, attend_to_cache: bool,
                 kv_window: Optional[int] = None, layout=DEFAULT_KV_LAYOUT, **head_kwargs):
    """One submodel forward; the cache is updated in place. ``seq_ids``, when
    the batch carries it, routes both the conv tails and the attention
    stacks; then the decoder's head
    (:func:`~nxdi_tpu_torch.models.base.lm_head_outputs`)."""
    input_ids, position_ids = batch["input_ids"], batch["position_ids"]
    B, S = input_ids.shape
    hidden = F.embedding(input_ids.long(), params["embed_tokens"]).to(to_torch_dtype(arch.dtype))
    cos, sin = rope_cos_sin(position_ids, inv_freq, dtype=torch.float32)
    lti = batch.get("last_token_index")
    if lti is None:
        lti = torch.full((B,), S - 1, dtype=torch.int32, device=input_ids.device)
    sids = batch.get("seq_ids")  # continuous batching: row i -> cache line
    ai = ci = 0
    for lt, lp in zip(arch.layer_types, params["layers"]):
        h = rms_norm(hidden, lp["operator_norm"], arch.rms_norm_eps)
        if lt == "full_attention":
            out = attention_layer(arch, lp, h, cos, sin, cache["k"], cache["v"], ai, position_ids,
                                  sids, attend_to_cache, kv_window)
            ai += 1
        else:
            out, c_new = conv_layer(arch, lp, h, take_rows(cache["conv"][ci], sids), lti,
                                    attend_to_cache)
            put_rows(cache["conv"], ci, c_new, sids)
            ci += 1
        hidden = hidden + out
        h = rms_norm(hidden, lp["ffn_norm"], arch.rms_norm_eps)
        hidden = hidden + (F.silu(h @ lp["w1"]) * (h @ lp["w3"])) @ lp["w2"]
    return lm_head_outputs(arch, params, batch, hidden, cache, **head_kwargs)


# ---------------------------------------------------------------------------
# Conversion, shapes and random weights
# ---------------------------------------------------------------------------


def convert_hf_state_dict(state_dict, config: InferenceConfig) -> Dict[str, Any]:
    """HF checkpoint (tensors or numpy arrays) -> ``{"embed_tokens", "norm",
    "layers": [one dict per layer], ["lm_head"]}`` on the CPU in the arch's
    dtype, leaf for leaf the JAX package's."""
    arch = build_arch(config)
    dt = to_torch_dtype(arch.dtype)

    def get(name):
        for k in (name, f"model.{name}"):
            if k in state_dict:
                return torch.as_tensor(state_dict[k])
        raise KeyError(name)

    def cast(x):
        return x.to(dt).contiguous()

    layers = []
    for i, lt in enumerate(arch.layer_types):
        p = f"layers.{i}."
        layer: Dict[str, Any] = {
            "operator_norm": cast(get(p + "operator_norm.weight")),
            "ffn_norm": cast(get(p + "ffn_norm.weight")),
            "w1": cast(get(p + "feed_forward.w1.weight").t()),
            "w3": cast(get(p + "feed_forward.w3.weight").t()),
            "w2": cast(get(p + "feed_forward.w2.weight").t()),
        }
        if lt == "full_attention":
            layer.update(
                q_w=cast(get(p + "self_attn.q_proj.weight").t()),
                k_w=cast(get(p + "self_attn.k_proj.weight").t()),
                v_w=cast(get(p + "self_attn.v_proj.weight").t()),
                o_w=cast(get(p + "self_attn.out_proj.weight").t()),
                q_norm=cast(get(p + "self_attn.q_layernorm.weight")),
                k_norm=cast(get(p + "self_attn.k_layernorm.weight")),
            )
        else:
            layer.update(
                in_w=cast(get(p + "conv.in_proj.weight").t()),
                out_w=cast(get(p + "conv.out_proj.weight").t()),
                conv_w=cast(get(p + "conv.conv.weight")[:, 0, :]),  # (H, 1, K) -> (H, K)
            )
            if arch.conv_bias:
                layer.update(in_b=cast(get(p + "conv.in_proj.bias")),
                             out_b=cast(get(p + "conv.out_proj.bias")),
                             conv_b=cast(get(p + "conv.conv.bias")))
        layers.append(layer)
    params = {"embed_tokens": cast(get("embed_tokens.weight")),
              "norm": cast(get("embedding_norm.weight")), "layers": layers}
    # the config's flag decides: a tied checkpoint may still carry a copy
    if not getattr(config, "tie_word_embeddings", True):
        params["lm_head"] = cast(torch.as_tensor(state_dict["lm_head.weight"]).t())
    return params


def param_shapes(config: InferenceConfig) -> Dict[str, Any]:
    """Shape tree matching :func:`convert_hf_state_dict`."""
    arch = build_arch(config)
    Hd, I, KV, D = arch.hidden_size, arch.intermediate_size, arch.num_kv_heads, arch.head_dim
    layers = []
    for lt in arch.layer_types:
        layer = {"operator_norm": (Hd,), "ffn_norm": (Hd,), "w1": (Hd, I), "w3": (Hd, I),
                 "w2": (I, Hd)}
        if lt == "full_attention":
            layer.update(q_w=(Hd, arch.num_attention_heads * D), k_w=(Hd, KV * D),
                         v_w=(Hd, KV * D), o_w=(arch.num_attention_heads * D, Hd),
                         q_norm=(D,), k_norm=(D,))
        else:
            layer.update(in_w=(Hd, 3 * Hd), out_w=(Hd, Hd), conv_w=(Hd, arch.conv_kernel))
            if arch.conv_bias:
                layer.update(in_b=(3 * Hd,), out_b=(Hd,), conv_b=(Hd,))
        layers.append(layer)
    shapes = {"embed_tokens": (arch.vocab_size, Hd), "norm": (Hd,), "layers": layers}
    if not getattr(config, "tie_word_embeddings", True):
        shapes["lm_head"] = (Hd, arch.vocab_size)
    return shapes


def random_params(config: InferenceConfig, seed: int = 0, std: float = 0.02, device=None):
    """Random weights in the arch's dtype from one generator seed, on
    ``device`` (the card unless the CPU is asked for): norms one, every other
    weight N(0, std)."""
    device = resolve_device(device)
    dt = to_torch_dtype(build_arch(config).dtype)
    gen = torch.Generator(device=device).manual_seed(seed)

    def walk(tree, name):
        if isinstance(tree, list):
            return [walk(v, name) for v in tree]
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if name.endswith("norm"):
            return torch.ones(tree, dtype=dt, device=device)
        return (torch.randn(tree, generator=gen, device=device) * std).to(dt)

    return walk(param_shapes(config), "")


def cache_shapes(arch: Lfm2Arch, batch_size: int, seq_len: int):
    dt = to_torch_dtype(arch.dtype)
    kv = (arch.n_attn, batch_size, arch.num_kv_heads, seq_len, arch.head_dim)
    return {"k": (kv, dt), "v": (kv, dt),
            "conv": ((arch.n_conv, batch_size, arch.hidden_size, arch.conv_kernel), dt)}


def __getattr__(name):
    # APPLICATION_CLS, lazily: application.py imports this module
    if name in ("APPLICATION_CLS", "Lfm2ForCausalLM"):
        from nxdi_tpu_torch.models.lfm2.application import Lfm2ForCausalLM

        return Lfm2ForCausalLM
    raise AttributeError(name)
