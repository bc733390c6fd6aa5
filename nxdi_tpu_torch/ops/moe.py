"""Mixture-of-experts feed-forward — the port of ``nxdi_tpu/ops/moe.py`` at
one device.

The structure and names are the JAX package's:

- **Router**: one product in float32 -> scoring (softmax, sigmoid, the
  grouped top-k of DeepSeek V2/V3, phimoe's sparsemixer) -> top-k ->
  (optional) renormalisation, :func:`route_topk`. Top-k keeps
  ``jax.lax.top_k``'s order (value descending, equal values by ascending
  index: ``ops/sampling.top_k_lower_index_first``), so the same experts are
  chosen.
- **Sparse dispatch** (``moe_dispatch="sparse"``, the default): the T * K
  (token, expert) pairs are sorted by expert (a stable sort), counted per
  expert by a scatter-add into a fixed (E,) tensor, run through a grouped
  product, weighted, put back in (token, k) order and summed over k. Every
  shape is fixed and nothing is read back to the host, so the path runs
  inside a CUDA graph. The grouped product is the counterpart of XLA's
  ``ragged_dot``; :func:`grouped_product` chooses it from the operands'
  device, dtype and widths alone: ``torch._grouped_mm`` with device-side
  int32 offsets for bfloat16 on the card at widths that are multiples of 8,
  else a product of every sorted row with each expert's weight, kept where
  the row's expert is that expert (fixed shapes, E times the FLOPs).
- **Dense dispatch** (``moe_dispatch="dense"``): every expert on every
  token, the combine weight zero for the experts a token did not choose.

The expert products are plain PyTorch products, as the JAX package leaves
them to XLA (``ragged_dot``, ``einsum``): no Pallas kernel is on this path.
Quantized experts are dequantized by ``materialize_weight`` as the JAX
package's ``mat_w`` does. Expert and tensor parallelism (the JAX package's
``expert_parallel_specs``, ``_sparse_moe``'s ``shard_map``,
``duplicate_per_phase_experts``, ``moe_shape_struct``) are not ported: the
port runs on one device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from nxdi_tpu_torch.ops.quantization import materialize_weight as mat_w
from nxdi_tpu_torch.ops.sampling import top_k_lower_index_first

# the JAX package's activations (its "gelu" is jax.nn.gelu, the tanh form)
ACT_FNS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "gelu_pytorch_tanh": lambda x: F.gelu(x, approximate="tanh"),
    "gelu_new": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
    "relu2": lambda x: torch.square(F.relu(x)),
}


@dataclass(frozen=True)
class MoEArch:
    """Static MoE architecture description (hashable; part of DecoderArch).
    The JAX package's fields but its expert-parallel ones (``ep``,
    ``hybrid_ep``, ``per_phase_hybrid``, ``phase``), which come with expert
    parallelism: the port runs on one device."""

    num_experts: int
    top_k: int
    intermediate_size: int  # per-expert intermediate
    hidden_act: str = "silu"
    norm_topk_prob: bool = True  # renormalize the top-k weights (mixtral: always)
    # "sparse" (sort + grouped product) or "dense" (all experts, all tokens)
    dispatch: str = "sparse"
    # shared (always-on) experts, qwen2-moe / llama4 style
    shared_expert_intermediate_size: Optional[int] = None
    shared_expert_gated: bool = False  # sigmoid(gate(x)) scaling of the shared output
    # gpt-oss: top-k of the logits, then a softmax over the selected values;
    # experts with biases and the clamped GLU (up + 1) * gate * sigmoid(alpha * gate)
    topk_softmax: bool = False
    # llama4: top-k logits -> sigmoid scores that scale the expert INPUT
    llama4_router: bool = False
    router_bias: bool = False
    expert_bias: bool = False
    gptoss_glu: bool = False
    glu_limit: Optional[float] = None
    glu_alpha: float = 1.702
    # deepseek V3: sigmoid scores (+ an optional correction bias used only for
    # the selection), grouped top-k over n_group groups keeping topk_group,
    # weights from the uncorrected scores, scaled by routed_scaling
    sigmoid_routing: bool = False
    # phimoe (Phi-3.5-MoE) sparsemixer, the inference path (top-2)
    sparsemixer: bool = False
    router_jitter: float = 0.01
    n_group: Optional[int] = None
    topk_group: Optional[int] = None
    routed_scaling: float = 1.0
    correction_bias: bool = False


def convert_hf_experts(get, cast, num_experts: int, router_key: str, expert_fmt) -> Dict[str, Any]:
    """Stack per-expert HF weights into the (E, in, out) layout this module
    reads. ``expert_fmt(j, proj)`` gives the HF key of expert j's gate / up /
    down projection; ``get`` returns torch tensors (HF layout (out, in))."""

    def stack(proj):
        return torch.stack([get(expert_fmt(j, proj)).t() for j in range(num_experts)])

    return {
        "router": {"w": cast(get(router_key).t())},
        "experts": {
            "gate_proj": {"w": cast(stack("gate"))},
            "up_proj": {"w": cast(stack("up"))},
            "down_proj": {"w": cast(stack("down"))},
        },
    }


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softmax's arithmetic: exp(x - max) over its sum."""
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def route_topk(
    router_logits: torch.Tensor, moe: MoEArch, p_router: Optional[Dict[str, Any]] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Router logits (T, E) -> (weights (T, K) float32, expert ids (T, K)
    int64): full-softmax top-k (mixtral, qwen3-moe), top-k-then-softmax
    (gpt-oss), sigmoid top-k on the input scale (llama4), DeepSeek V2/V3's
    grouped top-k, phimoe's sparsemixer — the JAX package's arithmetic."""
    logits = router_logits.float()
    if moe.sparsemixer:
        if moe.top_k != 2:
            raise ValueError("sparsemixer routing is top-2")

        def pick(scores):
            mx = scores.amax(dim=-1, keepdim=True)
            idx = scores.argmax(dim=-1, keepdim=True)
            factor = torch.maximum(scores.abs(), mx)
            drop = (mx - scores) / factor > 2.0 * moe.router_jitter
            gates = _softmax(scores.masked_fill(drop, float("-inf")))
            return torch.gather(gates, 1, idx), idx

        w1, i1 = pick(logits)
        masked = logits.scatter(1, i1, float("-inf"))
        # the second threshold mask uses the ORIGINAL |scores| clamp floor
        mx2 = masked.amax(dim=-1, keepdim=True)
        i2 = masked.argmax(dim=-1, keepdim=True)
        factor2 = torch.maximum(logits.abs(), mx2)
        drop2 = (mx2 - logits) / factor2 > 2.0 * moe.router_jitter
        gates2 = _softmax(masked.masked_fill(drop2, float("-inf")))
        w2 = torch.gather(gates2, 1, i2)
        return torch.cat([w1, w2], dim=-1), torch.cat([i1, i2], dim=-1)
    if moe.sigmoid_routing or moe.routed_scaling != 1.0 or (moe.n_group or 0) > 1:
        # the deepseek lineage. V3 (sigmoid_routing): sigmoid scores, the
        # selection over bias-corrected scores, a group's metric the sum of
        # its top-2 members. V2 (softmax scores): no correction bias, a
        # group's metric its largest member. Both: weights from the raw
        # scores, optional renorm, times routed_scaling
        scores = torch.sigmoid(logits) if moe.sigmoid_routing else _softmax(logits)
        select = scores
        if moe.correction_bias:
            select = scores + p_router["e_bias"].float()
        if moe.n_group and moe.n_group > 1:
            T = logits.shape[0]
            E, G = moe.num_experts, moe.n_group
            grouped = select.reshape(T, G, E // G)
            if moe.sigmoid_routing:
                group_scores = grouped.topk(min(2, E // G), dim=-1).values.sum(dim=-1)
            else:
                group_scores = grouped.amax(dim=-1)
            _, group_idx = top_k_lower_index_first(group_scores, moe.topk_group)
            group_mask = torch.zeros_like(group_scores).scatter_(1, group_idx, 1.0)  # (T, G)
            member_mask = group_mask[:, :, None].expand(T, G, E // G).reshape(T, E)
            select = select.masked_fill(member_mask == 0, float("-inf"))
        _, top_idx = top_k_lower_index_first(select, moe.top_k)
        # weights from the UNCORRECTED scores
        top_vals = torch.gather(scores, 1, top_idx)
        if moe.norm_topk_prob:
            top_vals = top_vals / (top_vals.sum(dim=-1, keepdim=True) + 1e-20)
        return top_vals * moe.routed_scaling, top_idx
    if moe.llama4_router:
        top_vals, top_idx = top_k_lower_index_first(logits, moe.top_k)
        return torch.sigmoid(top_vals), top_idx
    if moe.topk_softmax:
        # gpt-oss: top-k of the raw logits, softmax over the k selected values
        top_vals, top_idx = top_k_lower_index_first(logits, moe.top_k)
        return _softmax(top_vals), top_idx
    top_vals, top_idx = top_k_lower_index_first(_softmax(logits), moe.top_k)
    if moe.norm_topk_prob:
        top_vals = top_vals / top_vals.sum(dim=-1, keepdim=True)
    return top_vals, top_idx


def route(router_logits: torch.Tensor, moe: MoEArch, p_router=None) -> torch.Tensor:
    """Router logits (T, E) -> dense combine weights (T, E), zero for the
    experts a token did not choose (the dense dispatch's)."""
    top_vals, top_idx = route_topk(router_logits, moe, p_router)
    return torch.zeros_like(router_logits, dtype=top_vals.dtype).scatter_(1, top_idx, top_vals)


# ---------------------------------------------------------------------------
# Expert compute: sparse (sort + grouped product) and dense dispatch
# ---------------------------------------------------------------------------


def _expert_act(moe: MoEArch, gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    if moe.gptoss_glu:
        if moe.glu_limit is not None:
            gate = torch.clamp(gate, max=moe.glu_limit)
            up = torch.clamp(up, -moe.glu_limit, moe.glu_limit)
        return (up + 1.0) * (gate * torch.sigmoid(gate * moe.glu_alpha))
    return ACT_FNS[moe.hidden_act](gate) * up


#: the grouped products of the sparse dispatch (:func:`grouped_product`)
GROUPED_MM = "grouped_mm"
PER_EXPERT = "per_expert"


def grouped_product(x: torch.Tensor, hidden: int, inter: int) -> str:
    """The sparse dispatch's grouped product for rows ``x`` by the experts'
    (E, hidden, inter) and (E, inter, hidden) weights, chosen from the
    device, dtype and widths alone: ``torch._grouped_mm`` (a grouped GEMM
    reading the group offsets on the device) for bfloat16 on the card when
    both widths are multiples of 8 (its 16-byte row alignment), else the
    per-expert product. (The card's torch 2.11 runs ``_grouped_mm`` in
    float32 too, but copies from the host there, so it cannot be captured.)"""
    if x.is_cuda and x.dtype == torch.bfloat16 and hidden % 8 == 0 and inter % 8 == 0:
        return GROUPED_MM
    return PER_EXPERT


def moe_strategy(moe: MoEArch, x: torch.Tensor) -> str:
    """The name a forward records for this block (models/base.py's strategy
    trace): ``moe_dense``, or ``moe_sparse_`` + its grouped product."""
    if moe.dispatch != "sparse":
        return "moe_dense"
    return "moe_sparse_" + grouped_product(x, x.shape[-1], moe.intermediate_size)


def _grouped(x: torch.Tensor, w: torch.Tensor, offs: torch.Tensor, se: torch.Tensor) -> torch.Tensor:
    """Rows ``x`` (N, in), sorted by expert (``se`` (N,), group end offsets
    ``offs`` (E,) int32), times their expert's (in, out) slice of ``w``."""
    if grouped_product(x, w.shape[-2], w.shape[-1]) == GROUPED_MM:
        return torch._grouped_mm(x.contiguous(), w, offs=offs)
    out = x.new_zeros((x.shape[0], w.shape[-1]))
    for e in range(w.shape[0]):
        out = torch.where((se == e)[:, None], x @ w[e], out)
    return out


def _sparse_expert_ffn(
    moe: MoEArch,
    ew: Dict[str, Any],
    xt: torch.Tensor,  # (T, H)
    weights: torch.Tensor,  # (T, K) float32 combine weights
    idx: torch.Tensor,  # (T, K) expert ids
) -> torch.Tensor:
    """The grouped expert FFN of every routed (token, expert) pair, at one
    device (the JAX package's ``_sparse_expert_ffn`` with every expert
    local): (T, H)."""
    T, H = xt.shape
    K, E = moe.top_k, moe.num_experts
    N = T * K
    dev = xt.device

    flat_e = idx.reshape(N)
    flat_t = torch.arange(T, device=dev)[:, None].expand(T, K).reshape(N)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]  # sorted expert ids
    st = flat_t[order]  # token row per sorted slot
    comb = weights.reshape(N)[order]  # float32

    xs = xt[st]  # (N, H)
    if moe.llama4_router:
        # llama4 scales the expert INPUT by the sigmoid score; combine weight 1
        xs = xs * comb[:, None].to(xs.dtype)
        comb = torch.where(comb > 0, 1.0, 0.0)
    # rows per expert into a fixed (E,) tensor (bincount's length would depend
    # on the data), then the group end offsets
    counts = torch.zeros((E,), dtype=torch.int32, device=dev).scatter_add_(
        0, se, torch.ones_like(se, dtype=torch.int32))
    offs = torch.cumsum(counts, 0, dtype=torch.int32)

    gate = _grouped(xs, ew["gate_proj"]["w"], offs, se)
    up = _grouped(xs, ew["up_proj"]["w"], offs, se)
    if moe.expert_bias:
        gate = gate + ew["gate_proj"]["b"][se]
        up = up + ew["up_proj"]["b"][se]
    inner = _expert_act(moe, gate, up)
    rows = _grouped(inner, ew["down_proj"]["w"], offs, se)
    if moe.expert_bias:
        rows = rows + ew["down_proj"]["b"][se].to(rows.dtype)

    rows = rows * comb[:, None].to(rows.dtype)
    # back to (T, K) slots, then the sum over K: a deterministic combine
    unsorted = torch.zeros_like(rows).index_copy_(0, order, rows)
    return unsorted.reshape(T, K, H).sum(dim=1)


def moe_block(arch, moe: MoEArch, p: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """MoE feed-forward: (B, S, H) -> (B, S, H).

    Param leaves: router.w (H, E); experts.{gate,up}_proj.w (E, H, I),
    experts.down_proj.w (E, I, H); optional router.b, router.e_bias, expert
    biases and the shared expert's MLP (+ its gate)."""
    B, S, H = x.shape
    xt = x.reshape(B * S, H)

    router_logits = xt.float() @ p["router"]["w"].float()
    if moe.router_bias:
        router_logits = router_logits + p["router"]["b"].float()

    p_experts = p["experts"]

    if moe.dispatch == "sparse":
        top_vals, top_idx = route_topk(router_logits, moe, p["router"])
        experts = {k: {"w": mat_w(p_experts[k], x.dtype)}
                   for k in ("gate_proj", "up_proj", "down_proj")}
        if moe.expert_bias:
            for k in experts:
                experts[k]["b"] = p_experts[k]["b"]
        out = _sparse_expert_ffn(moe, experts, xt, top_vals, top_idx)
    else:
        weights = route(router_logits, moe, p["router"]).to(x.dtype)  # (T, E)
        # every expert on every token, the combine contracted over E
        gate = torch.matmul(xt, mat_w(p_experts["gate_proj"], x.dtype))  # (E, T, I)
        up = torch.matmul(xt, mat_w(p_experts["up_proj"], x.dtype))
        if moe.llama4_router:
            # llama4 scales the expert INPUT by the sigmoid score; gate/up are
            # linear and bias-free here, so scaling their outputs is the same
            se = weights.t()[:, :, None].to(gate.dtype)  # (E, T, 1)
            gate = gate * se
            up = up * se
        if moe.expert_bias:
            gate = gate + p_experts["gate_proj"]["b"][:, None, :]
            up = up + p_experts["up_proj"]["b"][:, None, :]
        inner = _expert_act(moe, gate, up)  # (E, T, I)
        expert_out = torch.matmul(inner, mat_w(p_experts["down_proj"], x.dtype))  # (E, T, H)
        if moe.expert_bias:
            expert_out = expert_out + p_experts["down_proj"]["b"][:, None, :]
        if moe.llama4_router:
            out = expert_out.sum(dim=0)  # the input already carries the score
        else:
            out = torch.einsum("te,eth->th", weights, expert_out)

    if moe.shared_expert_intermediate_size:
        act = ACT_FNS[moe.hidden_act]
        sp = p["shared_expert"]
        shared = (act(xt @ mat_w(sp["gate_proj"], x.dtype))
                  * (xt @ mat_w(sp["up_proj"], x.dtype))) @ mat_w(sp["down_proj"], x.dtype)
        if moe.shared_expert_gated:
            shared = torch.sigmoid(
                xt.float() @ p["shared_expert_gate"]["w"].float()
            ).to(shared.dtype) * shared
        out = out + shared

    return out.reshape(B, S, H)
