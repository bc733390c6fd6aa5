"""The dense decoder forward — the Llama-lineage subset of
``nxdi_tpu/models/base.py``.

One forward of a submodel: embed -> [decoder layers: rmsnorm -> attention
(+KV write) -> residual -> rmsnorm -> gated MLP -> residual] -> final
rmsnorm -> last-token gather -> lm_head -> padded-vocab mask -> greedy token.
The dense families' switches of ``DecoderArch`` (q/k norms, the sliding
window, Gemma's norms and embedding scale, post-block norms, the scalings,
the non-gated MLP, the adjacent-pair rope) and the MoE families' (LayerNorm,
the qkv clamp, partial rotary, attention sinks, the attention output gate,
sandwich norms, LongRoPE), the Gemma 2/3 lineage's (the attention and
final-logit softcaps; the local / global rope pair) and Llama 4's and the
global-NoPE hybrids' (chunked attention on the rope layers, the L2 q / k
norm, the NoPE layers' query temperature, the parallel block) and the last
dense families' (learned position tables with no rope, Phi's biased head,
Apertus's xIELU, the exact GELU of HF's ``"gelu"``) and MiMo-V2's value
width apart from q / k's (``v_head_dim``, which no attention kernel takes)
change these steps as the JAX package's do; per-layer ``use_rope`` /
``use_sliding_window`` / ``use_local_rope`` flags ride the layer stack's
params (:class:`LayerFlags`).

Under ``window_sized_kv`` the sliding-window layers keep a W-slot ring
(``kvcache/kv_cache.py::WindowKVLayout``): the whole cache when every layer
slides, else a ``k_win`` / ``v_win`` stack beside the full layers' cache
(:func:`run_decoder_layers`). The decode kernels read a ring through their
``ring`` operand.

Where the JAX package scans one traced layer body over layer-stacked
params, PyTorch runs eagerly: a Python loop over the layers, each reading
its slice of the stacked params and cache. The KV cache is updated in place.

Decode on the contiguous cache uses the deferred write the JAX package
designed its kernels around: each layer attends the OLD cache with the fresh
row folded in and returns only the fresh K/V row; one commit kernel lands
every layer's rows after the layer loop. On the paged pool (the serving
engine's layout) every layer scatters its fresh rows through the slot
mapping first and then attends the pool through the block tables.

Attention strategies (recorded per forward through :func:`_record_strategy`;
the names are the JAX package's):

- ``cte_flash_kernel`` / ``cte_xla`` — prefill through the CUDA flash kernel
  (or its plain version on the CPU), or the plain grouped attention;
- ``tkg_fused_kernel_stacked`` — contiguous decode through the fused-decode
  kernel on the stacked cache; ``tkg_fused_kernel`` — the same kernel per
  layer over the gathered, dequantized window (a quantized cache on the
  card); ``tkg_two_part_xla`` — their plain path;
- ``cte_paged_kernel`` — a prefill chunk that continues a cached prefix,
  attending the pool through the block table;
- ``tkg_paged_kernel`` — paged decode through the block table
  (``attn_block_tkg_kernel_enabled``);
- ``tkg_kernel`` / ``tkg_xla`` — paged decode (or a continuing chunk with
  the attention kernels off) over the gathered window, through the
  window-decode kernel or plain attention;
- ``mixed_ragged_kernel`` / ``mixed_ragged_xla`` — the serving engine's
  packed mixed step (prefill chunks and decode rows in one token stream,
  tagged by ``mixed_row_ids``) through the ragged paged-attention kernel, or
  plain attention over the combined gathered window;
- ``qkv_fused_kernel`` / ``qkv_fused_matmul`` — the fused QKV projection
  through the QKV GEMM kernel or a plain product; ``mlp_fused_kernel`` — the
  gated MLP through the fused MLP kernel;
- ``attn_mask_override_xla`` — a token-tree verify under its explicit
  ``attn_mask`` (the tree's nodes share rope positions by depth and write
  distinct slots, ``write_positions``). A multi-token verify on the
  contiguous cache is the deferred ``tkg_two_part_xla`` (the decode kernels
  take one query token);
- ``moe_dense`` / ``moe_sparse_grouped_mm`` / ``moe_sparse_per_expert`` —
  a mixture-of-experts layer (``arch.moe`` and ``"moe"`` in the layer's
  params, ``ops/moe.py``) by its dispatch and grouped product;
- ``mla_xla`` — a Multi-head Latent Attention layer (``arch.mla``,
  ``ops/mla.py``): plain attention over the latent cache, whose fresh row
  every layer writes first (through the commit kernel on the contiguous
  cache); an MLA model never defers its cache writes.

Heterogeneous stacks (DeepSeek-V3's ``first_k_dense_replace`` dense layers
before its MoE layers) arrive as a LIST of layer-stacked segments in
``params["layers"]``; each walks its own slice of the stacked cache at its
global layer offset, and its stacked MLP weights take the segment-local
layer index (the JAX package's segmented layer scan).

Multi-adapter LoRA (``lora/serving.py``): a projection whose params carry
the slot-stacked ``lora_A`` / ``lora_B`` / ``lora_scale`` buffers adds, per
batch row, the low-rank delta of the adapter slot ``adapter_ids`` names
(slot 0 is all zeros: the base model). The fused QKV and MLP kernels take no
adapter; the config refuses them with LoRA.

On the CPU the kernel choice follows the JAX package's eligibility exactly,
so both packages take the same branches. On a CUDA tensor an enabled kernel
flag whose eligibility fails raises, naming the failed condition, instead of
silently dropping to the plain path. One condition of the JAX rule does not
hold the card back: under continuous batching (cache lines routed by
``seq_ids``) and in the K-step and loop bodies (``write_positions``) the JAX
package leaves the stacked fused decode for the per-layer one over gathered
lines, or for plain attention; the port's kernel takes each row's line
(``lines``) and runs there.

Quantization (the JAX package's): a linear's params may be a quantized dict
(``qw``/``scale``, ``qw4`` MXFP4 blocks, an ``input_scale`` for static int8
activations) that :func:`_linear` serves through ``ops/quantization.py``;
the QKV and MLP kernels take unquantized weights only. A quantized KV store
(one byte per element) is written and read by the layouts with their
scales; the deferred decode attends each fresh row through its scale
(divided and multiplied, as the JAX package does), and the stacked fused
decode kernel, which reads the cache in q's dtype, leaves such a cache (the
JAX rule) to the same kernel launched per layer over the dequantized window;
the paged, ragged and commit kernels take the one-byte store.

The device-resident decode family (the JAX package's): on-device sampling
with a per-step key (``rng``, chained by ``next_step_rng``),
:func:`multi_step_token_gen` (K steps in one forward) and
:func:`device_loop_token_gen` (steps until every row is done), whose rows
freeze after EOS or their budget: position pinned, cache writes dropped.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from nxdi_tpu_torch.config import to_torch_dtype
from nxdi_tpu_torch.kvcache.kv_cache import (
    DEFAULT_KV_LAYOUT,
    BlockKVCacheSpec,
    BlockKVLayout,
    ContiguousKVLayout,
    KVCacheSpec,
    WindowKVLayout,
)
from nxdi_tpu_torch.ops import attention as attn_ops
from nxdi_tpu_torch.ops import mla as mla_ops
from nxdi_tpu_torch.ops import moe as moe_ops
from nxdi_tpu_torch.ops import quantization as quant_ops
from nxdi_tpu_torch.ops import sampling as sampling_ops
from nxdi_tpu_torch.ops.kernels import flash_attention as fa
from nxdi_tpu_torch.ops.kernels import fused_proj as fp
from nxdi_tpu_torch.ops.kernels import ragged_paged_attention as rpa
from nxdi_tpu_torch.ops.norms import flat_rms_norm, layer_norm, rms_norm
from nxdi_tpu_torch.ops.rope import (
    apply_rotary_pos_emb,
    apply_rotary_pos_emb_interleaved,
    l2_norm,
    rope_cos_sin,
    rope_cos_sin_pair,
)

# The MLP activations of the JAX package's ``ACT_FNS``, with its meanings:
# "gelu" is jax.nn.gelu's default, the tanh approximation (the JAX fused MLP
# kernel's "gelu" is the exact one, and so is the port's kernel:
# ops/kernels/fused_proj.py)
ACT_FNS = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    # the exact (erf) GELU: HF ACT2FN["gelu"], which Falcon, GPT-NeoX, BioGPT
    # and XGLM run where their configs say "gelu" (the JAX package gives
    # them its tanh "gelu", ROADMAP Queue 3); their families map it here
    "gelu_exact": F.gelu,
    "gelu_pytorch_tanh": lambda x: F.gelu(x, approximate="tanh"),
    "gelu_new": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
    # squared ReLU (Arcee / AFM, HF ACT2FN["relu2"])
    "relu2": lambda x: torch.square(F.relu(x)),
}

# Apertus's activation (hidden_act "xielu"), which mlp_block applies with the
# layer's "xielu" params. HF's XIELUActivation keeps eps as a bf16 buffer:
# -1e-6 rounded to bf16
XIELU_EPS = float(torch.tensor(-1e-6, dtype=torch.bfloat16))


def xielu(x: torch.Tensor, alpha_p: torch.Tensor, alpha_n: torch.Tensor) -> torch.Tensor:
    """The xIELU activation (Apertus) in float32, the JAX package's
    ``xielu``: ``alpha_p`` / ``alpha_n`` are the per-layer scalars after
    softplus (and + beta for alpha_n), rounded as HF's bf16 parameters are
    (the converter bakes them)."""
    xf = x.float()
    pos = alpha_p * xf * xf + 0.5 * xf
    neg = (torch.expm1(torch.clamp(xf, max=XIELU_EPS)) - xf) * alpha_n + 0.5 * xf
    return torch.where(xf > 0, pos, neg).to(x.dtype)

# Attention-strategy trace: attention_block appends the strategy each layer
# actually ran; ModelWrapper snapshots it per (submodel, bucket).
_STRATEGY_TRACE: list = []


def _record_strategy(name: str) -> None:
    _STRATEGY_TRACE.append(name)


@dataclass(frozen=True)
class DecoderArch:
    """Static architecture description (the fields the Llama-lineage paths
    read, with the JAX package's meanings). Head and vocab counts are the padded values after GQA planning and vocab
    padding; ``vocab_pad`` rows are masked out of the logits."""

    num_layers: int
    hidden_size: int
    num_attention_heads: int
    num_kv_heads: int
    head_dim: int
    intermediate_size: int
    vocab_size: int  # padded
    vocab_pad: int
    rms_norm_eps: float = 1e-5
    hidden_act: str = "silu"
    attention_bias: bool = False
    mlp_bias: bool = False
    tie_word_embeddings: bool = False
    dtype: str = "bfloat16"
    attn_kernel_enabled: bool = False
    attn_tkg_kernel_enabled: bool = False
    attn_block_tkg_kernel_enabled: bool = False
    fused_qkv: bool = False
    qkv_kernel_enabled: bool = False
    mlp_kernel_enabled: bool = False
    # int8 activation quantization of the quantized linears ("dynamic" |
    # "static"); the weights themselves are quantized in the params
    act_quant: Optional[str] = None
    act_clamp: Optional[float] = None
    # the one-byte KV store of a quantized cache (None: the compute dtype)
    kv_quant_dtype: Optional[str] = None
    # the MoE feed-forward that replaces the dense MLP when set (ops/moe.py)
    moe: Optional[moe_ops.MoEArch] = None
    # YaRN attention factor multiplying cos/sin (DeepSeek)
    rope_mscale: float = 1.0
    # Multi-head Latent Attention replaces the GQA attention when set
    # (ops/mla.py; the DeepSeek lineage)
    mla: Optional[mla_ops.MLAArch] = None
    # --- the dense Llama-lineage families' switches (the JAX package's) ---
    # per-head q/k RMSNorm before rope (Qwen3, HunYuan; params attn.q_norm /
    # attn.k_norm (L, D))
    qk_norm: bool = False
    # sliding-window attention (Mistral, Ministral, Mixtral): key positions
    # in (q - window, q]
    sliding_window: Optional[int] = None
    # the softmax scale (None: head_dim ** -0.5; Granite's attention_multiplier)
    attention_scale: Optional[float] = None
    # the Gemma lineage: (1 + w) norms in float32, embeddings times
    # embed_scale after the cast to the compute dtype (Granite and MiniCPM
    # set embed_scale alone)
    gemma_norm: bool = False
    embed_scale: Optional[float] = None
    # a plain up -> act -> down MLP (Arcee) where False
    gated_mlp: bool = True
    # o_proj bias (Ernie 4.5, Seed-OSS, InternLM3)
    attention_o_bias: bool = False
    # adjacent-pair (GPT-J) rope (Helium, Ernie 4.5)
    rope_interleaved: bool = False
    # OLMo-2: RMSNorm over the flat q/k projections before the head reshape;
    # q's mean square divides by the true (unpadded) width qk_norm_flat_qdim
    qk_norm_flat: bool = False
    qk_norm_flat_qdim: int = 0
    # OLMo-2: no input norms; the attention and MLP outputs are normed before
    # the residual add ("input_layernorm" holds the post-attention norm,
    # "post_attention_layernorm" the post-feed-forward one)
    post_block_norm: bool = False
    # Granite / MiniCPM: block outputs times residual_multiplier before the
    # residual add; logits divided by logits_scaling
    residual_multiplier: float = 1.0
    logits_scaling: float = 1.0
    # per layer, whether it is a sliding-window layer (Ministral's
    # layer_types). The layers' "use_sliding_window" param flags carry the
    # same pattern on the device; this host copy gives a kernel launched on
    # the card its layer's window
    kv_window_pattern: Optional[Tuple[bool, ...]] = None
    # --- the MoE families' switches (the JAX package's) ---
    # weight-only LayerNorm instead of RMSNorm (DBRX); a norm param that is a
    # dict {"w", "b"} is a biased LayerNorm whatever this says (Phi-3.5-MoE)
    layernorm: bool = False
    # DBRX: q, k and v clamped to [-clip_qkv, clip_qkv] after the projections
    clip_qkv: Optional[float] = None
    # partial rotary (MiniMax-M2): only the first rotary_dim channels rotate,
    # from a rotary_dim-wide frequency table
    rotary_dim: Optional[int] = None
    # gpt-oss: a learned per-head logit (attn["sink"] (L, H)) joins every
    # softmax and its mass is dropped; no attention kernel takes it
    attention_sink: bool = False
    # AFMoE: the context times sigmoid(attention input @ attn["gate_proj"])
    # before o_proj
    attn_out_gate: bool = False
    # AFMoE (the Gemma-3 layout with plain norms): post_attention_layernorm
    # norms the attention output before its residual add, and the
    # feed-forward sits between pre_ / post_feedforward_layernorm
    sandwich_norm: bool = False
    # LongRoPE (Phi-3 128k, Phi-3.5-MoE): the frequency table arrives stacked
    # (2, D/2) [short, long]; a forward whose true last position + 1 exceeds
    # this takes the long set (a device-side select a graph holds)
    longrope_original_max: Optional[int] = None
    # --- the Gemma 2/3 lineage's switches (the JAX package's) ---
    # cap * tanh(s / cap) on the scaled attention scores, before the mask and
    # the sink; no attention kernel takes it (Gemma 2, VaultGemma)
    attn_logit_softcap: Optional[float] = None
    # cap * tanh(l / cap) on the logits, after logits_scaling (Gemma 2)
    final_logit_softcap: Optional[float] = None
    # --- Llama 4's and the global-NoPE hybrids' switches (the JAX package's) ---
    # chunked attention (Llama 4's attention_chunk_size): a query at p sees
    # the keys in [p // c * c, p]; where the stack carries "use_rope" flags,
    # on the rope layers only (:meth:`layer_chunk`)
    chunk_size: Optional[int] = None
    # the unweighted L2 norm of q and k after rope, on the rope layers
    qk_l2norm: bool = False
    # the NoPE layers' query times log1p(floor((p + 1) / floor_scale)) *
    # attn_scale + 1 (Llama 4's attn_temperature_tuning)
    attn_temperature_tuning: bool = False
    floor_scale: float = 8192.0
    attn_scale: float = 0.1
    # Cohere 2: attention and the feed-forward both read the layer input
    # through their norms, x + attn(n1(x)) + mlp(n2(x)), one residual add
    parallel_block: bool = False
    # per layer, whether it applies rope: the host copy of the layers'
    # "use_rope" param flags, which gives a kernel launched on the card its
    # layer's chunk (as kv_window_pattern gives its window)
    rope_pattern: Optional[Tuple[bool, ...]] = None
    # --- the learned-position lineage's switches (the JAX package's) ---
    # GPT-2, BigCode and the fairseq decoders: params["position_embeddings"]
    # (P, H) looked up at position_ids and added after the embedding (and its
    # scale); no rope anywhere
    learned_pos_embeds: bool = False
    no_rope: bool = False
    # Phi: the params carry "lm_head_bias" (V,) float32, added to the logits
    # (the forward adds it wherever the params carry it, as the JAX package
    # does; this field names the switch for the paths that refuse it)
    lm_head_bias: bool = False
    # MiMo-V2: the value width apart from q/k's head_dim (None: the same);
    # the V projection, the context, o_proj and the cache's V stack take it.
    # No attention kernel takes it (the JAX rule); the commit kernel does
    v_head_dim: Optional[int] = None

    def __post_init__(self):
        if self.hidden_act not in ACT_FNS and self.hidden_act != "xielu":
            raise NotImplementedError(f"hidden_act {self.hidden_act!r} is not ported yet")

    def layer_window(self, i: int) -> Optional[int]:
        """The sliding window of layer ``i`` (None: full attention)."""
        if self.sliding_window is None:
            return None
        pat = self.kv_window_pattern
        return self.sliding_window if pat is None or pat[i] else None

    def layer_chunk(self, i: int) -> Optional[int]:
        """The attention chunk of layer ``i`` (None: none): the chunk on a
        rope layer, none on a NoPE layer, the chunk on every layer when the
        stack has no rope pattern. A sliding window wins over the chunk (the
        JAX package's mask rule)."""
        if self.chunk_size is None or self.sliding_window is not None:
            return None
        pat = self.rope_pattern
        return self.chunk_size if pat is None or pat[i] else None

    def interleaved_split(self) -> Optional[Tuple[int, int]]:
        """(full layers, window layers) of an interleaved window pattern (both
        kinds present), else None: the cache split of ``window_sized_kv``."""
        pat = self.kv_window_pattern
        if self.sliding_window is None or not pat or all(pat) or not any(pat):
            return None
        return sum(not w for w in pat), sum(bool(w) for w in pat)

    def kv_cache_spec(self, batch_size: int, max_len: int) -> KVCacheSpec:
        if self.mla is not None:
            # the latent cache: k holds the shared rotated rope key, v the
            # normed compressed kv latent (ops/mla.py)
            return KVCacheSpec(
                num_layers=self.num_layers,
                batch_size=batch_size,
                num_kv_heads=1,
                max_len=max_len,
                head_dim=self.mla.qk_rope_head_dim,
                v_head_dim=self.mla.kv_lora_rank,
                dtype=self.dtype,
                quant_dtype=self.kv_quant_dtype,
            )
        return KVCacheSpec(
            num_layers=self.num_layers,
            batch_size=batch_size,
            num_kv_heads=self.num_kv_heads,
            max_len=max_len,
            head_dim=self.head_dim,
            v_head_dim=self.v_head_dim,
            dtype=self.dtype,
            quant_dtype=self.kv_quant_dtype,
        )


def _norm(arch: DecoderArch, x: torch.Tensor, w) -> torch.Tensor:
    """The arch's norm: a biased LayerNorm for a dict param ``{"w", "b"}``,
    a weight-only LayerNorm under ``layernorm``, else RMSNorm (the JAX
    package's rule)."""
    if isinstance(w, dict):
        return layer_norm(x, w["w"], w.get("b"), eps=arch.rms_norm_eps)
    if arch.layernorm:
        return layer_norm(x, w, eps=arch.rms_norm_eps)
    return rms_norm(x, w, arch.rms_norm_eps, gemma_style=arch.gemma_norm)


def _linear(x: torch.Tensor, p: Dict[str, torch.Tensor], act_quant=None,
            clamp=None, adapter_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x @ w (+ b) over a full-precision param dict ``{"w"[, "b"]}`` or a
    quantized one (``ops/quantization.quantized_linear``); weights are
    stored (in, out) like the JAX package. When the dict carries the
    slot-stacked LoRA buffers and ``adapter_ids`` (B,) is given, batch row b
    adds ``((x @ A[id]) @ B[id]) * scale[id]`` with ``id = adapter_ids[b]``
    (the JAX package's per-row delta)."""
    if "qw" in p or "qw4" in p:
        y = quant_ops.quantized_linear(x, p, act_quant=act_quant, clamp_bound=clamp)
    else:
        y = x @ p["w"]
        if "b" in p:
            y = y + p["b"]
    if adapter_ids is not None and "lora_A" in p:
        ids = adapter_ids.long()
        A = p["lora_A"][ids].to(x.dtype)  # (B, in, r)
        Bw = p["lora_B"][ids].to(x.dtype)  # (B, r, out)
        s = p["lora_scale"][ids]  # (B,)
        B = x.shape[0]
        delta = torch.bmm(torch.bmm(x.reshape(B, -1, x.shape[-1]), A), Bw)
        y = y + (delta * s[:, None, None].to(delta.dtype)).reshape(y.shape)
    return y


def _kernel_gate(flag: str, enabled: bool, on_cuda: bool,
                 ref_failed: List[str], card_failed: List[str],
                 ref_only: Tuple[str, ...] = ()) -> bool:
    """Whether an attention kernel runs. ``ref_failed`` are the eligibility
    conditions the JAX package checks on the CPU (its interpret mode);
    ``card_failed`` the extra limits of the CUDA kernel; ``ref_only`` failed
    conditions of the JAX rule that the CUDA kernel handles. On the CPU the
    JAX rule decides; on the card a failed condition under an enabled flag
    raises."""
    if not enabled:
        return False
    if not on_cuda:
        return not ref_failed and not ref_only
    failed = ref_failed + card_failed
    if failed:
        raise NotImplementedError(
            f"{flag} is set but the kernel is not eligible: {'; '.join(failed)}"
        )
    return True


def _proj_gate(flag: str, on_cuda: bool, ref_failed: List[str], card_failed: List[str]) -> None:
    """The projection kernels' gate, beside :func:`_kernel_gate` with the
    same rule on the card. An enabled MLP or QKV flag never falls back: the
    JAX package raises when its kernel is not eligible, so here a failed
    condition raises on the CPU (the JAX rule) and on the card (the JAX rule
    and the CUDA kernel's limits), naming it."""
    failed = ref_failed + (card_failed if on_cuda else [])
    if failed:
        raise NotImplementedError(
            f"{flag} is set but the kernel is not eligible: {'; '.join(failed)}; "
            "disable the flag"
        )


def _card_limits(D: int, dtype: torch.dtype, store: Optional[torch.dtype] = None) -> List[str]:
    """The CUDA attention kernels' limits: head dim (a multiple of 8 up to
    256, every kernel), q's dtype, and the KV ``store`` the kernel reads
    (q's dtype, or, for the paged, ragged and commit kernels, a one-byte
    store at a head dim that is a multiple of 16, up to 256). Any number of
    query heads per kv head: the decode kernels take a group above 16 in
    head tiles."""
    bad = []
    if D % 8 or D > fa.MAX_HEAD_DIM:
        bad.append(f"head_dim {D} is not a multiple of 8 up to {fa.MAX_HEAD_DIM}")
    if dtype not in (torch.float32, torch.bfloat16):
        bad.append(f"dtype {dtype} is not float32 or bfloat16")
    if store is not None and store != dtype:
        if store not in fa.ONE_BYTE_STORES:
            bad.append(f"KV store {store} is neither {dtype} nor a one-byte store")
        elif D % 16:
            bad.append(f"a one-byte KV store needs head_dim a multiple of 16, got {D}")
    return bad


def _heads_ok(H: int, KV: int) -> List[str]:
    return [] if H % KV == 0 else [f"{H} heads not divisible by {KV} kv heads"]


class LayerFlags(NamedTuple):
    """A layer's per-layer switches: its ``use_sliding_window`` and
    ``use_rope`` param flags (0-d bool tensors, or None when the stack has
    none) and its window and chunk on the host
    (:meth:`DecoderArch.layer_window`, :meth:`DecoderArch.layer_chunk`),
    which the card's kernels take as per-call scalars."""

    window_enabled: Optional[torch.Tensor] = None
    use_rope: Optional[torch.Tensor] = None
    window: Optional[int] = None
    chunk: Optional[int] = None

    def ref_only(self) -> Tuple[str, ...]:
        """The JAX rule leaves every attention kernel for plain attention on
        a layer that carries a flag; the CUDA kernels serve such layers (rope
        runs before the kernel, the window is the layer's own scalar), so
        these are ``ref_only`` conditions of :func:`_kernel_gate`."""
        return tuple(cond for cond, flag in (
            ("per-layer sliding-window flags", self.window_enabled),
            ("per-layer rope flags", self.use_rope)) if flag is not None)


NO_FLAGS = LayerFlags()


def _sink_refused(arch: DecoderArch) -> List[str]:
    """The JAX rule for every attention kernel: none takes the sink column."""
    return ["attention sinks (no attention kernel takes the sink column)"] if (
        arch.attention_sink) else []


def _softcap_refused(arch: DecoderArch) -> List[str]:
    """The JAX rule for every attention kernel: none takes the logit softcap."""
    return ["attention logit softcap (no attention kernel takes it)"] if (
        arch.attn_logit_softcap is not None) else []


def _v_width_refused(arch: DecoderArch) -> List[str]:
    """The JAX rule for every attention kernel: none takes a value width
    apart from q/k's."""
    return [f"v_head_dim {arch.v_head_dim} apart from head_dim {arch.head_dim} (no attention "
            "kernel takes it)"] if arch.v_head_dim is not None else []


def _kernel_refusals(arch: DecoderArch) -> List[str]:
    """What keeps every attention kernel off by the JAX rule: the sink, the
    softcap and a value width apart from q/k's."""
    return _sink_refused(arch) + _softcap_refused(arch) + _v_width_refused(arch)


def _ring(layout) -> Optional[int]:
    """The ring's slot count of a window-sized layout (the decode kernels'
    ring operand), None for the contiguous cache."""
    return layout.window if isinstance(layout, WindowKVLayout) else None


def _window_refused(arch: DecoderArch) -> List[str]:
    """The JAX rule for the paged, ragged and paged-decode kernels: none
    takes a sliding window."""
    return [] if arch.sliding_window is None else [
        f"sliding_window {arch.sliding_window} (the paged and ragged kernels take none)"]


def _chunk_refused(arch: DecoderArch) -> List[str]:
    """The JAX rule for the paged, ragged and paged-decode kernels: none
    takes an attention chunk."""
    return [] if arch.chunk_size is None else [
        f"chunk_size {arch.chunk_size} (the paged and ragged kernels take no chunk)"]


def _attend_cache(arch, q, k_cache_l, v_cache_l, position_ids, ci, cache_spec, layout,
                  lf: LayerFlags = NO_FLAGS, sink=None):
    """Attention of a cache-attending forward whose fresh rows are already
    in the cache (the paged pool's path, a token-tree verify, and the
    window-sized ring's decode), in the JAX package's order: the block-table
    prefill kernel for a continuing chunk, the block-table decode kernel,
    else the gathered window under an explicit ``attn_mask``, through the
    window-decode kernel (in its ring mode over a ring) or plain attention.

    The JAX package hands its window-decode kernel a ring's wrapped
    positions as if they were affine (the kernel reads ``kv_pos[:, 0]``
    only), which drops the older part of the window once the ring has
    wrapped; the port's kernel takes the ring operand, so on the CPU too the
    port follows HF there (ROADMAP Queue 3)."""
    B, H, S, D = q.shape
    KV = arch.num_kv_heads
    if ci.get("mixed_row_ids") is not None and S > 1:
        return _attend_mixed(arch, q, k_cache_l, v_cache_l, position_ids, ci, cache_spec, layout,
                             lf, sink)
    paged = isinstance(layout, BlockKVLayout) and "block_table" in ci
    if paged:
        ref_failed = (_heads_ok(H, KV) + _window_refused(arch) + _chunk_refused(arch)
                      + _kernel_refusals(arch))
        if k_cache_l.shape[0] % layout.block_size:
            ref_failed.append(f"{k_cache_l.shape[0]} pool slots are not whole blocks")
        scales = dict(block_size=layout.block_size, k_scale=layout.k_scale,
                      v_scale=layout.v_scale, scale=arch.attention_scale)
        store = k_cache_l.dtype
        if S > 1 and _kernel_gate(
            "attn_kernel_enabled", arch.attn_kernel_enabled, q.is_cuda,
            ref_failed, _card_limits(D, q.dtype, store=store),
            lf.ref_only(),
        ):
            _record_strategy("cte_paged_kernel")
            return fa.paged_attention_prefill(
                q, k_cache_l, v_cache_l, ci["block_table"], position_ids, **scales)
        if S == 1 and _kernel_gate(
            "attn_block_tkg_kernel_enabled", arch.attn_block_tkg_kernel_enabled, q.is_cuda,
            ref_failed, _card_limits(D, q.dtype, store=store), lf.ref_only(),
        ):
            _record_strategy("tkg_paged_kernel")
            return fa.paged_attention_decode(
                q, k_cache_l, v_cache_l, ci["block_table"], position_ids, **scales)
    kk, vv, kv_pos = layout.read(k_cache_l, v_cache_l, ci, cache_spec)
    mask_override = ci.get("attn_mask")
    if mask_override is not None:
        # an explicit (B, S, W) mask (the token-tree verify), where causal by
        # position is wrong: plain attention, as in the JAX package
        _record_strategy("attn_mask_override_xla")
        return attn_ops.grouped_attention(q, kk, vv, mask_override[:, :, :kk.shape[2]],
                                          scale=arch.attention_scale, sink=sink,
                                          logit_softcap=arch.attn_logit_softcap)
    if S == 1 and _kernel_gate(
        "attn_tkg_kernel_enabled", arch.attn_tkg_kernel_enabled, q.is_cuda,
        _heads_ok(H, KV) + _kernel_refusals(arch), _card_limits(D, q.dtype),
        lf.ref_only(),
    ):
        _record_strategy("tkg_kernel")
        return fa.flash_attention_decode(q, kk, vv, position_ids, kv_pos,
                                         scale=arch.attention_scale, sliding_window=lf.window,
                                         chunk_size=lf.chunk, ring=_ring(layout))
    _record_strategy("tkg_xla")
    return attn_ops.attention_with_positions(
        q, kk, vv, position_ids, kv_pos, scale=arch.attention_scale,
        sliding_window=arch.sliding_window, sliding_window_enabled=lf.window_enabled,
        chunk_size=arch.chunk_size, chunk_enabled=lf.use_rope, sink=sink,
        logit_softcap=arch.attn_logit_softcap)


def _attend_mixed(arch, q, k_cache_l, v_cache_l, position_ids, ci, cache_spec, layout,
                  lf: LayerFlags = NO_FLAGS, sink=None):
    """The serving engine's mixed step: a packed (1, T) stream of prefill
    chunks and decode rows, tagged per token by ``mixed_row_ids`` (-1 =
    padding), with R per-row tables concatenated in ``block_table`` (1, R *
    Wt). Every token's fresh row is already in the pool. One ragged
    paged-attention launch, or plain attention over the combined gathered
    window with the ragged causal mask rebuilt from the tags.

    The plain mask carries the layer's sliding window and attention chunk
    (by its flags) and the attention carries the sink column and the logit
    softcap, as the split engine's paged attention does. The JAX package's
    mixed step rebuilds the causal mask alone and drops all four (ROADMAP
    Queue 3); the ragged kernel takes none of them (the JAX rule), so on the
    card such a family's mixed engine runs with ``attn_kernel_enabled``
    off, and with the flag on raises, naming the condition."""
    B, H, S, D = q.shape
    KV = arch.num_kv_heads
    rids = ci["mixed_row_ids"].to(torch.int32)  # (1, S)
    R = ci["last_token_index"].shape[0]  # rows per step
    bt = ci["block_table"].reshape(R, -1)  # (R, Wt) per-row tables
    ref_failed = [] if isinstance(layout, BlockKVLayout) else ["the KV layout is not paged"]
    if not ref_failed and not rpa.ragged_paged_kernel_supported(
            q.shape, k_cache_l.shape, layout.block_size):
        ref_failed.append(f"q {tuple(q.shape)} / pool {tuple(k_cache_l.shape)} is not a "
                          f"packed batch over whole blocks of {layout.block_size}")
    ref_failed += _window_refused(arch) + _chunk_refused(arch) + _kernel_refusals(arch)
    card = _card_limits(D, q.dtype, store=k_cache_l.dtype)
    if _kernel_gate("attn_kernel_enabled", arch.attn_kernel_enabled, q.is_cuda, ref_failed,
                    card, lf.ref_only()):
        _record_strategy("mixed_ragged_kernel")
        return rpa.ragged_paged_attention(
            q, k_cache_l, v_cache_l, bt, rids[0], position_ids[0],
            block_size=layout.block_size, k_scale=layout.k_scale, v_scale=layout.v_scale,
            scale=arch.attention_scale, plan=ci.get("ragged_plan"),
        )
    # plain: gather the combined window and rebuild the ragged causal mask
    # from the tags — kv column g serves row g // row_width at in-row
    # position g % row_width; holes carry the layout's poisoned position
    kk, vv, kv_pos = layout.read(k_cache_l, v_cache_l, ci, cache_spec)
    W = kk.shape[2]
    row_width = W // R
    g = torch.arange(W, device=q.device)
    live = kv_pos[0] < 2 ** 30
    in_row = (g % row_width)[None, :].to(position_ids.dtype)  # (1, W) each column's position
    mask = ((rids[:, :, None] == (g // row_width)[None, None, :])
            & attn_ops.position_mask(position_ids, in_row, arch.sliding_window,
                                     arch.chunk_size, lf.window_enabled, lf.use_rope)
            & live[None, None, :])
    _record_strategy("mixed_ragged_xla")
    return attn_ops.grouped_attention(q, kk, vv, mask, scale=arch.attention_scale, sink=sink,
                                      logit_softcap=arch.attn_logit_softcap)


def _qkv(arch, p_attn, hidden, stacked_layer_idx, qkv_stacked, adapter_ids=None):
    """q, k, v (B, S, width) of the layer: three products, or under
    ``fused_qkv`` one product over the interleaved weight (through the QKV
    kernel under ``qkv_kernel_enabled``), regrouped by rank block."""
    aq, ac = arch.act_quant, arch.act_clamp
    if not arch.fused_qkv:
        return tuple(_linear(hidden, p_attn[k], aq, ac, adapter_ids)
                     for k in ("q_proj", "k_proj", "v_proj"))
    if "qkv_proj" not in p_attn:
        raise NotImplementedError(
            "fused_qkv is enabled but this model's params carry no fused "
            "qkv_proj weight — the family's converter does not support "
            "fused QKV; disable the flag"
        )
    B, S, H_in = hidden.shape
    H, KV, D = arch.num_attention_heads, arch.num_kv_heads, arch.head_dim
    Tq, Tk, Tv = H * D, KV * D, KV * (arch.v_head_dim or D)
    if arch.qkv_kernel_enabled:
        if adapter_ids is not None or ("w" not in p_attn["qkv_proj"] and qkv_stacked is None):
            raise NotImplementedError(
                "qkv_kernel_enabled requires an unquantized, non-LoRA "
                "fused qkv_proj weight"
            )
        x2 = hidden.reshape(B * S, H_in)
        T = Tq + Tk + Tv
        # the JAX rule in interpret mode accepts every shape: only the card's limits remain
        _proj_gate("qkv_kernel_enabled", hidden.is_cuda, [],
                   fp.gemm_card_limits(H_in, T, hidden.dtype))
        if qkv_stacked is not None:
            w_s, b_s = qkv_stacked
            qkv = fp.qkv_matmul_stacked(x2, w_s, stacked_layer_idx, b_s)
        else:
            qkv = fp.qkv_matmul(x2, p_attn["qkv_proj"]["w"], p_attn["qkv_proj"].get("b"))
        qkv = qkv.reshape(B, S, T)
        _record_strategy("qkv_fused_kernel")
    else:
        qkv = _linear(hidden, p_attn["qkv_proj"], aq, ac, adapter_ids)
        _record_strategy("qkv_fused_matmul")
    # tp = 1 (the only degree ported): the interleaved weight is one rank
    # block [q | k | v], so no regroup by rank is needed
    return qkv.split((Tq, Tk, Tv), dim=-1)


def attention_block(
    arch: DecoderArch,
    p_attn: Dict[str, Any],
    hidden: torch.Tensor,  # (B, S, hidden)
    cos: torch.Tensor,
    sin: torch.Tensor,
    k_cache_l: torch.Tensor,  # this layer's (B_cache, KV, W, D) cache view
    v_cache_l: torch.Tensor,
    position_ids: torch.Tensor,  # (B, S)
    cache_spec: KVCacheSpec,
    attend_to_cache: bool,
    layout=DEFAULT_KV_LAYOUT,
    cache_inputs: Optional[Dict[str, torch.Tensor]] = None,
    defer_write: bool = False,
    stacked_layer_idx: Optional[int] = None,
    tkg_stacked=None,  # (k_s, v_s, kv_len, idx, ring): stacked-cache fused decode kernel
    qkv_stacked=None,  # (w_s, b_s): the stacked fused QKV weight for its kernel
    adapter_ids: Optional[torch.Tensor] = None,  # (B,) LoRA slots
    lf: LayerFlags = NO_FLAGS,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """QKV -> (q/k norms) -> RoPE -> KV write or deferred rows -> attention -> O.

    ``attend_to_cache=False`` (context encoding): queries attend the fresh K/V
    only, which are also written into the cache in place.
    ``defer_write`` (contiguous decode): attend the OLD cache plus the fresh
    row and return only the fresh rows; the caller commits them after the
    layers. Otherwise a cache-attending forward writes its fresh rows first
    and attends the cache (:func:`_attend_cache`)."""
    B, S, _ = hidden.shape
    H, KV, D = arch.num_attention_heads, arch.num_kv_heads, arch.head_dim
    Dv = arch.v_head_dim or D  # MiMo-V2: the value width apart from q/k's
    q, k, v = _qkv(arch, p_attn, hidden, stacked_layer_idx, qkv_stacked, adapter_ids)
    if arch.clip_qkv is not None:  # DBRX clamps the projections' outputs
        c = arch.clip_qkv
        q, k, v = q.clamp(-c, c), k.clamp(-c, c), v.clamp(-c, c)
    if arch.qk_norm_flat:
        q = flat_rms_norm(q, p_attn["q_norm"], arch.rms_norm_eps,
                          arch.qk_norm_flat_qdim or q.shape[-1])
        k = flat_rms_norm(k, p_attn["k_norm"], arch.rms_norm_eps, k.shape[-1])
    q = q.reshape(B, S, H, D)
    k = k.reshape(B, S, KV, D)
    if arch.qk_norm:
        q = _norm(arch, q, p_attn["q_norm"])
        k = _norm(arch, k, p_attn["k_norm"])
    q = q.transpose(1, 2)
    k = k.transpose(1, 2)
    v = v.reshape(B, S, KV, Dv).transpose(1, 2)
    rope = apply_rotary_pos_emb_interleaved if arch.rope_interleaved else apply_rotary_pos_emb
    if arch.rotary_dim is not None and arch.rotary_dim < D:
        # partial rotary: the first rotary_dim channels rotate (cos / sin are
        # rotary_dim wide), the rest pass through
        rd, full_rope = arch.rotary_dim, rope

        def rope(q_, k_, cos_, sin_):
            qr_, kr_ = full_rope(q_[..., :rd], k_[..., :rd], cos_, sin_)
            return torch.cat([qr_, q_[..., rd:]], dim=-1), torch.cat([kr_, k_[..., rd:]], dim=-1)

    if arch.no_rope:
        pass  # the learned-position lineage: positions ride the embeddings
    elif lf.use_rope is None:
        q, k = rope(q, k, cos, sin)
    else:  # a no-rope layer (SmolLM3, Llama 4) keeps q and k as they are
        qr, kr = rope(q, k, cos, sin)
        q, k = torch.where(lf.use_rope, qr, q), torch.where(lf.use_rope, kr, k)
    if arch.qk_l2norm:
        # Llama 4: the unweighted L2 norm after rope, on the rope layers
        qn, kn = l2_norm(q, arch.rms_norm_eps), l2_norm(k, arch.rms_norm_eps)
        if lf.use_rope is None:
            q, k = qn, kn
        else:
            q, k = torch.where(lf.use_rope, qn, q), torch.where(lf.use_rope, kn, k)
    if arch.attn_temperature_tuning and lf.use_rope is not None:
        # Llama 4: the NoPE layers' query temperature by position, from the
        # device's position ids (a graph holds it)
        pos = position_ids.float()
        scales = (torch.log1p(torch.floor((pos + 1.0) / arch.floor_scale)) * arch.attn_scale
                  + 1.0)[:, None, :, None]
        q = torch.where(lf.use_rope, q, (q * scales).to(q.dtype))
    sink = p_attn["sink"] if arch.attention_sink else None  # (H,) learned logits
    # the plain paths' masks take the flags on the device; the kernels the
    # layer's window and chunk on the host
    sc, win = arch.attention_scale, dict(sliding_window=arch.sliding_window,
                                         sliding_window_enabled=lf.window_enabled,
                                         chunk_size=arch.chunk_size, chunk_enabled=lf.use_rope,
                                         sink=sink, logit_softcap=arch.attn_logit_softcap)

    def o_proj(ctx):  # (B, H, S, Dv) -> (B, S, hidden)
        ctx2d = ctx.transpose(1, 2).reshape(B, S, H * Dv)
        if arch.attn_out_gate:
            # AFMoE: the context times sigmoid(attention input @ gate_proj),
            # in float32, on every strategy's context
            g = torch.sigmoid(_linear(hidden, p_attn["gate_proj"], arch.act_quant,
                                      arch.act_clamp).float())
            ctx2d = (ctx2d.float() * g).to(ctx2d.dtype)
        return _linear(ctx2d, p_attn["o_proj"], arch.act_quant, arch.act_clamp, adapter_ids)

    ci = dict(cache_inputs or {})
    ci["position_ids"] = position_ids
    if not attend_to_cache and S > 1:
        ci["prefill_from_zero"] = True
    if attend_to_cache and defer_write:
        if tkg_stacked is not None and S == 1:
            k_s, v_s, kv_len, idx, ring = tkg_stacked
            ctx = fa.flash_attention_decode_fused_stacked(
                q, k_s, v_s, k, v, position_ids, idx, kv_len=kv_len,
                lines=layout.lines(ci, B), scale=sc, sliding_window=lf.window,
                chunk_size=lf.chunk, ring=ring,
            )
            _record_strategy("tkg_fused_kernel_stacked")
            return o_proj(ctx), (k, v)
        kk, vv, kv_pos = layout.read(k_cache_l, v_cache_l, ci, cache_spec)
        # a scaled store: the JAX package's round trip of the fresh rows goes
        # through its forward's cache spec, which carries no quant dtype, so
        # the rows are divided and multiplied by their scale in the compute
        # dtype and never cast to the store; the port does the same (ROADMAP
        # Queue 3)
        k_att = layout.round_trip("k", k, cache_spec.torch_dtype, ci)
        v_att = layout.round_trip("v", v, cache_spec.torch_dtype, ci)
        # the JAX rule's per-layer fused kernel over the gathered, dequantized
        # window, where the stacked kernel is off: on the CPU under routed
        # lines, frozen rows or a quantized store; on the card (which runs
        # the stacked kernel under lines and frozen rows) a quantized store.
        # A frozen row is an ordinary row there, whose output nobody reads
        # the JAX rule also leaves a ring layer (its positions wrap) for plain
        # attention; the card's kernel takes the ring operand
        if S == 1 and _kernel_gate(
            "attn_tkg_kernel_enabled", arch.attn_tkg_kernel_enabled, q.is_cuda,
            _heads_ok(H, KV) + _kernel_refusals(arch), _card_limits(D, q.dtype),
            (("frozen-row write positions",) if "write_positions" in ci else ())
            + (("a window-sized ring layer",) if _ring(layout) else ()) + lf.ref_only(),
        ):
            _record_strategy("tkg_fused_kernel")
            ctx = fa.flash_attention_decode_fused(q, kk, vv, k_att, v_att, position_ids, kv_pos,
                                                  scale=sc, sliding_window=lf.window,
                                                  chunk_size=lf.chunk, ring=_ring(layout))
            return o_proj(ctx), (k, v)
        # this step's slots hold stale rows: poison their positions so only
        # the fresh rows are attended there (frozen rows write nothing)
        wpos = layout.write_positions(ci).to(torch.int32)
        hit = (kv_pos[:, None, :] == wpos[:, :, None]).any(dim=1)
        kv_pos = torch.where(hit, torch.full_like(kv_pos, 2 ** 30), kv_pos)
        _record_strategy("tkg_two_part_xla")
        ctx = attn_ops.attention_two_part(q, kk, vv, k_att, v_att, position_ids, kv_pos, wpos,
                                          scale=sc, **win)
        return o_proj(ctx), (k, v)

    layout.update(k_cache_l, v_cache_l, k, v, ci, cache_spec)
    if attend_to_cache:
        ctx = _attend_cache(arch, q, k_cache_l, v_cache_l, position_ids, ci, cache_spec, layout,
                            lf, sink)
        return o_proj(ctx), (k_cache_l, v_cache_l)
    use_kernel = _kernel_gate(
        "attn_kernel_enabled", arch.attn_kernel_enabled, q.is_cuda,
        _heads_ok(H, KV) + _kernel_refusals(arch), _card_limits(D, q.dtype), lf.ref_only(),
    )
    if use_kernel:
        ctx = fa.flash_attention_prefill(q, k, v, position_ids, position_ids, scale=sc,
                                         sliding_window=lf.window, chunk_size=lf.chunk)
        _record_strategy("cte_flash_kernel")
    else:
        ctx = attn_ops.attention_with_positions(q, k, v, position_ids, position_ids, scale=sc,
                                                **win)
        _record_strategy("cte_xla")
    return o_proj(ctx), (k_cache_l, v_cache_l)


def mlp_block(arch: DecoderArch, p_mlp: Dict[str, Any], x: torch.Tensor,
              mlp_stacked=None, layer_idx: Optional[int] = None,
              adapter_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gated MLP: down(act(x @ gate) * (x @ up)), or under ``gated_mlp=False``
    the plain down(act(x @ up)) (Arcee).

    ``mlp_kernel_enabled`` routes it through the fused MLP kernel — with the
    layer-stacked weights and the layer index when ``mlp_stacked`` holds
    them — and raises where that kernel is not eligible (a non-gated MLP, MLP
    biases, LoRA adapters, an activation the kernel has not); it never falls
    back."""
    if arch.mlp_kernel_enabled:
        bad = ("non-gated MLP" if not arch.gated_mlp
               else "MLP biases" if arch.mlp_bias
               else "LoRA adapters" if adapter_ids is not None else None)
        if bad is not None:
            raise NotImplementedError(f"mlp_kernel_enabled does not support {bad}; "
                                      "disable the flag")
        B, S, H = x.shape
        I = arch.intermediate_size
        # the JAX rule: any shape, one of the kernel's activations
        ref = ([] if arch.hidden_act in fp.KERNEL_ACTS
               else [f"activation {arch.hidden_act!r} is not one of {fp.KERNEL_ACTS}"])
        _proj_gate("mlp_kernel_enabled", x.is_cuda, ref,
                   fp.gemm_card_limits(H, I, x.dtype) + fp.gemm_card_limits(I, H, x.dtype))
        x2 = x.reshape(B * S, H)
        if mlp_stacked is not None:
            out = fp.fused_mlp_stacked(x2, *mlp_stacked, layer_idx, act=arch.hidden_act)
        else:
            out = fp.fused_mlp(x2, p_mlp["gate_proj"]["w"], p_mlp["up_proj"]["w"],
                               p_mlp["down_proj"]["w"], act=arch.hidden_act)
        _record_strategy("mlp_fused_kernel")
        return out.reshape(B, S, H)
    aq, ac = arch.act_quant, arch.act_clamp
    up = _linear(x, p_mlp["up_proj"], aq, ac, adapter_ids)
    if arch.hidden_act == "xielu":
        # Apertus: the layer's activation scalars ride its mlp params
        a = p_mlp["xielu"]
        return _linear(xielu(up, a["alpha_p"], a["alpha_n"]), p_mlp["down_proj"], aq, ac,
                       adapter_ids)
    act = ACT_FNS[arch.hidden_act]
    if not arch.gated_mlp:
        return _linear(act(up), p_mlp["down_proj"], aq, ac, adapter_ids)
    gate = act(_linear(x, p_mlp["gate_proj"], aq, ac, adapter_ids))
    return _linear(gate * up, p_mlp["down_proj"], aq, ac, adapter_ids)


def decoder_layer(
    arch, lp, hidden, cos, sin, k_cache_l, v_cache_l, position_ids, cache_spec,
    attend_to_cache, layout=DEFAULT_KV_LAYOUT, cache_inputs=None, defer_write=False,
    stacked_layer_idx=None, tkg_stacked=None, mlp_stacked=None, qkv_stacked=None,
    adapter_ids=None, kv_window=None, window: Optional[int] = None,
    chunk: Optional[int] = None,
):
    """One layer. ``kv_window`` (an MLA layer only, which writes into its
    whole cache line before attending) bounds the attended window; other
    layers get their cache views already windowed. ``window`` / ``chunk``:
    the layer's sliding window and attention chunk on the host
    (:meth:`DecoderArch.layer_window`, :meth:`DecoderArch.layer_chunk`); its
    ``use_sliding_window`` / ``use_rope`` flags ride the params."""
    lf = LayerFlags(lp.get("use_sliding_window"), lp.get("use_rope"), window, chunk)
    if "use_local_rope" in lp:
        # Gemma-3: cos / sin arrive stacked [global, local] and the layer's
        # flag picks one on the device (torch.where: a graph holds it)
        cos = torch.where(lp["use_local_rope"], cos[1], cos[0])
        sin = torch.where(lp["use_local_rope"], sin[1], sin[0])
    h = hidden if arch.post_block_norm else _norm(arch, hidden, lp["input_layernorm"])
    if "input_norm_skip" in lp:
        # an EAGLE draft's first layer takes the fc output without its input
        # norm: the flag is a device scalar, read by torch.where (no host read)
        h = torch.where(lp["input_norm_skip"], hidden, h)
    if arch.mla is not None:
        # the JAX rule: MLA attention takes no adapter (LoRA skips it)
        attn_out, kv = mla_ops.mla_attention_block(
            arch, lp["attn"], h, cos, sin, k_cache_l, v_cache_l, position_ids, cache_spec,
            attend_to_cache, layout, cache_inputs, kv_window=kv_window,
        )
        _record_strategy("mla_xla")
    else:
        attn_out, kv = attention_block(
            arch, lp["attn"], h, cos, sin, k_cache_l, v_cache_l, position_ids, cache_spec,
            attend_to_cache, layout, cache_inputs, defer_write=defer_write,
            stacked_layer_idx=stacked_layer_idx, tkg_stacked=tkg_stacked,
            qkv_stacked=qkv_stacked, adapter_ids=adapter_ids, lf=lf,
        )
    rm = arch.residual_multiplier
    if arch.parallel_block:
        # Cohere 2: the feed-forward reads the layer input through its own
        # norm (the converter aliases Cohere's one norm onto both keys), and
        # both branches join the residual in one add
        h = _norm(arch, hidden, lp["post_attention_layernorm"])
        if arch.moe is not None and "moe" in lp:
            _record_strategy(moe_ops.moe_strategy(arch.moe, h))
            ff = moe_ops.moe_block(arch, arch.moe, lp["moe"], h)
        else:
            ff = mlp_block(arch, lp["mlp"], h, mlp_stacked, stacked_layer_idx, adapter_ids)
        return hidden + (attn_out + ff) * rm, kv
    if arch.sandwich_norm:
        # the Gemma 2/3 layout (its four norms (1 + w) under gemma_norm) and
        # AFMoE's: the attention output normed before its residual add; the
        # feed-forward (MoE or dense by the params) between its own pre- and
        # post-norms
        hidden = hidden + _norm(arch, attn_out, lp["post_attention_layernorm"])
        h = _norm(arch, hidden, lp["pre_feedforward_layernorm"])
        if arch.moe is not None and "moe" in lp:
            _record_strategy(moe_ops.moe_strategy(arch.moe, h))
            ff = moe_ops.moe_block(arch, arch.moe, lp["moe"], h)
        else:
            ff = mlp_block(arch, lp["mlp"], h, mlp_stacked, stacked_layer_idx, adapter_ids)
        return hidden + _norm(arch, ff, lp["post_feedforward_layernorm"]), kv
    if arch.post_block_norm:
        # OLMo-2: x + norm(attn(x)); x + norm(mlp(x))
        hidden = hidden + _norm(arch, attn_out, lp["input_layernorm"]) * rm
        ff = mlp_block(arch, lp["mlp"], hidden, mlp_stacked, stacked_layer_idx, adapter_ids)
        return hidden + _norm(arch, ff, lp["post_attention_layernorm"]) * rm, kv
    hidden = hidden + attn_out * rm
    h = _norm(arch, hidden, lp["post_attention_layernorm"])
    # MoE or dense per layer, by the params' structure (the JAX package's rule)
    if arch.moe is not None and "moe" in lp:
        _record_strategy(moe_ops.moe_strategy(arch.moe, h))
        return hidden + moe_ops.moe_block(arch, arch.moe, lp["moe"], h) * rm, kv
    return hidden + mlp_block(arch, lp["mlp"], h, mlp_stacked, stacked_layer_idx,
                              adapter_ids) * rm, kv


def stacked_proj_weights(arch: DecoderArch, stacked: Dict[str, Any]):
    """The layer-stacked MLP and fused-QKV weights for their kernels, when
    those are enabled: ((gate_s, up_s, down_s) or None, (w_s, b_s) or None).
    Each layer hands its kernel the (L, ...) weight and its index, and the
    kernel offsets its pointer — the torch counterpart of the JAX package's
    scalar-prefetched layer index. ``stacked`` is one segment of the layer
    stack: a segment without a dense MLP (an MoE segment or model) has no
    stacked MLP weights."""
    mlp, qkv = stacked.get("mlp"), stacked["attn"].get("qkv_proj")
    mlp_st = (tuple(mlp[k]["w"] for k in ("gate_proj", "up_proj", "down_proj"))
              if arch.mlp_kernel_enabled and arch.gated_mlp and mlp is not None else None)
    qkv_st = ((qkv["w"], qkv.get("b"))
              if arch.qkv_kernel_enabled and qkv is not None and "w" in qkv else None)
    return mlp_st, qkv_st


def layer_params(stacked: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Layer ``i`` of a layer-stacked params dict (views, no copies)."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i] for k, v in stacked.items()}


def layer_segments(layers) -> List[Dict[str, Any]]:
    """The layer-stacked segments of ``params["layers"]``: a list of them
    (a heterogeneous stack), or one stacked dict."""
    return list(layers) if isinstance(layers, (list, tuple)) else [layers]


def segment_len(seg: Dict[str, Any]) -> int:
    """The number of layers of one layer-stacked segment."""
    norm = seg["input_layernorm"]
    return (norm["w"] if isinstance(norm, dict) else norm).shape[0]


def _kinds(arch: DecoderArch, cache, layout):
    """(per layer: its stack's key suffix and its index in that stack; each
    stack's layout by suffix). In an interleaved window-sized stack
    (``"k_win"`` in the cache) full layers sit on ``k`` / ``v`` under
    ``layout`` and window layers on the ring ``k_win`` / ``v_win`` under a
    :class:`WindowKVLayout` of the ring's slots; in any other cache every
    layer sits on ``k`` / ``v`` at its own index."""
    if "k_win" not in cache:
        return [("", i) for i in range(arch.num_layers)], {"": layout}
    pat = arch.kv_window_pattern
    if pat is None or len(pat) != arch.num_layers:
        raise ValueError("the cache carries a k_win ring stack but arch.kv_window_pattern is "
                         f"unset or mismatched (pattern {pat}, layers {arch.num_layers})")
    ring = WindowKVLayout(window=cache["k_win"].shape[3],
                          route_by_seq_id=getattr(layout, "route_by_seq_id", False))
    kinds, n = [], [0, 0]
    for w in pat:
        kinds.append(("_win", n[1]) if w else ("", n[0]))
        n[bool(w)] += 1
    return kinds, {"": layout, "_win": ring}


def run_decoder_layers(
    arch: DecoderArch,
    stacked_params,  # a layer-stacked dict, or a list of such segments
    hidden: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    cache: Dict[str, torch.Tensor],  # (L, B, KV, S_max, D) or pool (L, slots, KV, D); in place
    position_ids: torch.Tensor,
    cache_spec: KVCacheSpec,
    attend_to_cache: bool,
    kv_window: Optional[int] = None,
    layout=DEFAULT_KV_LAYOUT,
    cache_inputs: Optional[Dict[str, torch.Tensor]] = None,
    collect: Optional[List[torch.Tensor]] = None,
    adapter_ids: Optional[torch.Tensor] = None,
):
    """Run the layer stack. Decode on the contiguous cache defers its cache
    writes and commits every layer's fresh rows in ONE kernel launch after
    the loop, and so does a multi-token verify on the homogeneous
    window-sized ring (written first, its rows past the first query would
    read as positions a whole ring back: the ring infers its positions from
    the first query; the JAX package writes first there, ROADMAP Queue 3);
    the paged pool, the ring's one-token decode, a forward under an explicit
    ``attn_mask`` (the token-tree verify) and an MLA model never defer (each
    layer writes its rows before attending). A list of
    segments runs in order, each over its slice of the stacked cache, its
    stacked kernel weights indexed by the segment-local layer.

    An interleaved window-sized stack (``window_sized_kv`` on a model with
    full and sliding-window layers: ``k_win`` / ``v_win`` in the cache) is
    the JAX package's ``_interleaved_window_scan`` as a plain loop: each
    layer reads its own stack at its index within its kind (:func:`_kinds`),
    full layers under the primary layout, window layers under the ring's;
    deferred rows commit once per stack (the ring's at slot ``p % W``). The
    JAX package runs no stacked decode kernel there; on the card the port
    runs the stacked kernel over either stack, in its ring mode over the
    ring.

    ``kv_window`` bounds the attended contiguous cache to the bucket's
    window: the stacked fused kernel takes it as ``kv_len`` without slicing,
    the plain path attends a sliced view; a ring is never cut. The paged
    window is the block table's width. ``collect``, when given, receives
    each layer's output hidden state in order (EAGLE3's ``aux_hidden``)."""
    contiguous = isinstance(layout, ContiguousKVLayout)
    S = position_ids.shape[1]
    # a multi-token verify on the homogeneous ring defers too: written
    # first, its rows past the first query would read as positions a whole
    # ring back (the ring's positions are inferred from the first query)
    defer = (attend_to_cache and (contiguous or (_ring(layout) is not None and S > 1))
             and arch.mla is None and (cache_inputs or {}).get("attn_mask") is None)
    interleaved = "k_win" in cache
    segments = layer_segments(stacked_params)
    if (arch.chunk_size is not None and arch.rope_pattern is None
            and any("use_rope" in seg for seg in segments)):
        raise ValueError("the layers carry use_rope flags but arch.rope_pattern is unset: the "
                         "card's kernels would chunk the NoPE layers too")
    if interleaved and len(segments) != 1:
        raise NotImplementedError("interleaved window-sized KV requires a homogeneous layer stack")
    kinds, layouts = _kinds(arch, cache, layout)
    H, KV = arch.num_attention_heads, arch.num_kv_heads
    use_stacked_tkg = False
    if defer and S == 1:
        # the JAX rule leaves the stacked kernel under routed lines and frozen
        # rows; the card's kernel takes both (its line operand; a frozen row
        # is an ordinary row whose output nobody reads). It reads the cache in
        # q's dtype, so a scaled or narrowed store leaves it (the JAX rule) for
        # the per-layer fused kernel over the dequantized window
        # (decoder_layer), on the card too
        # per-layer window / rope flags and interleaved ring stacks likewise
        # leave it under the JAX rule; the card's kernel takes each layer's
        # window as its own scalar, and a ring through its ring operand
        flags = set().union(*segments)
        ref_only = tuple(cond for cond, hit in (
            ("cache lines routed by seq_ids", layout.route_by_seq_id),
            ("frozen-row write positions", "write_positions" in (cache_inputs or {})),
            ("per-layer sliding-window flags", "use_sliding_window" in flags),
            ("per-layer rope flags", "use_rope" in flags),
            ("per-layer local rope flags", "use_local_rope" in flags),
            ("interleaved window-sized ring stacks", interleaved),
        ) if hit)
        quantized = (layout.scaled("k") or layout.scaled("v")
                     or cache["k"].dtype != cache_spec.torch_dtype)
        use_stacked_tkg = not quantized and _kernel_gate(
            "attn_tkg_kernel_enabled", arch.attn_tkg_kernel_enabled, hidden.is_cuda,
            _heads_ok(H, KV) + _kernel_refusals(arch),
            _card_limits(arch.head_dim, hidden.dtype),
            ref_only,
        )
    windowable = contiguous and attend_to_cache and not use_stacked_tkg and kv_window is not None
    # per-layer KV scale tables select their row by the (global) layer index
    per_layer = contiguous and layout.has_array_scales()
    rows: Dict[str, Tuple[List, List]] = {}  # fresh rows by stack ("" or "_win")
    off = 0
    for seg in segments:
        n_seg = segment_len(seg)
        mlp_stacked, qkv_stacked = stacked_proj_weights(arch, seg)
        for j in range(n_seg):
            i = off + j
            kind, idx = kinds[i]
            lay = layouts[kind]
            ring = _ring(lay)
            # the stacked fused decode reads the layer's stack at the layer's
            # index there, a ring whole
            stack_k, stack_v = cache["k" + kind], cache["v" + kind]
            tkg_stacked = ((stack_k, stack_v, None if ring else kv_window, idx, ring)
                           if use_stacked_tkg else None)
            kl, vl = stack_k[idx], stack_v[idx]
            mla_window = None
            if windowable and ring is None and kv_window < kl.shape[2]:
                if arch.mla is not None:
                    mla_window = kv_window  # the write lands in the whole line first
                else:
                    kl, vl = kl[:, :, :kv_window], vl[:, :, :kv_window]
            ci = {**(cache_inputs or {}), "layer_idx": i} if per_layer else cache_inputs
            hidden, (nk, nv) = decoder_layer(
                arch, layer_params(seg, j), hidden, cos, sin, kl, vl, position_ids,
                cache_spec, attend_to_cache, lay, ci, defer_write=defer,
                stacked_layer_idx=j, tkg_stacked=tkg_stacked, mlp_stacked=mlp_stacked,
                qkv_stacked=qkv_stacked, adapter_ids=adapter_ids, kv_window=mla_window,
                window=arch.layer_window(i), chunk=arch.layer_chunk(i),
            )
            if collect is not None:
                collect.append(hidden)
            if defer:
                ks, vs = rows.setdefault(kind, ([], []))
                ks.append(nk)
                vs.append(nv)
        off += n_seg
    if defer:
        ci_commit = dict(cache_inputs or {})
        ci_commit["position_ids"] = position_ids  # write_positions, when given, win
        for kind, (ks, vs) in rows.items():
            layouts[kind].commit_rows({"k": cache["k" + kind], "v": cache["v" + kind]},
                                      torch.stack(ks), torch.stack(vs), ci_commit, cache_spec)
    return hidden, cache


# the layout inputs a forward's batch may carry (the paged pool's block
# tables and the host-built scatter indices of its slot mapping; the mixed
# step's token tags, its per-row last-token indices, which give R, and the
# ragged kernels' work list; the K-step bodies' and the token tree's write
# positions and the tree's explicit mask)
CACHE_INPUT_KEYS = ("block_table", "write_index", "write_slots", "mixed_row_ids",
                    "last_token_index", "ragged_plan", "seq_ids", "write_positions",
                    "attn_mask")


def causal_lm_forward(
    arch: DecoderArch,
    inv_freq,
    params: Dict[str, Any],
    cache: Dict[str, torch.Tensor],
    batch: Dict[str, torch.Tensor],
    *,
    attend_to_cache: bool,
    kv_window: Optional[int] = None,
    layout=DEFAULT_KV_LAYOUT,
    gather_last_token: bool = True,
    output_logits: bool = False,
    on_device_sampling: bool = True,
    do_sample: bool = False,
    global_topk: int = 256,
    deterministic: bool = False,
    mixed_rows: bool = False,
    return_next_inputs: bool = False,
    output_argmax_all: bool = False,
    output_hidden: bool = False,
    aux_hidden_indices: Optional[Tuple[int, ...]] = None,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """One submodel forward. ``batch``: input_ids (B,S), position_ids (B,S),
    last_token_index (B,), sampling_params (B,3), and on the paged pool
    block_table (B,NB), write_index and write_slots, and under LoRA
    adapter_ids (B,) — tensors on the model's device. Returns (outputs, cache); outputs has "tokens" (B,1) int32 when
    sampling on device and "logits" (B,1|S,V) float32 when asked for.

    ``mixed_rows`` (the serving engine's one-dispatch mixed step): B is 1 and
    the scheduler's R rows live along the packed token axis, tagged by
    ``mixed_row_ids``; ``last_token_index`` (R,) holds the packed index of
    each row's newest token and ``sampling_params`` is (R, 3), so the
    lm_head and sampling tail runs with R as its batch.

    ``return_next_inputs`` (with on-device sampling; the device-resident
    decode loop): outputs also carry ``next_inputs``, the next
    token-generation step's inputs on the device — this step's tokens, the
    position after each row's last token, last_token_index 0 and the same
    sampling params, the next key (``next_step_rng``) and the cache lines
    (the JAX package's ``next_inputs``).

    With ``do_sample`` the batch carries ``rng``, the (2,) step key of
    :func:`~nxdi_tpu_torch.ops.sampling.uniform_from_key`.

    Speculation's outputs (the JAX package's): ``output_logits`` with
    ``gather_last_token=False`` returns the logits of every position (the
    JAX package's ``output_all_logits``); ``output_argmax_all`` returns
    ``tokens`` (B, S), the greedy token at every position, selected on the
    device (ties to the first index), and no logits unless asked for;
    ``output_hidden`` returns ``hidden`` (B, S, H), the last layer's stream
    before the final norm; ``aux_hidden_indices`` returns ``aux_hidden``
    (B, S, len(indices) * H), the chosen layers' outputs concatenated (an
    EAGLE3 target's features).

    EAGLE drafts (``models/llama_eagle.py``): params with ``fc`` fuse the
    token embedding with ``batch["prev_hidden"]`` (B, >= S, H), the previous
    position's feature, as ``fc(concat(embed, prev_hidden))``; a per-layer
    ``input_norm_skip`` flag bypasses that layer's input norm; params
    without ``norm`` feed the lm_head the pre-norm stream."""
    input_ids = batch["input_ids"]
    position_ids = batch["position_ids"]
    compute_dtype = to_torch_dtype(arch.dtype)

    hidden = F.embedding(input_ids.long(), params["embed_tokens"]).to(compute_dtype)
    if arch.embed_scale is not None:
        # after the cast to the compute dtype, by the scale rounded to it (the
        # JAX package's order); a host float, so a captured graph holds it
        hidden = hidden * float(torch.tensor(arch.embed_scale, dtype=compute_dtype))
    if arch.learned_pos_embeds:
        # the position table at position_ids, after the embedding's scale (the
        # JAX package's order). Padded and warmup rows may carry positions past
        # the table (a prefill's right padding continues the arange, a K-step
        # window runs past the last bucket), where the JAX package's take
        # fills a NaN row and an index on the card would fault (inside a
        # captured graph, fatally): they read the table's last row instead;
        # every real position lies inside it (the configs refuse a seq_len
        # past the table)
        table = params["position_embeddings"]
        idx = position_ids.long().clamp(0, table.shape[0] - 1)
        hidden = hidden + F.embedding(idx, table).to(compute_dtype)
    if "fc" in params:
        feats = batch["prev_hidden"][:, : input_ids.shape[1]].to(compute_dtype)
        hidden = _linear(torch.cat([hidden, feats], dim=-1), params["fc"], arch.act_quant,
                         arch.act_clamp)
    if arch.longrope_original_max is not None and inv_freq.ndim == 2:
        # LongRoPE: the [short, long] set chosen from the true last position
        # (padding lanes run past the real last token, so read it at
        # last_token_index); a device-side select, no host read, so a
        # captured graph keeps choosing per replay
        inv = torch.as_tensor(inv_freq, dtype=torch.float32, device=position_ids.device)
        if "last_token_index" in batch:
            lti = batch["last_token_index"].long()
            real_last = (position_ids[0][lti] if mixed_rows
                         else torch.gather(position_ids, 1, lti[:, None]))
            seq_len_now = real_last.max() + 1
        else:
            seq_len_now = position_ids.max() + 1
        inv_freq = torch.where(seq_len_now > arch.longrope_original_max, inv[1], inv[0])
    if arch.no_rope:
        cos = sin = None  # no layer applies rope
    elif arch.longrope_original_max is None and inv_freq.ndim == 2:
        # Gemma-3's [global, local] pair: (2, B, S, D) each, picked per layer
        # by its use_local_rope flag (decoder_layer)
        cos, sin = rope_cos_sin_pair(position_ids, inv_freq, dtype=torch.float32)
    else:
        cos, sin = rope_cos_sin(position_ids, inv_freq, dtype=torch.float32)
    if arch.rope_mscale != 1.0 and cos is not None:
        cos = cos * arch.rope_mscale
        sin = sin * arch.rope_mscale
    if isinstance(layout, BlockKVLayout):
        cache_spec = BlockKVCacheSpec(
            num_layers=arch.num_layers, num_blocks=cache["k"].shape[1] // layout.block_size,
            block_size=layout.block_size, num_kv_heads=arch.num_kv_heads,
            head_dim=arch.head_dim, dtype=arch.dtype, quant_dtype=arch.kv_quant_dtype,
        )
    else:
        cache_spec = arch.kv_cache_spec(cache["k"].shape[1], cache["k"].shape[3])
    layer_hiddens: Optional[List[torch.Tensor]] = [] if aux_hidden_indices else None
    hidden, cache = run_decoder_layers(
        arch, params["layers"], hidden, cos, sin, cache, position_ids, cache_spec,
        attend_to_cache, kv_window=kv_window, layout=layout,
        cache_inputs={k: batch[k] for k in CACHE_INPUT_KEYS if k in batch},
        collect=layer_hiddens, adapter_ids=batch.get("adapter_ids"),
    )
    return lm_head_outputs(
        arch, params, batch, hidden, cache, layer_hiddens=layer_hiddens,
        gather_last_token=gather_last_token, output_logits=output_logits,
        on_device_sampling=on_device_sampling, do_sample=do_sample, global_topk=global_topk,
        deterministic=deterministic, mixed_rows=mixed_rows,
        return_next_inputs=return_next_inputs, output_argmax_all=output_argmax_all,
        output_hidden=output_hidden, aux_hidden_indices=aux_hidden_indices)


def lm_head_outputs(
    arch: DecoderArch, params: Dict[str, Any], batch: Dict[str, torch.Tensor],
    hidden: torch.Tensor, cache: Dict[str, torch.Tensor], *,
    layer_hiddens: Optional[List[torch.Tensor]] = None, gather_last_token: bool = True,
    output_logits: bool = False, on_device_sampling: bool = True, do_sample: bool = False,
    global_topk: int = 256, deterministic: bool = False, mixed_rows: bool = False,
    return_next_inputs: bool = False, output_argmax_all: bool = False,
    output_hidden: bool = False, aux_hidden_indices: Optional[Tuple[int, ...]] = None,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """The tail of :func:`causal_lm_forward` after the layer stack (the
    final norm, the last-token gather, the lm_head and its scalings, the
    sampler and the outputs), shared by the families with their own layer
    walk (``models/mimo_v2``, ``models/lfm2``)."""
    position_ids = batch["position_ids"]
    pre_norm_hidden = hidden
    if "norm" in params:  # EAGLE drafts have no final norm
        hidden = _norm(arch, hidden, params["norm"])
    lm_head = params.get("lm_head")
    if lm_head is None:  # tied embeddings
        lm_head = params["embed_tokens"].t()
    if mixed_rows:
        # gather each row's newest token off the single packed batch row
        hidden = hidden[0][batch["last_token_index"].long()][:, None, :]
    elif gather_last_token:
        idx = batch["last_token_index"].long()
        hidden = hidden[torch.arange(hidden.shape[0], device=hidden.device), idx][:, None]
    logits = (hidden @ lm_head.to(hidden.dtype)).float()
    if "lm_head_bias" in params:  # Phi: a biased head, in float32
        logits = logits + params["lm_head_bias"].float()
    if arch.logits_scaling != 1.0:
        logits = logits / arch.logits_scaling
    if arch.final_logit_softcap is not None:
        cap = arch.final_logit_softcap
        logits = cap * torch.tanh(logits / cap)
    logits = sampling_ops.mask_padded_logits(logits, arch.vocab_pad)

    outputs: Dict[str, torch.Tensor] = {}
    if output_hidden:
        outputs["hidden"] = pre_norm_hidden
    if aux_hidden_indices:
        outputs["aux_hidden"] = torch.cat([layer_hiddens[i] for i in aux_hidden_indices], dim=-1)
    if output_argmax_all:
        outputs["tokens"] = sampling_ops.greedy_sample(logits)
    if on_device_sampling:
        tokens = sampling_ops.sample(
            logits[:, -1, :], batch.get("sampling_params"), rng=batch.get("rng"),
            do_sample=do_sample, global_topk=global_topk, deterministic=deterministic)
        outputs["tokens"] = tokens[:, None]
    if output_logits or not (on_device_sampling or output_argmax_all):
        outputs["logits"] = logits[..., : arch.vocab_size - arch.vocab_pad]
    if return_next_inputs and on_device_sampling:
        lti = batch["last_token_index"]
        outputs["next_inputs"] = {
            # a copy: the next step rewrites its inputs in place
            "input_ids": outputs["tokens"].to(torch.int32, copy=True),
            # the next token goes one past each row's current last position
            "position_ids": (torch.gather(position_ids, 1, lti.long()[:, None]) + 1)
            .to(torch.int32),
            "last_token_index": torch.zeros_like(lti),
            "sampling_params": batch["sampling_params"],
        }
        if "rng" in batch:
            outputs["next_inputs"]["rng"] = sampling_ops.next_step_rng(batch["rng"])
        if "seq_ids" in batch:
            outputs["next_inputs"]["seq_ids"] = batch["seq_ids"]
    return outputs, cache


# ---------------------------------------------------------------------------
# The device-resident decode family: K steps per forward, and the loop
# ---------------------------------------------------------------------------

# step inputs chained from one in-forward decode step to the next (the 1-step
# forward's next_inputs), and inputs carried through unchanged
_MULTISTEP_CHAIN_KEYS = ("input_ids", "position_ids", "last_token_index", "sampling_params")
_MULTISTEP_PASSTHROUGH_KEYS = ("seq_ids", "eos_token_ids", "pad_token_id")


def _decode_step(arch, inv_freq, params, cache, step_batch, done, *, kv_window, layout,
                 sampling):
    """One step of the K-step and loop bodies: a 1-step forward whose frozen
    rows write nothing (write position -1). Returns (the sampled tokens (B,),
    the forward's next_inputs)."""
    fwd = dict(step_batch)
    fwd["write_positions"] = torch.where(
        done[:, None], torch.full_like(step_batch["position_ids"], -1),
        step_batch["position_ids"])
    out, _ = causal_lm_forward(
        arch, inv_freq, params, cache, fwd, attend_to_cache=True, kv_window=kv_window,
        layout=layout, gather_last_token=False, on_device_sampling=True,
        return_next_inputs=True, **sampling)
    return out["tokens"][:, 0], out["next_inputs"]


def _finish_rows(emitted, done, t, eos_ids, budget):
    """``done`` after a step that emitted ``emitted`` at iteration ``t``: a
    row finishes on one of its EOS ids or when its budget (> 0) is used up;
    the finishing token itself is emitted."""
    if eos_ids is not None:
        done = done | (emitted[:, None] == eos_ids).any(dim=1)
    if budget is not None:
        done = done | ((budget > 0) & (t + 1 >= budget))
    return done


def multi_step_token_gen(
    arch: DecoderArch,
    inv_freq,
    params: Dict[str, Any],
    cache: Dict[str, torch.Tensor],
    batch: Dict[str, torch.Tensor],
    *,
    num_steps: int,
    kv_window: Optional[int] = None,
    layout=DEFAULT_KV_LAYOUT,
    do_sample: bool = False,
    global_topk: int = 256,
    deterministic: bool = False,
    return_next_inputs: bool = True,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """K decode steps in one forward (the ``tkg_multistep`` submodel; the JAX
    package's ``lax.scan``, unrolled): each step samples, and its token,
    position and key feed the next exactly as chained 1-step dispatches
    would. ``batch`` may carry ``eos_token_ids`` (B, E) (-1 unused),
    ``pad_token_id`` (B,) and ``budget_steps`` (B,) (<= 0 unlimited): a row
    that emitted an EOS id or its budget-th token emits the pad token from
    then on and freezes (position pinned, writes dropped). Returns outputs
    with ``tokens`` (B, K) and ``next_inputs`` (the next window's step inputs
    and the passthrough inputs)."""
    eos_ids, budget = batch.get("eos_token_ids"), batch.get("budget_steps")
    pad = batch.get("pad_token_id")
    passthrough = {k: batch[k] for k in _MULTISTEP_PASSTHROUGH_KEYS if k in batch}
    sbatch = {k: batch[k] for k in _MULTISTEP_CHAIN_KEYS}
    if "rng" in batch:
        sbatch["rng"] = batch["rng"]
    sampling = dict(do_sample=do_sample, global_topk=global_topk, deterministic=deterministic)
    B = sbatch["input_ids"].shape[0]
    done = torch.zeros((B,), dtype=torch.bool, device=sbatch["input_ids"].device)
    toks = []
    for t in range(num_steps):
        tok, nxt = _decode_step(arch, inv_freq, params, cache, {**passthrough, **sbatch}, done,
                                kv_window=kv_window, layout=layout, sampling=sampling)
        if eos_ids is not None:
            emitted = torch.where(done, pad.to(tok.dtype) if pad is not None
                                  else torch.zeros_like(tok), tok)
        else:
            emitted = tok
        done = _finish_rows(emitted, done, t, eos_ids, budget)
        toks.append(emitted)
        sbatch = {
            "input_ids": emitted[:, None].to(torch.int32),
            "position_ids": torch.where(done[:, None], sbatch["position_ids"],
                                        nxt["position_ids"]),
            "last_token_index": nxt["last_token_index"],
            "sampling_params": nxt["sampling_params"],
            **({"rng": nxt["rng"]} if "rng" in sbatch else {}),
        }
    outputs: Dict[str, Any] = {"tokens": torch.stack(toks, dim=1)}
    if return_next_inputs:
        outputs["next_inputs"] = {**sbatch, **passthrough}
    return outputs, cache


def device_loop_state(batch: Dict[str, torch.Tensor], max_steps: int) -> Dict[str, torch.Tensor]:
    """A fresh loop state for ``batch`` (the wrapper stages it with the
    inputs, so a window graph reads and updates it in place): iteration 0,
    no row done, the token buffer (B, max_steps) pad-filled and its
    per-iteration done history."""
    ids = batch["input_ids"]
    B, dev = ids.shape[0], ids.device
    pad = batch.get("pad_token_id")
    pad = torch.zeros((B,), dtype=torch.int32, device=dev) if pad is None else pad
    return {
        "loop_t": torch.zeros((), dtype=torch.int32, device=dev),
        "loop_done": torch.zeros((B,), dtype=torch.bool, device=dev),
        "loop_tokens": pad.to(torch.int32)[:, None].expand(B, max_steps).clone(),
        "loop_done_hist": torch.zeros((B, max_steps), dtype=torch.bool, device=dev),
    }


def device_loop_iteration(arch, inv_freq, params, cache, batch, *, kv_window=None,
                          layout=DEFAULT_KV_LAYOUT, do_sample=False, global_topk=256,
                          deterministic=False) -> None:
    """One iteration of the device loop, IN PLACE on the batch's loop state
    (:func:`device_loop_state`) and step inputs: iteration t draws with key
    ``rng + (0, t)`` (the host schedule's ``(seed, counter + t)``), writes its
    emitted tokens into column t, and advances t. Fixed shapes and no host
    read, so it is captured once as the body of the loop's window graph."""
    t, done, toks = batch["loop_t"], batch["loop_done"], batch["loop_tokens"]
    B = toks.shape[0]
    pad = batch.get("pad_token_id")
    pad = torch.zeros((B,), dtype=torch.int32, device=toks.device) if pad is None else pad
    step = {k: batch[k] for k in (*_MULTISTEP_PASSTHROUGH_KEYS, *_MULTISTEP_CHAIN_KEYS)
            if k in batch}
    if "rng" in batch:
        step["rng"] = batch["rng"] + torch.stack([torch.zeros_like(t), t]).to(batch["rng"].dtype)
    sampling = dict(do_sample=do_sample, global_topk=global_topk, deterministic=deterministic)
    tok, nxt = _decode_step(arch, inv_freq, params, cache, step, done, kv_window=kv_window,
                            layout=layout, sampling=sampling)
    emitted = torch.where(done, pad.to(tok.dtype), tok).to(torch.int32)
    new_done = _finish_rows(emitted, done, t, batch.get("eos_token_ids"),
                            batch.get("budget_steps"))
    col = t.reshape(1).long()
    toks.index_copy_(1, col, emitted[:, None])
    batch["loop_done_hist"].index_copy_(1, col, new_done[:, None])
    batch["position_ids"].copy_(torch.where(new_done[:, None], batch["position_ids"],
                                            nxt["position_ids"]))
    batch["input_ids"].copy_(emitted[:, None])
    batch["last_token_index"].copy_(nxt["last_token_index"])
    done.copy_(new_done)
    t.add_(1)


def device_loop_token_gen(
    arch: DecoderArch,
    inv_freq,
    params: Dict[str, Any],
    cache: Dict[str, torch.Tensor],
    batch: Dict[str, torch.Tensor],
    *,
    max_steps: int,
    kv_window: Optional[int] = None,
    layout=DEFAULT_KV_LAYOUT,
    do_sample: bool = False,
    global_topk: int = 256,
    deterministic: bool = False,
    outfeed=None,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """The ``tkg_device_loop`` submodel run eagerly: iterations of
    :func:`device_loop_iteration` until every row is done (EOS id or budget,
    as in :func:`multi_step_token_gen`) or ``max_steps`` (the token buffer's
    width) is reached. ``batch`` is updated in place (its step inputs and,
    when it carries them, its loop state). ``outfeed(t, tokens, done)`` is
    called after each iteration when given. Returns outputs with ``tokens``
    (B, max_steps), pad past each row's halt, and ``loop_iters`` (a 0-d
    tensor). On the card the wrapper runs the same iteration as a captured
    graph behind IF nodes (``runtime/model_wrapper.DeviceLoopTKGWrapper``)."""
    if "loop_t" not in batch:
        batch = {**batch, **device_loop_state(batch, max_steps)}
    kw = dict(kv_window=kv_window, layout=layout, do_sample=do_sample,
              global_topk=global_topk, deterministic=deterministic)
    while int(batch["loop_t"]) < max_steps and not bool(batch["loop_done"].all()):
        device_loop_iteration(arch, inv_freq, params, cache, batch, **kw)
        if outfeed is not None:
            t = int(batch["loop_t"]) - 1
            outfeed(t, batch["loop_tokens"][:, t].clone(), batch["loop_done"].clone())
    return {"tokens": batch["loop_tokens"], "loop_iters": batch["loop_t"]}, cache
