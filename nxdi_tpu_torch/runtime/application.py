"""Application lifecycle: load -> forward (counterpart of
``nxdi_tpu/runtime/application.py``'s ``TpuModelForCausalLM``).

``TorchModelForCausalLM`` owns the params (a layer-stacked dict of tensors
on its device), the KV cache (contiguous, or the paged pool under
``is_block_kv_layout``), and one :class:`ModelWrapper` per submodel.
It runs on the card unless the caller asks for the CPU: with no ``device``
it uses ``"cuda"`` and raises when no GPU is present. On the card every
bucket of every submodel runs as a CUDA graph, all in one memory pool
(``graphs=False`` runs them eagerly instead: for side-by-side runs and
debugging). Under ``async_mode`` with on-device sampling the context and
token-generation forwards emit the next step's inputs on the device, and
:meth:`token_gen_device` dispatches from them (the JAX package's
device-resident decode loop). ``decode_steps_per_dispatch > 1`` adds the
``tkg_multistep`` submodel (K steps per dispatch, :meth:`token_gen_multistep`
and, chained on the device, :meth:`token_gen_multistep_device`);
``device_loop`` adds ``tkg_device_loop`` (:meth:`token_gen_device_loop`).

Weight quantization (``quantized``): the converted params are quantized on
the host before they move to the device (:func:`maybe_quantize_params`), or
loaded pre-quantized from ``quantized_checkpoints_path``
(:meth:`save_quantized_state_dict` writes one). A quantized KV cache
(``kv_cache_quant`` / ``kv_quant_config``) allocates its store in the one-byte
dtype. ``role="decode"`` builds no context-encoding or prefix-prefill
submodel: its requests arrive as imported KV chains (``serving/handoff.py``).

Multi-adapter LoRA (``lora_config``): :meth:`load` adds the zeroed adapter
slots to the params on the device (``lora/serving.py``) and loads the
config's ``lora_ckpt_paths``; :meth:`set_lora_adapter` makes an adapter
resident, writing its weights into a slot in place (so graphs captured
before keep serving, with the new weights), and returns the id that
``generate(adapter_ids=...)`` takes.

Window-sized KV (``window_sized_kv``): a model whose every layer slides
keeps a ring of ``window_ring_slots`` slots per layer in place of seq_len;
an interleaved one (full and sliding-window layers) keeps full-length
``k`` / ``v`` for its full layers only and a ring stack ``k_win`` /
``v_win`` for its window layers (:meth:`init_cache`).

Speculation (``nxdi_tpu_torch/speculation/``) subclasses this app: params
and caches may be nested dicts (``{"draft": ..., "target": ...}``; Medusa's
``medusa_heads`` and ``medusa_tokens``), which :meth:`load` moves, allocates
(:meth:`init_cache`), warms up and captures as it does a flat one.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from nxdi_tpu_torch import checkpoint as ckpt
from nxdi_tpu_torch.config import InferenceConfig
from nxdi_tpu_torch.kvcache.kv_cache import BlockKVCacheSpec, init_kv_cache, reset_kv_cache
from nxdi_tpu_torch.ops import quantization as quant_ops
from nxdi_tpu_torch.runtime import autobucketing
from nxdi_tpu_torch.runtime.device import resolve_device
from nxdi_tpu_torch.runtime.host_spans import span
from nxdi_tpu_torch.runtime.model_wrapper import (
    TAG_CONTEXT_ENCODING,
    TAG_DEVICE_LOOP,
    TAG_MIXED,
    TAG_TOKEN_GENERATION,
    TAG_TOKEN_GENERATION_MULTISTEP,
    DeviceLoopTKGWrapper,
    MixedModelWrapper,
    ModelWrapper,
    MultiStepTKGWrapper,
)

# multi-token prefill that attends the cache (prefix-cached or chunked
# prefill on the paged pool)
TAG_PREFIX_PREFILL = "prefix_prefill_model"


def maybe_quantize_params(params, tc):
    """Weight quantization per the config (a no-op unless ``quantized``):
    every linear of the CPU params tree, as the JAX package's
    ``maybe_quantize_params``."""
    if not tc.quantized:
        return params
    return quant_ops.quantize_params(
        params,
        quant_dtype=tc.quantization_dtype,
        scheme=tc.quantization_type,
        modules_to_not_convert=tc.modules_to_not_convert,
        static_input_scales=tc.activation_quantization_type == "static",
    )


QUANTIZED_CHECKPOINT = "model.safetensors"


def _to_device(tree, device):
    if isinstance(tree, list):  # a segmented stack's layers
        return [_to_device(v, device) for v in tree]
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


# a segmented layer stack (DeepSeek's dense head + MoE tail: a list of
# segments in params["layers"]) is not served with these yet
SEGMENTED_REFUSALS = {
    "lora_config": (
        "LoRA serving on a segmented layer stack (first_k_dense_replace dense layers "
        "before MoE layers) is not ported: the JAX package attaches no adapter buffer to "
        "such a stack (ROADMAP Queue 3)"),
    "quantized": (
        "weight quantization of a segmented layer stack (first_k_dense_replace dense "
        "layers before MoE layers) is not ported: the JAX package's quantizer passes "
        "such a stack through (ROADMAP Queue 3)"),
}


# the MoE families' switches that the MoE branch carries,
# each held on an MoE family against the JAX package or HF
# (tests/test_torch_moe_families.py), and the dense families' switches those
# families share
MOE_CARRIED = ("sliding_window", "qk_norm", "qk_norm_flat", "embed_scale", "attention_o_bias",
               "layernorm", "clip_qkv", "rotary_dim", "attention_sink", "attn_out_gate",
               "sandwich_norm", "longrope", "rope_interleaved", "qk_l2norm", "chunk_size",
               "attn_temperature_tuning")


def family_switches(arch) -> List[str]:
    """The switches of the dense Llama-lineage and MoE families
    (``DecoderArch``'s fields past the Llama set) that ``arch`` turns on, by
    name."""
    return [name for name, on in (
        ("qk_norm", arch.qk_norm),
        ("qk_norm_flat", arch.qk_norm_flat),
        ("sliding_window", arch.sliding_window is not None),
        ("attention_scale", arch.attention_scale is not None),
        ("gemma_norm", arch.gemma_norm),
        ("embed_scale", arch.embed_scale is not None),
        ("gated_mlp=False", not arch.gated_mlp),
        ("attention_o_bias", arch.attention_o_bias),
        ("rope_interleaved", arch.rope_interleaved),
        ("post_block_norm", arch.post_block_norm),
        ("residual_multiplier", arch.residual_multiplier != 1.0),
        ("logits_scaling", arch.logits_scaling != 1.0),
        (f"hidden_act={arch.hidden_act!r}", arch.hidden_act not in ("silu", "xielu")),
        ("layernorm", arch.layernorm),
        ("clip_qkv", arch.clip_qkv is not None),
        ("rotary_dim", arch.rotary_dim is not None),
        ("attention_sink", arch.attention_sink),
        ("attn_out_gate", arch.attn_out_gate),
        ("sandwich_norm", arch.sandwich_norm),
        ("longrope", arch.longrope_original_max is not None),
        ("attn_logit_softcap", arch.attn_logit_softcap is not None),
        ("final_logit_softcap", arch.final_logit_softcap is not None),
        ("chunk_size", arch.chunk_size is not None),
        ("qk_l2norm", arch.qk_l2norm),
        ("attn_temperature_tuning", arch.attn_temperature_tuning),
        ("parallel_block", arch.parallel_block),
        ("learned_pos_embeds", arch.learned_pos_embeds),
        ("no_rope", arch.no_rope),
        ("lm_head_bias", arch.lm_head_bias),
        ("xielu", arch.hidden_act == "xielu"),
    ) if on]


def local_rope(family, config) -> bool:
    """Whether the family's rope table is Gemma-3's [global, local] pair
    (picked per layer by the ``use_local_rope`` flags; LongRoPE's pair is
    the ``longrope`` switch)."""
    table = getattr(family, "build_inv_freq", None)
    return (table is not None and family.build_arch(config).longrope_original_max is None
            and np.ndim(table(config)) == 2)


def _refuse_switches(switches: List[str], path: str) -> None:
    if switches:
        raise NotImplementedError(
            f"{path} with this family's {', '.join(switches)} is not ported yet (ROADMAP "
            "Queue 1): that path does not carry these switches")


def refuse_speculation(target_arch, tree: bool) -> None:
    """What speculation still refuses at app build, beyond what ``config.py``
    refuses (a ring under Medusa, paged or prefix modes; the fused window on
    the block layout; a quantized checkpoint path): a token tree (EAGLE's
    static or dynamic tree, Medusa's) on a target with a sliding window or
    an attention chunk. The tree verify attends under its explicit ancestor
    mask, which carries no position window; the JAX package's Medusa refuses
    such trees for that cause, and its EAGLE tree drops the window (ROADMAP
    Queue 3). A ring needs a windowed target, so a tree never rides one."""
    if tree and (target_arch.sliding_window is not None or target_arch.chunk_size is not None):
        what = ("sliding_window" if target_arch.sliding_window is not None else "chunk_size")
        raise NotImplementedError(
            f"token-tree speculation on a target with {what} is not ported yet (ROADMAP "
            "Queue 1): the tree verify's explicit ancestor mask carries no position "
            "window or chunk; use a chain (no token tree)")


def refuse_unported(family, config) -> None:
    """Raise at app build for what the port does not serve on this model yet
    (:data:`SEGMENTED_REFUSALS`; the family switches on the paths that do
    not carry them: MoE routing but for :data:`MOE_CARRIED`, and MLA). LoRA
    serving, quantized KV stores and the mixed step carry every switch, as
    in the JAX package, which refuses only what ``config.py`` refuses here
    too (LoRA under ``fused_qkv``, per-key / per-channel KV scales on a
    paged or ring layout)."""
    tc = config.tpu_config
    arch = family.build_arch(config)
    switches = family_switches(arch) + (["use_local_rope"] if local_rope(family, config) else [])
    for path, on, refused in (
        ("mixture-of-experts routing", arch.moe is not None,
         [s for s in switches if s not in MOE_CARRIED]),
        ("MLA attention", arch.mla is not None, switches),
    ):
        if on:
            _refuse_switches(refused, path)
    seg = getattr(family, "segmented", None)
    if seg is None or not seg(config):
        return
    for key, msg in SEGMENTED_REFUSALS.items():
        if getattr(tc, key, None):
            raise NotImplementedError(msg)


class TorchModelForCausalLM:
    """CausalLM application: CTE + TKG submodels, host-side dispatch."""

    _model_cls = None

    def __init__(self, model_path: str, config: InferenceConfig, model_family=None, device=None,
                 graphs: bool = True):
        self.device = resolve_device(device)
        self.graphs = graphs
        # every graph of this app, in one pool (made at load on the card)
        self.graph_pool = None
        self.model_path = model_path
        self.config = config
        self.tpu_config = config.tpu_config
        self.family = model_family or self._model_cls
        if self.family is None:
            raise ValueError("No model family bound to this application")
        self.models: Dict[str, ModelWrapper] = {}
        self.params: Optional[Dict[str, Any]] = None
        self.kv_cache: Optional[Dict[str, torch.Tensor]] = None
        self.adapter_cache = None  # lora.AdapterCache under lora_config
        self.is_loaded = False

    def get_state_dict(self) -> Dict[str, Any]:
        return ckpt.load_state_dict(self.model_path)

    def build_params(self) -> Dict[str, Any]:
        """Params dict on the CPU (subclasses may return tensors already on
        the device): the converted checkpoint, quantized when configured, or
        a pre-quantized artifact from ``quantized_checkpoints_path``
        (checked against the configured scheme)."""
        tc = self.tpu_config
        if tc.quantized and tc.quantized_checkpoints_path:
            if not os.path.isdir(tc.quantized_checkpoints_path):
                raise FileNotFoundError(
                    f"quantized_checkpoints_path={tc.quantized_checkpoints_path!r}"
                    " does not exist; run save_quantized_state_dict first or"
                    " unset it to quantize online from the HF checkpoint"
                )
            params = quant_ops.unflatten_params(
                ckpt.load_state_dict(tc.quantized_checkpoints_path))
            quant_ops.validate_quantized_params(params, tc)
            return params
        params = self.family.convert_hf_state_dict(self.get_state_dict(), self.config)
        return maybe_quantize_params(params, tc)

    def save_quantized_state_dict(self, path: str) -> None:
        """Write the quantized params as a flat safetensors file under
        ``path``, for reload through ``quantized_checkpoints_path``. A loaded
        app saves its params as they are (calibrated static input scales
        included)."""
        from safetensors.torch import save_file

        if self.is_loaded:
            qparams = self.params
        else:
            params = self.family.convert_hf_state_dict(self.get_state_dict(), self.config)
            qparams = maybe_quantize_params(params, self.tpu_config)
        flat = {k: v.detach().to("cpu").contiguous()
                for k, v in quant_ops.flatten_params(qparams).items()}
        os.makedirs(path, exist_ok=True)
        save_file(flat, os.path.join(path, QUANTIZED_CHECKPOINT))

    def refuse_unported(self) -> None:
        """What the port does not serve on this model yet (a family app with
        its own layer walk keeps its own list)."""
        refuse_unported(self.family, self.config)

    def enable_models(self) -> None:
        arch = self.family.build_arch(self.config)
        self.refuse_unported()
        inv_freq = self.family.build_inv_freq(self.config)
        tc = self.tpu_config
        odsc = tc.on_device_sampling_config
        sampling = dict(
            do_sample=bool(odsc and odsc.do_sample),
            global_topk=odsc.global_topk if odsc else 256,
            deterministic=bool(odsc and odsc.deterministic),
        )
        fwd = dict(output_logits=tc.output_logits, on_device_sampling=odsc is not None,
                   **sampling)
        # the device-resident loops: each step emits the next step's inputs
        # (only meaningful with on-device sampling); K-step windows chain off
        # the context encoding's the same way
        nxt = dict(return_next_inputs=bool(
            (tc.async_mode or tc.decode_steps_per_dispatch > 1) and odsc is not None))
        # a decode-role app never prefills locally: its requests arrive as
        # imported KV chains, so no context-encoding ladder is built
        decode_role = tc.role == "decode"
        if not decode_role:
            self.models[TAG_CONTEXT_ENCODING] = ModelWrapper(
                TAG_CONTEXT_ENCODING, self.config, arch, inv_freq,
                batch_size=tc.ctx_batch_size, n_active_tokens=0,
                buckets=autobucketing.context_encoding_buckets(self.config),
                attend_to_cache=False, device=self.device,
                forward_kwargs=dict(gather_last_token=True, **fwd, **nxt),
            )
        self.models[TAG_TOKEN_GENERATION] = ModelWrapper(
            TAG_TOKEN_GENERATION, self.config, arch, inv_freq,
            batch_size=tc.tkg_batch_size, n_active_tokens=1,
            buckets=autobucketing.token_generation_buckets(self.config),
            attend_to_cache=True, device=self.device,
            forward_kwargs=dict(gather_last_token=False, **fwd, **nxt),
        )
        if tc.decode_steps_per_dispatch > 1:
            # K chained decode steps per dispatch; the 1-step submodel stays
            # (the host path for logits processors and > 8 EOS ids)
            self.models[TAG_TOKEN_GENERATION_MULTISTEP] = MultiStepTKGWrapper(
                TAG_TOKEN_GENERATION_MULTISTEP, self.config, arch, inv_freq,
                batch_size=tc.tkg_batch_size, n_active_tokens=1,
                buckets=autobucketing.token_generation_buckets(self.config),
                attend_to_cache=True, device=self.device,
                steps_ladder=autobucketing.multistep_step_ladder(tc.decode_steps_per_dispatch),
                forward_kwargs=sampling,
            )
        if tc.device_loop:
            # the resident loop: per-row EOS and budget exit on the card
            self.models[TAG_DEVICE_LOOP] = DeviceLoopTKGWrapper(
                TAG_DEVICE_LOOP, self.config, arch, inv_freq,
                batch_size=tc.tkg_batch_size, n_active_tokens=1,
                buckets=autobucketing.token_generation_buckets(self.config),
                attend_to_cache=True, device=self.device,
                cap_ladder=autobucketing.device_loop_budget_ladder(
                    tc.device_loop_fence or tc.seq_len),
                outfeed_enabled=tc.device_loop_outfeed,
                forward_kwargs=sampling,
            )
        if (tc.is_prefix_caching or tc.is_chunked_prefill) and not decode_role:
            # the new chunk sees the cached prefix through the block table
            self.models[TAG_PREFIX_PREFILL] = ModelWrapper(
                TAG_PREFIX_PREFILL, self.config, arch, inv_freq,
                batch_size=tc.ctx_batch_size, n_active_tokens=0,
                buckets=autobucketing.prefix_prefill_buckets(self.config),
                attend_to_cache=True, prefill_to_cache=True, device=self.device,
                forward_kwargs=dict(gather_last_token=True, **fwd),
            )
        if tc.mixed_dispatch:
            # one forward per total-packed-token bucket serves a whole
            # serving step: prefill chunks and decode tokens in one stream
            self.models[TAG_MIXED] = MixedModelWrapper(
                TAG_MIXED, self.config, arch, inv_freq,
                batch_size=1, n_active_tokens=0,
                buckets=autobucketing.mixed_token_buckets(self.config),
                attend_to_cache=True, prefill_to_cache=True, device=self.device,
                num_rows=tc.tkg_batch_size,
                forward_kwargs=dict(gather_last_token=True, mixed_rows=True, **fwd),
            )

        for w in self.models.values():
            w.graphs = self.graphs

    @property
    def mixed_supported(self) -> bool:
        return TAG_MIXED in self.models

    @property
    def multistep_supported(self) -> bool:
        return TAG_TOKEN_GENERATION_MULTISTEP in self.models

    @property
    def device_loop_supported(self) -> bool:
        return TAG_DEVICE_LOOP in self.models

    @property
    def async_supported(self) -> bool:
        """The JAX package's rule: async_mode, on-device sampling, and one
        batch size for context encoding and token generation."""
        tc = self.tpu_config
        return (
            tc.async_mode
            and tc.on_device_sampling_config is not None
            and tc.ctx_batch_size == tc.tkg_batch_size
        )

    def _cache_spec(self, family=None, config=None):
        """The cache of this app's model, or of ``family`` / ``config`` (a
        speculation app's draft), by that config's own flags."""
        config = config or self.config
        arch = (family or self.family).build_arch(config)
        tc = config.tpu_config
        if tc.is_block_kv_layout:
            # one block past those the block manager hands out: the drop
            # target of the fixed-length paged writes (kv_cache.drop_slot)
            return BlockKVCacheSpec(
                num_layers=arch.num_layers, num_blocks=tc.pa_num_blocks + 1,
                block_size=tc.pa_block_size, num_kv_heads=arch.num_kv_heads,
                head_dim=arch.head_dim, dtype=arch.dtype, quant_dtype=arch.kv_quant_dtype,
            )
        max_len = tc.seq_len
        split = arch.interleaved_split() if tc.window_sized_kv else None
        if tc.window_sized_kv and split is None:
            # the homogeneous ring: W (+ the speculation lookahead) slots a
            # layer in place of the full budget
            max_len = min(max_len, tc.window_ring_slots)
        spec = arch.kv_cache_spec(tc.kv_cache_batch_size + tc.kv_cache_padding_size, max_len)
        # an interleaved split: this spec covers the full-attention layers
        # only; the window layers live in the ring stack (_ring_cache_spec)
        return spec if split is None else dataclasses.replace(spec, num_layers=split[0])

    def _ring_cache_spec(self, family=None, config=None):
        """The ring stack's spec of an interleaved split's window layers
        (the JAX package's ``_ring_cache_spec``), else None."""
        config = config or self.config
        tc = config.tpu_config
        arch = (family or self.family).build_arch(config)
        split = arch.interleaved_split() if tc.window_sized_kv else None
        if split is None:
            return None
        return dataclasses.replace(self._cache_spec(family, config), num_layers=split[1],
                                   max_len=min(tc.window_ring_slots, tc.seq_len))

    def load(self) -> None:
        """Weights to the device, KV cache allocated, every bucket run once
        (unless ``skip_warmup``)."""
        if not self.models:
            self.enable_models()
        self.params = _to_device(self.build_params(), self.device)
        if self.tpu_config.lora_config is not None:
            self.params = self._attach_lora(self.params)
        self.kv_cache = self.init_cache()
        if self.device.type == "cuda" and self.graphs:
            self.graph_pool = torch.cuda.graph_pool_handle()
            for w in self.models.values():
                w.graph_pool = self.graph_pool
        if not self.tpu_config.skip_warmup:
            self.warmup()
        self.is_loaded = True

    # -- LoRA serving --
    def _attach_lora(self, params):
        """The adapter slots added to the device params, and the config's
        adapters loaded into them."""
        from nxdi_tpu_torch.lora import AdapterCache, attach_lora_buffers

        arch = self.family.build_arch(self.config)
        lc = self.tpu_config.lora_config
        params = attach_lora_buffers(params, arch, lc, device=self.device)
        self.adapter_cache = AdapterCache(self.config, arch, lc)
        for name, path in (lc.lora_ckpt_paths or {}).items():
            self.adapter_cache.register(name, path)
            _, params = self.adapter_cache.ensure(name, params)
        return params

    def set_lora_adapter(self, name: str, path_or_sd=None, adapter_cfg=None) -> int:
        """Make adapter ``name`` resident on the device (registering it from
        ``path_or_sd`` when given; LRU eviction when the slots are full) and
        return its adapter id for ``generate(adapter_ids=...)``."""
        if self.adapter_cache is None:
            raise RuntimeError("LoRA serving is not enabled (set lora_config)")
        if path_or_sd is not None:
            self.adapter_cache.register(name, path_or_sd, adapter_cfg)
        slot, self.params = self.adapter_cache.ensure(name, self.params)
        return slot

    def lora_adapter_id(self, name: Optional[str]) -> int:
        """Adapter id of a resident adapter (``None``: 0, the base model)."""
        if name is None:
            return 0
        return self.adapter_cache.slot_of[name]

    def model_cache(self, family=None, config=None) -> Dict[str, torch.Tensor]:
        """The zeroed KV cache of this app's model, or of ``family`` /
        ``config`` (a speculation app's draft), by that config's own flags:
        an interleaved window-sized split carries the ring stack ``k_win`` /
        ``v_win`` beside the full layers' ``k`` / ``v``."""
        cache = init_kv_cache(self._cache_spec(family, config), self.device)
        ring = self._ring_cache_spec(family, config)
        if ring is not None:
            win = init_kv_cache(ring, self.device)
            cache["k_win"], cache["v_win"] = win["k"], win["v"]
        return cache

    def init_cache(self) -> Dict[str, Any]:
        """The zeroed KV cache on the app's device (a speculation app's holds
        both models' caches, or Medusa's proposal buffer beside the K/V)."""
        return self.model_cache()

    def warmup(self) -> float:
        """One dispatch per bucket of every submodel (on the card: its eager
        run, then its graph's capture). Returns the seconds taken."""
        t0 = time.perf_counter()
        for wrapper in self.models.values():
            for batch in wrapper.warmup_batches():
                wrapper.forward(self.params, self.kv_cache, batch)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter() - t0

    def reset_kv_cache(self) -> None:
        reset_kv_cache(self.kv_cache)

    def forward(self, input_ids: np.ndarray, position_ids: np.ndarray,
                submodel: Optional[str] = None, **kwargs):
        if not self.is_loaded:
            raise RuntimeError("call load() before forward()")
        if submodel is None:
            is_prefill = input_ids.shape[1] > 1
            # a prefill whose first position is nonzero continues a context
            if is_prefill and TAG_PREFIX_PREFILL in self.models and position_ids[:, 0].max() > 0:
                submodel = TAG_PREFIX_PREFILL
            else:
                submodel = TAG_CONTEXT_ENCODING if is_prefill else TAG_TOKEN_GENERATION
        if submodel not in self.models:
            raise KeyError(f"submodel {submodel!r} is not built in this app (role="
                           f"{self.tpu_config.role!r}, available: {sorted(self.models)})")
        batch = {"input_ids": input_ids, "position_ids": position_ids, **kwargs}
        with span("dispatch"):
            outputs, self.kv_cache = self.models[submodel].forward(
                self.params, self.kv_cache, batch)
        return outputs

    def token_gen_device(self, device_batch, total_len: int):
        """The async hot path: a token-generation step from inputs already on
        the device (the previous step's ``next_inputs``); ``total_len``
        (host-tracked) picks the bucket. Nothing syncs. The outputs live in
        the graph pool: copy what must outlive the next dispatch."""
        with span("dispatch"):
            outputs, self.kv_cache = self.models[TAG_TOKEN_GENERATION].forward_device(
                self.params, self.kv_cache, device_batch, total_len
            )
        return outputs

    def token_gen_multistep(self, batch_np):
        """A K-step window from host inputs (``decode_steps`` picks the rung);
        outputs carry ``tokens`` (b, K)."""
        with span("dispatch"):
            outputs, self.kv_cache = self.models[TAG_TOKEN_GENERATION_MULTISTEP].forward(
                self.params, self.kv_cache, batch_np)
        return outputs

    def token_gen_multistep_device(self, device_batch, total_len: int, steps=None):
        """A K-step window chained on the device from the previous window's
        (or the context encoding's) ``next_inputs``; nothing syncs."""
        with span("dispatch"):
            outputs, self.kv_cache = self.models[TAG_TOKEN_GENERATION_MULTISTEP].forward_device(
                self.params, self.kv_cache, device_batch, total_len, steps=steps)
        return outputs

    def token_gen_device_loop(self, batch_np):
        """One device-loop launch: every row decodes to its EOS or budget (or
        the cap); outputs carry ``tokens`` (b, cap) and ``loop_iters``."""
        with span("dispatch"):
            outputs, self.kv_cache = self.models[TAG_DEVICE_LOOP].forward(
                self.params, self.kv_cache, batch_np)
        return outputs
