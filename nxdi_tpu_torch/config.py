"""Configuration for the PyTorch/CUDA port — the subset of
``nxdi_tpu.config`` that the Llama greedy ``generate()`` path and the paged
serving engine read.

Two levels, as in the JAX package:

- :class:`TorchConfig` — runtime flags (shapes, buckets, dtype, sampling,
  attention-kernel gates). Field names and JSON keys are identical to the
  JAX package's ``TpuConfig``, so one saved config means the same thing to
  both packages; every key written here is one ``TpuConfig`` accepts.
- :class:`InferenceConfig` — model hyperparameters (typically a HF
  ``config.json``) plus a ``tpu_config`` attribute.

Features the port does not carry yet (tensor and expert parallelism:
``moe_tp_degree``, ``moe_ep_degree``, ``hybrid_sharding_config``, ...) are
not keys here: passing one raises, naming it. Multi-adapter LoRA serving
(``lora_config``) and the MoE dispatch (``moe_dispatch``) are.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List

import numpy as np
import torch

CONFIG_FILE = "tpu_config.json"

_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float16": torch.float16,
    # the one-byte KV stores and weights (the JAX package's names)
    "float8_e4m3": torch.float8_e4m3fn,
    "float8_e5m2": torch.float8_e5m2,
    "int8": torch.int8,
}
# torch's own names of the fp8 dtypes
_ALIASES = {"float8_e4m3fn": "float8_e4m3"}


def to_torch_dtype(dtype) -> torch.dtype:
    """Map a dtype name (``"bfloat16"``, ``"torch.float32"``) or a torch dtype
    to a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    key = str(dtype).replace("torch.", "")
    key = _ALIASES.get(key, key)
    if key not in _DTYPES:
        raise ValueError(f"Unsupported dtype {dtype!r}; options: {sorted(_DTYPES)}")
    return _DTYPES[key]


def dtype_name(dtype) -> str:
    """The JAX package's name of a dtype (``float8_e4m3`` for torch's
    ``float8_e4m3fn``)."""
    key = str(to_torch_dtype(dtype)).replace("torch.", "")
    return _ALIASES.get(key, key)


class OnDeviceSamplingConfig:
    """Sampling flags (same keys as the JAX package): ``do_sample`` builds the
    sampler into every forward (ops/sampling.py), ``global_topk`` bounds its
    candidates, ``deterministic`` draws u = 0.5."""

    def __init__(self, **kwargs):
        self.do_sample = kwargs.pop("do_sample", False)
        self.top_k = kwargs.pop("top_k", 1)
        self.top_p = kwargs.pop("top_p", 1.0)
        self.temperature = kwargs.pop("temperature", 1.0)
        self.dynamic = kwargs.pop("dynamic", True)
        self.global_topk = kwargs.pop("global_topk", 256)
        self.deterministic = kwargs.pop("deterministic", False)
        self.on_device_sampling_seed = kwargs.pop("on_device_sampling_seed", 0)
        self.dp_sampling = kwargs.pop("dp_sampling", False)
        if kwargs:
            raise ValueError(f"Unknown OnDeviceSamplingConfig args: {sorted(kwargs)}")

    def to_dict(self):
        return dict(self.__dict__)


class KVQuantizationConfig:
    """KV-cache quantization (the JAX package's ``KVQuantizationConfig``, its
    keys and rules): the store ``dtype`` (``float8_e4m3``, ``float8_e5m2``
    or ``int8``) and how values are scaled before the store —
    ``direct_cast`` (no scale), ``per_tensor`` (static ``k_scale`` /
    ``v_scale``), ``per_key`` ((L, KV) arrays) or ``per_channel`` ((L, D)
    arrays), the arrays given or loaded from ``scales_path`` (an .npz with
    ``k_scales`` / ``v_scales``, ``kvcache.calibration.save_kv_scales``)."""

    def __init__(self, **kwargs):
        self.dtype = kwargs.pop("dtype", "float8_e4m3")
        self.scale_mode = kwargs.pop("scale_mode", "direct_cast")
        self.k_scale = float(kwargs.pop("k_scale", 1.0))
        self.v_scale = float(kwargs.pop("v_scale", 1.0))
        self.scales_path = kwargs.pop("scales_path", None)
        k_scales = kwargs.pop("k_scales", None)
        v_scales = kwargs.pop("v_scales", None)
        if self.scales_path is not None and k_scales is None:
            with np.load(self.scales_path) as z:
                k_scales = z["k_scales"]
                v_scales = z["v_scales"]
        if k_scales is not None:
            k_scales = np.asarray(k_scales, dtype=np.float32)
            v_scales = np.asarray(v_scales, dtype=np.float32)
        self.k_scales = k_scales
        self.v_scales = v_scales
        if k_scales is not None and self.scale_mode == "per_tensor":
            # calibration's per_tensor mode returns (L,) per-layer arrays;
            # the per-tensor layout takes one static scalar: their max
            self.k_scale = float(np.max(k_scales))
            self.v_scale = float(np.max(v_scales))
            self.k_scales = self.v_scales = None
        elif k_scales is not None and self.scale_mode not in ("per_key", "per_channel"):
            raise ValueError(
                "k_scales/v_scales arrays are only consumed by "
                "scale_mode='per_tensor'|'per_key'|'per_channel'; got "
                f"scale_mode={self.scale_mode!r}"
            )
        if self.scale_mode not in ("direct_cast", "per_tensor", "per_key", "per_channel"):
            raise ValueError(
                "kv quant scale_mode must be direct_cast|per_tensor|per_key|"
                f"per_channel, got {self.scale_mode!r}"
            )
        if self.scale_mode == "direct_cast" and (self.k_scale != 1.0 or self.v_scale != 1.0):
            raise ValueError("k_scale/v_scale require scale_mode='per_tensor'")
        if self.scale_mode in ("per_key", "per_channel") and self.k_scales is None:
            raise ValueError(
                f"scale_mode={self.scale_mode!r} needs k_scales/v_scales arrays "
                "(or scales_path) from calibration "
                "(nxdi_tpu_torch.kvcache.calibration.calibrate_kv_scales)"
            )
        if self.dtype not in ("float8_e4m3", "float8_e5m2", "int8"):
            raise ValueError(
                f"kv quant dtype must be float8_e4m3|float8_e5m2|int8, got {self.dtype!r}")
        if kwargs:
            raise ValueError(f"Unknown KVQuantizationConfig args: {sorted(kwargs)}")

    def to_dict(self):
        d = dict(self.__dict__)
        for key in ("k_scales", "v_scales"):
            if d.get(key) is not None:
                d[key] = np.asarray(d[key]).tolist()
        return d


class ChunkedPrefillConfig:
    """Chunked prefill over the paged KV pool (same keys as the JAX
    package's ``ChunkedPrefillConfig``): the engine prefills ``chunk_size``
    prompt tokens per step, and ``kernel_q_tile_size`` spaces the
    prefix-prefill bucket ladder."""

    def __init__(self, **kwargs):
        self.max_num_seqs = kwargs.pop("max_num_seqs", 8)
        self.chunk_size = kwargs.pop("chunk_size", 512)
        self.kernel_q_tile_size = kwargs.pop("kernel_q_tile_size", 128)
        self.kernel_kv_tile_size = kwargs.pop("kernel_kv_tile_size", 512)
        if kwargs:
            raise ValueError(f"Unknown ChunkedPrefillConfig args: {sorted(kwargs)}")

    def to_dict(self):
        return dict(self.__dict__)


class SpeculationConfig:
    """Speculative decoding knobs (the JAX package's ``SpeculationConfig``):
    ``speculation_length`` draft tokens per window, ``enable_fused_speculation``
    for the fused draft + verify window, and EAGLE's keys:
    ``enable_eagle_speculation``, ``is_eagle3`` (aux-hidden features and a
    reduced draft vocabulary), ``is_eagle_draft`` and ``token_tree_config``
    (a path list, ``{"choices": ...}`` or ``{"dynamic": {...}}``)."""

    def __init__(self, **kwargs):
        self.speculation_length = kwargs.pop("speculation_length", 0)
        self.enable_fused_speculation = kwargs.pop("enable_fused_speculation", False)
        self.enable_eagle_speculation = kwargs.pop("enable_eagle_speculation", False)
        self.is_eagle3 = kwargs.pop("is_eagle3", False)
        self.is_eagle_draft = kwargs.pop("is_eagle_draft", False)
        self.token_tree_config = kwargs.pop("token_tree_config", None)
        if kwargs:
            raise ValueError(f"Unknown SpeculationConfig args: {sorted(kwargs)}")

    def to_dict(self):
        d = dict(self.__dict__)
        if self.token_tree_config is not None and hasattr(self.token_tree_config, "to_dict"):
            d["token_tree_config"] = self.token_tree_config.to_dict()
        return d


# the JAX package's refusals of LoRA in the in-graph decode bodies
LORA_DECODE_BODY_REFUSALS = {
    "decode_steps_per_dispatch > 1": (
        "decode_steps_per_dispatch > 1 does not thread per-request "
        "adapter_ids through the in-graph decode scan yet"),
    "device_loop": (
        "device_loop does not thread per-request adapter_ids "
        "through the in-graph decode loop yet"),
}


class LoraServingConfig:
    """Multi-adapter LoRA serving (the JAX package's ``LoraServingConfig``,
    its keys): ``max_loras`` device slots besides the base slot 0, adapters
    up to ``max_lora_rank``, on ``target_modules``; ``lora_ckpt_paths``
    ({name: PEFT adapter directory}) are loaded at ``load()``."""

    def __init__(self, **kwargs):
        self.max_loras = kwargs.pop("max_loras", 1)
        self.max_lora_rank = kwargs.pop("max_lora_rank", 16)
        self.lora_ckpt_paths = kwargs.pop("lora_ckpt_paths", None)  # {adapter name: path}
        self.target_modules = kwargs.pop(
            "target_modules", ["q_proj", "k_proj", "v_proj", "o_proj"]
        )
        self.lora_dtype = kwargs.pop("lora_dtype", "bfloat16")
        self.lora_alpha = kwargs.pop("lora_alpha", 16.0)
        if kwargs:
            raise ValueError(f"Unknown LoraServingConfig args: {sorted(kwargs)}")

    def to_dict(self):
        return dict(self.__dict__)


class TorchConfig:
    """Runtime configuration; the counterpart of the JAX package's
    ``TpuConfig`` for the fields this port implements."""

    def __init__(self, **kwargs) -> None:
        # --- basic shapes ---
        self.batch_size = kwargs.pop("batch_size", 1)
        # the HF tokenizer side; validated only, as in the JAX package
        self.padding_side = kwargs.pop("padding_side", "right")
        self.seq_len = kwargs.pop("seq_len", 128)
        self.max_context_length = kwargs.pop("max_context_length", self.seq_len)
        self.output_logits = kwargs.pop("output_logits", False)

        # --- dtypes ---
        self.dtype = to_torch_dtype(kwargs.pop("dtype", kwargs.pop("torch_dtype", "bfloat16")))

        # --- quantization (the JAX package's keys) ---
        # weights: int8 / f8e4m3 / f8e5m2 (per_tensor_symmetric or
        # per_channel_symmetric) or mxfp4; ops/quantization.py
        self.quantized = kwargs.pop("quantized", False)
        self.quantized_checkpoints_path = kwargs.pop("quantized_checkpoints_path", None)
        self.quantization_dtype = kwargs.pop("quantization_dtype", "int8")
        self.quantization_type = kwargs.pop("quantization_type", "per_tensor_symmetric")
        self.modules_to_not_convert = kwargs.pop("modules_to_not_convert", None)
        kvq = kwargs.pop("kv_quant_config", None)
        if isinstance(kvq, dict):
            kvq = KVQuantizationConfig(**kvq)
        self.kv_quant_config = kvq
        self.kv_cache_quant = kwargs.pop("kv_cache_quant", False)
        if self.kv_cache_quant and self.kv_quant_config is None:
            self.kv_quant_config = KVQuantizationConfig()
        # int8 activations: "dynamic" (per-token scales on the hot path) or
        # "static" (calibrated per-tensor input scales in the params)
        self.activation_quantization_type = kwargs.pop("activation_quantization_type", None)
        if isinstance(self.activation_quantization_type, str):
            self.activation_quantization_type = self.activation_quantization_type.lower()
        self.quantize_clamp_bound = kwargs.pop("quantize_clamp_bound", None)
        if self.activation_quantization_type is not None:
            if self.activation_quantization_type not in ("dynamic", "static"):
                raise ValueError(
                    "activation_quantization_type: 'dynamic' or 'static' "
                    f"(got {self.activation_quantization_type!r})"
                )
            if not self.quantized or self.quantization_dtype != "int8":
                raise ValueError(
                    f"activation_quantization_type={self.activation_quantization_type!r} "
                    "requires quantized=True with quantization_dtype='int8' "
                    "(the int8 MXU path)"
                )

        # --- speculation (the draft-model pair, fused windows, EAGLE, Medusa) ---
        spec = kwargs.pop("speculation_config", None)
        if isinstance(spec, dict):
            spec = SpeculationConfig(**spec)
        self.speculation_config = spec
        self.speculation_length = kwargs.pop(
            "speculation_length", spec.speculation_length if spec else 0)
        self.enable_fused_speculation = kwargs.pop(
            "enable_fused_speculation", spec.enable_fused_speculation if spec else False)
        # EAGLE (speculation/eagle.py): an EAGLE draft implies the fused window
        self.enable_eagle_speculation = kwargs.pop(
            "enable_eagle_speculation", spec.enable_eagle_speculation if spec else False)
        if self.enable_eagle_speculation:
            self.enable_fused_speculation = True
        self.is_eagle3 = kwargs.pop("is_eagle3", spec.is_eagle3 if spec else False)
        self.is_eagle_draft = kwargs.pop("is_eagle_draft", False)
        # an EAGLE token tree: a path list, {"choices": ...} or {"dynamic": {...}}
        self.token_tree_config = kwargs.pop(
            "token_tree_config", spec.token_tree_config if spec else None)
        self.is_medusa = kwargs.pop("is_medusa", False)
        self.medusa_speculation_length = kwargs.pop("medusa_speculation_length", 0)
        self.num_medusa_heads = kwargs.pop("num_medusa_heads", 0)
        # Medusa token tree: the HF-medusa path list (speculation/token_tree.py)
        self.medusa_tree = kwargs.pop("medusa_tree", None)

        # --- batching ---
        self.ctx_batch_size = kwargs.pop("ctx_batch_size", self.batch_size)
        self.tkg_batch_size = kwargs.pop("tkg_batch_size", self.batch_size)
        self.max_batch_size = kwargs.pop("max_batch_size", self.batch_size)
        self.kv_cache_batch_size = kwargs.pop("kv_cache_batch_size", self.batch_size)
        self.kv_cache_padding_size = kwargs.pop("kv_cache_padding_size", 0)

        # --- paged / block KV (the serving engine's pool) ---
        self.is_block_kv_layout = kwargs.pop("is_block_kv_layout", False)
        self.pa_num_blocks = kwargs.pop("pa_num_blocks", None)
        self.pa_block_size = kwargs.pop("pa_block_size", 128)
        self.is_prefix_caching = kwargs.pop("is_prefix_caching", False)
        # one packed prefill+decode dispatch per serving step
        self.mixed_dispatch = kwargs.pop("mixed_dispatch", False)
        cpc = kwargs.pop("chunked_prefill_config", None)
        if isinstance(cpc, dict):
            cpc = ChunkedPrefillConfig(**cpc)
        self.chunked_prefill_config = cpc

        # --- sampling ---
        odsc = kwargs.pop("on_device_sampling_config", None)
        if isinstance(odsc, dict):
            odsc = OnDeviceSamplingConfig(**odsc)
        self.on_device_sampling_config = odsc

        # --- bucketing ---
        self.enable_bucketing = kwargs.pop("enable_bucketing", False)
        self.context_encoding_buckets = kwargs.pop("context_encoding_buckets", None)
        self.token_generation_buckets = kwargs.pop("token_generation_buckets", None)
        _lcm = kwargs.pop("long_context_mode", None)
        self.long_context_mode = (
            bool(_lcm) if _lcm is not None else self.seq_len >= 32 * 1024
        )

        # --- LoRA serving (lora/serving.py) ---
        lora = kwargs.pop("lora_config", None)
        if isinstance(lora, dict):
            lora = LoraServingConfig(**lora)
        self.lora_config = lora

        # --- parallelism: one device ---
        self.tp_degree = kwargs.pop("tp_degree", 1)
        # "sparse" = the routed (token, expert) pairs sorted by expert through
        # a grouped product (ops/moe.py); "dense" = every expert on every token
        self.moe_dispatch = kwargs.pop("moe_dispatch", "sparse")
        if self.moe_dispatch not in ("sparse", "dense"):
            raise ValueError(
                f"moe_dispatch must be 'sparse' or 'dense', got {self.moe_dispatch!r}"
            )

        # --- attention kernels (hand-written CUDA on the card) ---
        self.attn_kernel_enabled = kwargs.pop("attn_kernel_enabled", None)
        self.attn_tkg_kernel_enabled = kwargs.pop("attn_tkg_kernel_enabled", False)
        self.attn_block_tkg_kernel_enabled = kwargs.pop("attn_block_tkg_kernel_enabled", False)
        # fused projections: one interleaved QKV weight, and the hand-written
        # QKV and gate/up/down MLP kernels
        self.fused_qkv = kwargs.pop("fused_qkv", False)
        self.qkv_kernel_enabled = kwargs.pop("qkv_kernel_enabled", False)
        self.mlp_kernel_enabled = kwargs.pop("mlp_kernel_enabled", False)
        self.skip_warmup = kwargs.pop("skip_warmup", False)
        # the device-resident decode loop of generate() (hf_adapter)
        self.async_mode = kwargs.pop("async_mode", False)
        # contiguous continuous batching: batch row i reads and writes cache
        # line seq_ids[i] (the serving engine's slot)
        self.is_continuous_batching = kwargs.pop("is_continuous_batching", False)
        # K decode steps per dispatch (the tkg_multistep submodel; 1 = off)
        self.decode_steps_per_dispatch = int(kwargs.pop("decode_steps_per_dispatch", 1))
        # the device-resident decode loop (the tkg_device_loop submodel): per-row
        # EOS and budget exit on the card, one launch per batch-to-EOS
        self.device_loop = bool(kwargs.pop("device_loop", False))
        # per-window copies of the loop's tokens to the host (drain_outfeed);
        # off unless a caller reads them (the JAX package's auto = on for real
        # devices: nothing on the port's served path drains the ring)
        self.device_loop_outfeed = bool(kwargs.pop("device_loop_outfeed", False))
        # at most this many tokens per loop launch (0 = unlimited): the
        # scheduling point between launches
        self.device_loop_fence = int(kwargs.pop("device_loop_fence", 0))
        # prefill/decode disaggregation: "unified" serves whole requests;
        # "prefill" prefills, samples the first token and parks the request
        # for a KV handoff (serving/handoff.py); "decode" builds no
        # context-encoding or prefix-prefill submodel and admits requests
        # only through an imported KV chain
        self.role = kwargs.pop("role", "unified")
        # the window-sized ring KV cache (kvcache/kv_cache.py::WindowKVLayout):
        # the sliding-window layers keep ``window_ring_slots`` slots (the ring's
        # count, ``sliding_window``) in place of seq_len
        self.sliding_window = kwargs.pop("sliding_window", None)
        self.window_sized_kv = bool(kwargs.pop("window_sized_kv", False))

        if kwargs:
            raise ValueError(
                f"Unknown or not-yet-ported TorchConfig arguments: {sorted(kwargs)}"
            )
        self.validate()

    @property
    def is_chunked_prefill(self) -> bool:
        return self.chunked_prefill_config is not None

    @property
    def window_ring_slots(self) -> int:
        """Slots of a window-sized ring: ``sliding_window``, over-provisioned
        by the speculation window (spec_len + 1) under linear speculation (the
        JAX package's rule): a rejected draft's row, written ahead, never
        lands on a slot a later query still attends. The ring takes chains
        only (fused, EAGLE's chain, the draft-model pair); a token tree on a
        windowed target is refused at app build."""
        lookahead = self.speculation_length + 1 if self.speculation_length > 0 else 0
        return int(self.sliding_window or 0) + lookahead

    @property
    def speculates(self) -> bool:
        """Any speculative decoding: fused, Medusa or a draft-model pair."""
        return self.enable_fused_speculation or self.is_medusa or self.speculation_length > 0

    def validate(self) -> None:
        if self.padding_side not in ("right", "left"):
            raise ValueError("padding_side must be 'right' or 'left'")
        if self.tp_degree != 1:
            raise NotImplementedError(
                "tp_degree > 1: tensor parallelism is not ported yet (one H100)"
            )
        if self.qkv_kernel_enabled and not self.fused_qkv:
            raise ValueError(
                "qkv_kernel_enabled requires fused_qkv=True (the kernel runs "
                "over the fused interleaved QKV weight)"
            )
        if self.fused_qkv and self.lora_config is not None:
            raise ValueError(
                "fused_qkv does not compose with LoRA serving (adapters "
                "target the separate q/k/v projections)"
            )
        if self.mlp_kernel_enabled and self.lora_config is not None:
            raise ValueError(
                "mlp_kernel_enabled does not compose with LoRA serving"
            )
        if self.max_context_length > self.seq_len:
            raise ValueError("max_context_length must not exceed seq_len")
        if self.is_block_kv_layout and self.pa_num_blocks is None:
            self.pa_num_blocks = max(
                1, (self.seq_len * self.max_batch_size) // self.pa_block_size
            )
        if self.is_prefix_caching and not self.is_block_kv_layout:
            raise ValueError("is_prefix_caching requires is_block_kv_layout")
        if self.is_chunked_prefill and not self.is_block_kv_layout:
            raise ValueError("chunked prefill requires is_block_kv_layout")
        if self.async_mode and self.is_block_kv_layout:
            raise NotImplementedError(
                "async_mode with is_block_kv_layout: the device-resident loop "
                "carries no block tables; it runs on the contiguous cache"
            )
        if self.is_medusa and self.num_medusa_heads <= 0:
            raise ValueError("is_medusa requires num_medusa_heads > 0")
        if self.lora_config is not None and self.async_mode:
            raise ValueError(
                "LoRA serving is incompatible with async_mode: the device-"
                "resident decode loop cannot carry per-request adapter_ids"
            )
        if self.lora_config is not None and self.speculates:
            raise ValueError(
                "LoRA serving is not supported with speculative decoding yet: "
                "the speculation graphs do not thread adapter_ids"
            )
        if self.speculation_length < 0:
            raise ValueError("speculation_length must be >= 0")
        if self.decode_steps_per_dispatch < 1:
            raise ValueError("decode_steps_per_dispatch must be >= 1")
        if self.device_loop_fence < 0:
            raise ValueError("device_loop_fence must be >= 0 (0 = unlimited)")
        # the JAX package's rules for the in-graph decode bodies: they sample,
        # advance positions and commit KV on the device
        for key, on in (("decode_steps_per_dispatch > 1", self.decode_steps_per_dispatch > 1),
                        ("device_loop", self.device_loop)):
            if not on:
                continue
            if self.on_device_sampling_config is None:
                raise ValueError(f"{key} requires on-device sampling (each step samples "
                                 "its token on the device)")
            if self.speculates:
                raise ValueError(f"{key} and speculative decoding both own the "
                                 "token-generation stride; enable one")
            if self.is_block_kv_layout:
                raise ValueError(f"{key} needs in-graph KV addressing by position; the "
                                 "block layout's slot mappings are host-computed per step")
            if self.ctx_batch_size != self.tkg_batch_size:
                raise ValueError(f"{key} requires ctx_batch_size == tkg_batch_size (the "
                                 "windows chain from the context-encoding outputs)")
            if self.lora_config is not None:
                raise ValueError(LORA_DECODE_BODY_REFUSALS[key])
        kvq = self.kv_quant_config
        if kvq is not None and kvq.scale_mode in ("per_key", "per_channel"):
            if self.is_block_kv_layout or self.window_sized_kv:
                raise ValueError(
                    f"kv quant scale_mode={kvq.scale_mode!r} composes with the "
                    "contiguous KV layout only (paged/ring layouts take "
                    "per-tensor scales)"
                )
        if self.mlp_kernel_enabled and self.quantized:
            raise ValueError(
                "mlp_kernel_enabled composes with full-precision weights only "
                "for now (quantized fused MLP is not implemented)"
            )
        self._validate_ring()
        if self.device_loop and self.mixed_dispatch:
            raise ValueError("device_loop and mixed_dispatch are different serving step "
                             "shapes; enable one")
        if self.mixed_dispatch and not self.is_block_kv_layout:
            raise ValueError(
                "mixed_dispatch requires is_block_kv_layout (the packed rows "
                "read KV through the paged block tables)"
            )
        if self.role not in ("unified", "prefill", "decode"):
            raise ValueError(
                f"role must be 'unified', 'prefill' or 'decode', got {self.role!r}"
            )
        if self.role != "unified":
            if not self.is_block_kv_layout:
                raise ValueError(
                    f"role={self.role!r} requires is_block_kv_layout (the KV "
                    "handoff plane exports/imports paged block chains)"
                )
            if self.mixed_dispatch:
                raise ValueError(
                    "mixed_dispatch is inherently a unified prefill+decode "
                    f"program; it cannot compose with role={self.role!r}"
                )
            if self.role == "prefill" and (
                self.decode_steps_per_dispatch > 1 or self.device_loop
            ):
                raise ValueError(
                    "role='prefill' ships only CTE/prefix-prefill + a 1-token "
                    "TKG; decode_steps_per_dispatch > 1 and device_loop are "
                    "decode-role program shapes"
                )

    def _validate_ring(self) -> None:
        """The JAX package's ``window_sized_kv`` refusals, in its words."""
        if (self.mlp_kernel_enabled or self.qkv_kernel_enabled) and self.window_sized_kv:
            raise ValueError(
                "mlp_kernel_enabled/qkv_kernel_enabled are not supported with "
                "window_sized_kv or pipeline parallel yet"
            )
        if not self.window_sized_kv:
            return
        if not self.sliding_window:
            raise ValueError(
                "window_sized_kv needs tpu_config.sliding_window (the ring "
                "slot count) — set it to the model's sliding window"
            )
        if self.sliding_window > self.seq_len:
            raise ValueError(
                f"window_sized_kv ring ({self.sliding_window} slots) cannot "
                f"exceed seq_len ({self.seq_len}) — the ring layout would "
                "address slots the cache does not have"
            )
        if (self.is_block_kv_layout or self.is_medusa or self.is_prefix_caching
                or self.is_chunked_prefill):
            raise ValueError(
                "window_sized_kv composes with contiguous decode (and "
                "linear speculation) only: paged/medusa/prefix modes "
                "assume position-addressed cache slots, which the ring "
                "layout does not provide"
            )
        if self.speculation_length > 0 or self.enable_fused_speculation:
            if self.window_ring_slots > self.seq_len:
                raise ValueError(
                    f"window_sized_kv + speculation needs sliding_window +"
                    f" speculation_length + 1 = {self.window_ring_slots} "
                    f"ring slots, which exceeds seq_len ({self.seq_len})"
                )

    _SUBCONFIGS = {
        "on_device_sampling_config": OnDeviceSamplingConfig,
        "kv_quant_config": KVQuantizationConfig,
        "chunked_prefill_config": ChunkedPrefillConfig,
        "speculation_config": SpeculationConfig,
        "lora_config": LoraServingConfig,
    }

    def to_dict(self) -> Dict[str, Any]:
        out = {}
        for k, v in self.__dict__.items():
            if k in self._SUBCONFIGS:
                out[k] = v.to_dict() if v is not None else None
            elif k == "dtype":
                out[k] = dtype_name(v)
            else:
                out[k] = v
        return out

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TorchConfig":
        return cls(**{k: v for k, v in dict(d).items() if v is not None or k.endswith("_config")})


def promote_text_config(config) -> None:
    """Composite HF configs (Llama 4's vision + text checkpoint) nest the
    language model's hyperparameters under ``text_config``: promote them to
    the top level, where they win over the wrapper's own defaults (the JAX
    package's ``promote_text_config``)."""
    tc = getattr(config, "text_config", None)
    if tc is None:
        return
    if not isinstance(tc, dict):
        tc = tc.to_dict()
    for k, v in tc.items():
        setattr(config, k, v)


class InferenceConfig:
    """Model hyperparameters + a :class:`TorchConfig` under ``tpu_config``
    (the attribute keeps the JAX package's name so saved JSON matches)."""

    REQUIRED = ["hidden_size", "num_attention_heads", "num_hidden_layers", "vocab_size"]

    def __init__(self, tpu_config: TorchConfig, load_config=None, metadata=None, **kwargs):
        self.tpu_config = tpu_config
        self.metadata = metadata or {}
        if load_config is not None:
            for k, v in load_config().items():
                setattr(self, k, v)
        for k, v in kwargs.items():
            setattr(self, k, v)
        self.add_derived_config()
        self.validate_config()

    def add_derived_config(self) -> None:
        if not hasattr(self, "num_key_value_heads") and hasattr(self, "num_attention_heads"):
            self.num_key_value_heads = self.num_attention_heads
        if not hasattr(self, "head_dim") and hasattr(self, "hidden_size"):
            self.head_dim = self.hidden_size // self.num_attention_heads

    def get_required_attributes(self) -> List[str]:
        return list(self.REQUIRED)

    def validate_config(self) -> None:
        missing = [a for a in self.get_required_attributes() if not hasattr(self, a)]
        if missing:
            raise ValueError(f"InferenceConfig missing required attributes: {missing}")

    def to_dict(self) -> Dict[str, Any]:
        out = {}
        for k, v in self.__dict__.items():
            if k == "tpu_config":
                out[k] = v.to_dict()
                continue
            try:
                json.dumps(v)
            except TypeError:
                continue  # non-serializable helper attrs are reconstructable
            out[k] = v
        return out

    def save(self, model_path: str) -> str:
        os.makedirs(model_path, exist_ok=True)
        path = os.path.join(model_path, CONFIG_FILE)
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, sort_keys=True)
        return path

    @classmethod
    def load(cls, model_path: str, **kwargs) -> "InferenceConfig":
        with open(os.path.join(model_path, CONFIG_FILE)) as f:
            d = json.load(f)
        tpu_config = TorchConfig.from_dict(d.pop("tpu_config"))
        obj = cls.__new__(cls)
        obj.tpu_config = tpu_config
        obj.metadata = {}
        for k, v in d.items():
            setattr(obj, k, v)
        for k, v in kwargs.items():
            setattr(obj, k, v)
        obj.add_derived_config()
        obj.validate_config()
        return obj
