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

Features the port does not carry yet (speculation, quantization, tensor
parallelism, ...) are not keys here:
passing one raises, naming it (a few are accepted at the value that turns
them off, ``_NOT_PORTED``).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List

import torch

CONFIG_FILE = "tpu_config.json"

_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float16": torch.float16,
}


def to_torch_dtype(dtype) -> torch.dtype:
    """Map a dtype name (``"bfloat16"``, ``"torch.float32"``) or a torch dtype
    to a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    key = str(dtype).replace("torch.", "")
    if key not in _DTYPES:
        raise ValueError(f"Unsupported dtype {dtype!r}; options: {sorted(_DTYPES)}")
    return _DTYPES[key]


def dtype_name(dtype) -> str:
    return str(to_torch_dtype(dtype)).replace("torch.", "")


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


# JAX-package keys whose features are not ported yet: accepted at the value
# that means "off", so a saved config of the ported path loads unchanged
_NOT_PORTED = {
    "padding_side": "right",
    "role": "unified",
}


class TorchConfig:
    """Runtime configuration; the counterpart of the JAX package's
    ``TpuConfig`` for the fields this port implements."""

    def __init__(self, **kwargs) -> None:
        # --- basic shapes ---
        self.batch_size = kwargs.pop("batch_size", 1)
        self.seq_len = kwargs.pop("seq_len", 128)
        self.max_context_length = kwargs.pop("max_context_length", self.seq_len)
        self.output_logits = kwargs.pop("output_logits", False)

        # --- dtypes ---
        self.dtype = to_torch_dtype(kwargs.pop("dtype", kwargs.pop("torch_dtype", "bfloat16")))

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

        # --- parallelism: one device ---
        self.tp_degree = kwargs.pop("tp_degree", 1)

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

        for key, default in _NOT_PORTED.items():
            if key in kwargs and kwargs.pop(key) != default:
                raise NotImplementedError(f"{key}: not ported yet (only {default!r} is accepted)")
        if kwargs:
            raise ValueError(
                f"Unknown or not-yet-ported TorchConfig arguments: {sorted(kwargs)}"
            )
        self.validate()

    @property
    def is_chunked_prefill(self) -> bool:
        return self.chunked_prefill_config is not None

    def validate(self) -> None:
        if self.tp_degree != 1:
            raise NotImplementedError(
                "tp_degree > 1: tensor parallelism is not ported yet (one H100)"
            )
        if self.qkv_kernel_enabled and not self.fused_qkv:
            raise ValueError(
                "qkv_kernel_enabled requires fused_qkv=True (the kernel runs "
                "over the fused interleaved QKV weight)"
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
            if self.is_block_kv_layout:
                raise ValueError(f"{key} needs in-graph KV addressing by position; the "
                                 "block layout's slot mappings are host-computed per step")
            if self.ctx_batch_size != self.tkg_batch_size:
                raise ValueError(f"{key} requires ctx_batch_size == tkg_batch_size (the "
                                 "windows chain from the context-encoding outputs)")
        if self.device_loop and self.mixed_dispatch:
            raise ValueError("device_loop and mixed_dispatch are different serving step "
                             "shapes; enable one")
        if self.mixed_dispatch and not self.is_block_kv_layout:
            raise ValueError(
                "mixed_dispatch requires is_block_kv_layout (the packed rows "
                "read KV through the paged block tables)"
            )

    _SUBCONFIGS = {
        "on_device_sampling_config": OnDeviceSamplingConfig,
        "chunked_prefill_config": ChunkedPrefillConfig,
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
