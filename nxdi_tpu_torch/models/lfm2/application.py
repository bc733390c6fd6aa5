"""LFM2 application (counterpart of ``nxdi_tpu/models/lfm2/modeling_lfm2.py``'s
``Lfm2ForCausalLM``): the hybrid cache ``{"k", "v", "conv"}``
(:func:`~nxdi_tpu_torch.models.lfm2.modeling_lfm2.cache_shapes`) and the
family's forward on every submodel.

Refused, as in the JAX package: async decode, prefix caching, chunked
prefill, the paged layout, speculation, tensor capture, weight quantization
and LoRA (the short-conv recurrence needs its own state routing there).
Refused by the port, where the JAX package builds the path but ignores it
or would run its one-step forward in it: ``window_sized_kv`` (no layer
slides), a quantized KV cache, and the K-step and loop decode."""

from __future__ import annotations

from typing import Dict

import torch

from nxdi_tpu_torch.models.lfm2 import modeling_lfm2 as lf
from nxdi_tpu_torch.runtime.application import TorchModelForCausalLM


class Lfm2ForCausalLM(TorchModelForCausalLM):
    def __init__(self, *args, **kwargs):
        kwargs.setdefault("model_family", lf)
        super().__init__(*args, **kwargs)
        tc = self.tpu_config
        unsupported = [
            ("async_mode", tc.async_mode),
            ("is_prefix_caching", tc.is_prefix_caching),
            ("is_chunked_prefill", tc.is_chunked_prefill),
            ("is_block_kv_layout", tc.is_block_kv_layout),
            ("speculation", tc.speculation_length > 0 or tc.is_medusa),
            ("tensor_capture_config", getattr(tc, "tensor_capture_config", None) is not None),
            ("quantized", tc.quantized),
            ("lora_config", tc.lora_config is not None),
        ]
        bad = [name for name, val in unsupported if val]
        if bad:
            raise ValueError(
                "lfm2 does not support: " + ", ".join(bad) + " — the short-conv "
                "recurrence needs dedicated state routing for these modes")
        port_only = [name for name, val in (
            ("window_sized_kv", tc.window_sized_kv),
            ("kv_quant_config", tc.kv_quant_config is not None),
            ("decode_steps_per_dispatch > 1", tc.decode_steps_per_dispatch > 1),
            ("device_loop", tc.device_loop),
        ) if val]
        if port_only:
            raise NotImplementedError("lfm2 does not support " + ", ".join(port_only) + " yet")

    def refuse_unported(self) -> None:
        pass  # the refusals above are the family's whole list

    def enable_models(self) -> None:
        super().enable_models()
        for w in self.models.values():
            w.forward_fn = lf.lfm2_forward

    def model_cache(self, family=None, config=None) -> Dict[str, torch.Tensor]:
        tc = self.tpu_config
        shapes = lf.cache_shapes(lf.build_arch(self.config),
                                 tc.kv_cache_batch_size + tc.kv_cache_padding_size, tc.seq_len)
        return {k: torch.zeros(shape, dtype=dt, device=self.device)
                for k, (shape, dt) in shapes.items()}
