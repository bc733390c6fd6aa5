"""MiMo-V2 application (counterpart of ``nxdi_tpu/models/mimo_v2/application.py``):
the dual cache, a full-attention stack ``k`` / ``v`` of seq_len slots and a
sliding-window stack ``k_swa`` / ``v_swa``, which ``window_sized_kv``
alone shrinks to ``window_ring_slots``; every submodel runs the family's
segment walk.

Refused, as in the JAX package: async decode, the paged layout, LoRA, fused
and Medusa speculation, pipeline parallelism, prefix caching and chunked
prefill, ``dp_sampling``. Refused by the port, where the JAX package builds
the path but would run its one-step forward in it: the K-step and loop
decode (``decode_steps_per_dispatch > 1``, ``device_loop``)."""

from __future__ import annotations

from typing import Dict

import torch

from nxdi_tpu_torch.kvcache.kv_cache import init_kv_cache
from nxdi_tpu_torch.models.mimo_v2 import modeling_mimo_v2 as mv
from nxdi_tpu_torch.runtime.application import TorchModelForCausalLM


class MiMoV2Application(TorchModelForCausalLM):
    def __init__(self, *args, **kwargs):
        kwargs.setdefault("model_family", mv)
        super().__init__(*args, **kwargs)
        tc = self.tpu_config
        odsc = tc.on_device_sampling_config
        for flag, why in (
            (tc.async_mode, "async (device-resident) decode"),
            (tc.is_block_kv_layout, "paged KV layout"),
            (tc.lora_config is not None, "LoRA serving"),
            (tc.enable_fused_speculation or tc.is_medusa, "fused/medusa speculative decoding"),
            (getattr(tc, "pp_degree", 1) > 1, "pipeline parallel"),
            (tc.is_prefix_caching or tc.is_chunked_prefill, "prefix/chunked prefill"),
            (bool(odsc and odsc.dp_sampling), "dp_sampling"),
            (tc.decode_steps_per_dispatch > 1 or tc.device_loop,
             "multi-step or device-loop decode"),
        ):
            if flag:
                raise NotImplementedError(f"mimo_v2 does not support {why} yet")

    def enable_models(self) -> None:
        super().enable_models()
        for w in self.models.values():
            w.forward_fn = mv.causal_lm_forward

    def _cache_spec(self, family=None, config=None):
        # the full-attention stack keeps seq_len slots; window_sized_kv
        # shrinks only the sliding-window stack (_swa_cache_spec)
        config = config or self.config
        tc = config.tpu_config
        return mv.build_arch(config).full.kv_cache_spec(
            tc.kv_cache_batch_size + tc.kv_cache_padding_size, tc.seq_len)

    def _swa_cache_spec(self, config=None):
        config = config or self.config
        tc = config.tpu_config
        max_len = tc.seq_len
        if tc.window_sized_kv:
            # window_ring_slots over-provisions by spec_len + 1 under a chain
            # verify, so a rejected draft's write never lands on a live row
            max_len = min(max_len, tc.window_ring_slots)
        return mv.build_arch(config).swa.kv_cache_spec(
            tc.kv_cache_batch_size + tc.kv_cache_padding_size, max_len)

    def model_cache(self, family=None, config=None) -> Dict[str, torch.Tensor]:
        cache = init_kv_cache(self._cache_spec(family, config), self.device)
        swa = init_kv_cache(self._swa_cache_spec(config), self.device)
        cache["k_swa"], cache["v_swa"] = swa["k"], swa["v"]
        return cache
