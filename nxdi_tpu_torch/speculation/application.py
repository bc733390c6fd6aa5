"""Speculation applications (counterpart of
``nxdi_tpu/speculation/application.py``, its fused and Medusa apps).

:class:`FusedSpecCausalLM` owns a draft and a target model in one lifecycle:
its params and KV caches are ``{"draft": ..., "target": ...}`` dicts on the
app's device, and its two submodels are the fused context encoding and the
fused window (``speculation/fused.py``), each bucket one CUDA graph over
both caches in the app's graph pool. :class:`MedusaCausalLM` is one model
with stacked Medusa heads in its params (``medusa_heads``) and the
proposal buffer in its cache (``medusa_tokens``). Both present the
window contract ``generate()`` drives (``is_fused_spec``: ``tokens`` and
``counts`` per dispatch); neither runs the device-resident async loop
(``async_supported`` is False, as in the JAX package) nor the block layout.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from nxdi_tpu_torch import checkpoint as ckpt
from nxdi_tpu_torch.config import to_torch_dtype
from nxdi_tpu_torch.kvcache.kv_cache import init_kv_cache
from nxdi_tpu_torch.runtime import autobucketing
from nxdi_tpu_torch.runtime.application import TorchModelForCausalLM, maybe_quantize_params
from nxdi_tpu_torch.runtime.model_wrapper import (
    TAG_CONTEXT_ENCODING,
    TAG_FUSED_SPECULATION,
    TAG_MEDUSA_SPECULATION,
    kv_layout_from_config,
)
from nxdi_tpu_torch.speculation.fused import FusedSpecWrapper
from nxdi_tpu_torch.speculation.medusa import MedusaWrapper
from nxdi_tpu_torch.speculation.token_tree import TokenTree


class _WindowApp(TorchModelForCausalLM):
    """What the window apps share: a prefill goes to the context encoding,
    a one-token dispatch to the window submodel; windows and emitted tokens
    are counted as plain attributes (``spec_windows``,
    ``spec_accepted_tokens``) by ``generate()``."""

    is_fused_spec = True
    _window_tag = TAG_FUSED_SPECULATION

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.spec_windows = 0
        self.spec_accepted_tokens = 0

    def forward(self, input_ids, position_ids, submodel=None, **kwargs):
        if not self.is_loaded:
            raise RuntimeError("call load() before forward()")
        if submodel is None:
            submodel = TAG_CONTEXT_ENCODING if input_ids.shape[1] > 1 else self._window_tag
        return super().forward(input_ids, position_ids, submodel=submodel, **kwargs)

    @property
    def async_supported(self) -> bool:
        return False


class FusedSpecCausalLM(_WindowApp):
    """A causal LM with fused speculative decoding: a draft and a target
    model, a whole draft + verify window per dispatch."""

    def __init__(self, model_path: str, config, draft_model_path: str, draft_config,
                 model_family=None, draft_family=None, device=None, graphs: bool = True):
        super().__init__(model_path, config, model_family, device=device, graphs=graphs)
        self.draft_model_path = draft_model_path
        self.draft_config = draft_config
        self.draft_family = draft_family or self.family
        self.spec_len = config.tpu_config.speculation_length
        if self.spec_len < 1:
            raise ValueError("fused speculation requires speculation_length >= 1")
        if config.tpu_config.is_block_kv_layout:
            raise ValueError(
                "fused speculation does not support the block KV layout yet: "
                "the in-graph draft loop would need per-step slot mappings")

    def get_draft_state_dict(self):
        return ckpt.load_state_dict(self.draft_model_path)

    def build_params(self) -> Dict[str, Any]:
        if self.tpu_config.quantized and self.tpu_config.quantized_checkpoints_path:
            raise NotImplementedError(
                "quantized_checkpoints_path is not supported with fused "
                "speculation yet (the artifact holds a single model, not the "
                "draft+target pair); unset it to quantize online")
        target = self.family.convert_hf_state_dict(self.get_state_dict(), self.config)
        draft = self.draft_family.convert_hf_state_dict(self.get_draft_state_dict(),
                                                        self.draft_config)
        return {"draft": maybe_quantize_params(draft, self.draft_config.tpu_config),
                "target": maybe_quantize_params(target, self.tpu_config)}

    def init_cache(self) -> Dict[str, Any]:
        return {
            "draft": init_kv_cache(self._cache_spec(self.draft_family, self.draft_config),
                                   self.device),
            "target": init_kv_cache(self._cache_spec(), self.device),
        }

    def enable_models(self) -> None:
        t_arch = self.family.build_arch(self.config)
        d_arch = self.draft_family.build_arch(self.draft_config)
        tc = self.tpu_config
        common = dict(
            draft_arch=d_arch,
            draft_inv_freq=self.draft_family.build_inv_freq(self.draft_config),
            spec_len=self.spec_len,
            # the draft's own layout, from its config
            draft_layout=kv_layout_from_config(self.draft_config.tpu_config, d_arch),
            device=self.device,
        )
        t_inv = self.family.build_inv_freq(self.config)
        self.models[TAG_CONTEXT_ENCODING] = FusedSpecWrapper(
            TAG_CONTEXT_ENCODING, self.config, t_arch, t_inv,
            batch_size=tc.ctx_batch_size, n_active_tokens=0,
            buckets=autobucketing.context_encoding_buckets(self.config),
            attend_to_cache=False, forward_kwargs={}, **common)
        self.models[TAG_FUSED_SPECULATION] = FusedSpecWrapper(
            TAG_FUSED_SPECULATION, self.config, t_arch, t_inv,
            batch_size=tc.tkg_batch_size, n_active_tokens=1,
            buckets=autobucketing.token_generation_buckets(self.config),
            attend_to_cache=True,
            # async_mode: the window emits the next window's inputs on the
            # device (the device-resident window chain)
            forward_kwargs={"return_next_inputs": True} if tc.async_mode else {},
            **common)
        for w in self.models.values():
            w.graphs = self.graphs


class MedusaCausalLM(_WindowApp):
    """A causal LM with Medusa heads: one model, extra ResBlock + lm_head
    stacks appended to its params as ``medusa_heads``; the proposals between
    windows live in the cache as ``medusa_tokens``. A ``medusa_tree`` runs
    token-tree windows."""

    _window_tag = TAG_MEDUSA_SPECULATION

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        tc = self.tpu_config
        self.num_heads = tc.num_medusa_heads
        if not tc.is_medusa or self.num_heads < 1:
            raise ValueError("MedusaCausalLM requires is_medusa and num_medusa_heads >= 1")
        if tc.is_block_kv_layout:
            raise ValueError("medusa does not support the block KV layout yet")
        self.tree = None
        if tc.medusa_tree:
            self.tree = TokenTree.from_choices(tc.medusa_tree)
            if self.tree.max_depth > self.num_heads:
                raise ValueError(f"medusa_tree depth {self.tree.max_depth} exceeds "
                                 f"num_medusa_heads {self.num_heads}")

    def build_params(self):
        tc = self.tpu_config
        if tc.quantized and tc.quantized_checkpoints_path:
            raise NotImplementedError(
                "quantized_checkpoints_path is not supported with medusa yet")
        sd = self.get_state_dict()  # one checkpoint read for the model and its heads
        params = maybe_quantize_params(self.family.convert_hf_state_dict(sd, self.config), tc)
        params["medusa_heads"] = self._convert_medusa_heads(sd)
        return params

    def _convert_medusa_heads(self, sd):
        """HF Medusa checkpoints: ``medusa_head.{i}.0.linear.{weight,bias}``
        is the ResBlock, ``medusa_head.{i}.1.weight`` the head's lm_head
        (padded to the model's padded vocab like the main lm_head)."""
        arch = self.family.build_arch(self.config)
        dt = to_torch_dtype(arch.dtype)
        H, V, K = arch.hidden_size, arch.vocab_size, self.num_heads

        def get(i, suffix):
            for prefix in ("medusa_head", "medusa_heads", "model.medusa_head"):
                k = f"{prefix}.{i}.{suffix}"
                if k in sd:
                    return torch.as_tensor(np.asarray(sd[k]))
            raise KeyError(f"medusa head weight {i}.{suffix} not found in checkpoint")

        res_w = torch.stack([get(i, "0.linear.weight").t() for i in range(K)])
        res_b = torch.stack([get(i, "0.linear.bias") for i in range(K)])
        heads = []
        for i in range(K):
            h = get(i, "1.weight").t()  # (H, v)
            if h.shape[1] < V:
                h = torch.cat([h, h.new_zeros((H, V - h.shape[1]))], dim=1)
            heads.append(h)
        return {"res_w": res_w.to(dt).contiguous(), "res_b": res_b.to(dt).contiguous(),
                "head": torch.stack(heads).to(dt).contiguous()}

    def _proposal_shape(self):
        tc = self.tpu_config
        topk = self.tree.max_branch if self.tree is not None else 1
        return (tc.kv_cache_batch_size + tc.kv_cache_padding_size, self.num_heads, topk)

    def init_cache(self) -> Dict[str, Any]:
        cache = super().init_cache()
        cache["medusa_tokens"] = torch.zeros(self._proposal_shape(), dtype=torch.int32,
                                             device=self.device)
        return cache

    def enable_models(self) -> None:
        arch = self.family.build_arch(self.config)
        inv_freq = self.family.build_inv_freq(self.config)
        tc = self.tpu_config
        common = dict(num_heads=self.num_heads, tree=self.tree, device=self.device,
                      forward_kwargs={})
        self.models[TAG_CONTEXT_ENCODING] = MedusaWrapper(
            TAG_CONTEXT_ENCODING, self.config, arch, inv_freq,
            batch_size=tc.ctx_batch_size, n_active_tokens=0,
            buckets=autobucketing.context_encoding_buckets(self.config),
            attend_to_cache=False, **common)
        self.models[TAG_MEDUSA_SPECULATION] = MedusaWrapper(
            TAG_MEDUSA_SPECULATION, self.config, arch, inv_freq,
            batch_size=tc.tkg_batch_size, n_active_tokens=1,
            buckets=autobucketing.token_generation_buckets(self.config),
            attend_to_cache=True, **common)
        for w in self.models.values():
            w.graphs = self.graphs
