"""Speculation applications (counterpart of
``nxdi_tpu/speculation/application.py``, its fused, EAGLE and Medusa apps).

:class:`FusedSpecCausalLM` owns a draft and a target model in one lifecycle:
its params and KV caches are ``{"draft": ..., "target": ...}`` dicts on the
app's device, and its two submodels are the fused context encoding and the
fused window (``speculation/fused.py``), each bucket one CUDA graph over
both caches in the app's graph pool. :class:`EagleSpecCausalLM` runs an
EAGLE draft the same way (``speculation/eagle.py``), with the features
buffer beside the caches. :class:`MedusaCausalLM` is one model
with stacked Medusa heads in its params (``medusa_heads``) and the
proposal buffer in its cache (``medusa_tokens``). Both present the
window contract ``generate()`` drives (``is_fused_spec``: ``tokens`` and
``counts`` per dispatch); neither runs the device-resident async loop
(``async_supported`` is False, as in the JAX package) nor the block layout.
Every family runs them, window-sized rings and MLA included; a token tree
on a target with a sliding window or an attention chunk is refused at app
build (``runtime/application.refuse_speculation``).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from nxdi_tpu_torch import checkpoint as ckpt
from nxdi_tpu_torch.config import to_torch_dtype
from nxdi_tpu_torch.models import llama_eagle
from nxdi_tpu_torch.runtime import autobucketing
from nxdi_tpu_torch.runtime.application import (
    TorchModelForCausalLM,
    maybe_quantize_params,
    refuse_speculation,
)
from nxdi_tpu_torch.runtime.model_wrapper import (
    TAG_CONTEXT_ENCODING,
    TAG_FUSED_SPECULATION,
    TAG_MEDUSA_SPECULATION,
    kv_layout_from_config,
)
from nxdi_tpu_torch.speculation.eagle import EagleSpecWrapper
from nxdi_tpu_torch.speculation.fused import FusedSpecWrapper
from nxdi_tpu_torch.speculation.medusa import MedusaWrapper
from nxdi_tpu_torch.speculation.token_tree import DynamicTreeSpec, TokenTree


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
        """Each model's cache by its own config (the JAX app's rule): a
        window-sized target's ring (``window_ring_slots`` slots, or its
        interleaved ``k_win`` / ``v_win`` stack beside the full layers), a
        full-cache draft's contiguous lines."""
        return {"draft": self.model_cache(self.draft_family, self.draft_config),
                "target": self.model_cache()}

    _wrapper_cls = FusedSpecWrapper

    def _spec_wrapper_kwargs(self) -> Dict[str, Any]:
        """Extra arguments of this app's wrapper (EAGLE adds its own)."""
        return {}

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
            **self._spec_wrapper_kwargs(),
        )
        t_inv = self.family.build_inv_freq(self.config)
        self.models[TAG_CONTEXT_ENCODING] = self._wrapper_cls(
            TAG_CONTEXT_ENCODING, self.config, t_arch, t_inv,
            batch_size=tc.ctx_batch_size, n_active_tokens=0,
            buckets=autobucketing.context_encoding_buckets(self.config),
            attend_to_cache=False, forward_kwargs={}, **common)
        self.models[TAG_FUSED_SPECULATION] = self._wrapper_cls(
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


class EagleSpecCausalLM(FusedSpecCausalLM):
    """Fused speculation with an EAGLE or EAGLE3 draft: the EAGLE draft
    family (``models/llama_eagle.py``) by default, a ``features`` buffer in
    the cache, draft params that borrow the target's embedding (and its
    lm_head when the vocabularies match), and EAGLE token trees
    (``token_tree_config``: a path list, ``{"choices": ...}`` or
    ``{"dynamic": {"steps", "branching_factor", "num_inputs"}}``)."""

    _wrapper_cls = EagleSpecWrapper

    def __init__(self, *args, **kwargs):
        kwargs.setdefault("draft_family", llama_eagle)
        super().__init__(*args, **kwargs)
        tc = self.tpu_config
        self.is_eagle3 = bool(tc.is_eagle3)
        self.draft_config.tpu_config.is_eagle3 = self.is_eagle3
        # what the draft's conversion reads about its target
        self.draft_config.target_num_layers = self.config.num_hidden_layers
        self.draft_config.target_hidden_size = self.config.hidden_size
        if self.is_eagle3:
            self.draft_config.target_vocab_size = self.config.vocab_size
        self.aux_hidden_indices = (
            llama_eagle.eagle3_aux_indices_default(self.config.num_hidden_layers)
            if self.is_eagle3 else None)
        self.tree = self._parse_tree(tc.token_tree_config)
        if self.tree is not None and tc.speculation_length != self.tree.max_depth:
            raise ValueError(
                f"speculation_length ({tc.speculation_length}) must equal the token tree "
                f"depth ({self.tree.max_depth}): each tree window retires at most "
                "depth + 1 tokens")
        refuse_speculation(self.family.build_arch(self.config), tree=self.tree is not None)

    @staticmethod
    def _parse_tree(ttc):
        """The window's tree: None (a chain), a static :class:`TokenTree` or
        a :class:`DynamicTreeSpec`, under the JAX package's rules."""
        if not ttc:
            return None
        if isinstance(ttc, dict) and "dynamic" in ttc:
            d = ttc["dynamic"]
            steps, bf = int(d["steps"]), int(d["branching_factor"])
            ni = int(d.get("num_inputs", 1))
            if steps < 1 or bf < 1 or ni < 1:
                raise ValueError(
                    f"dynamic token tree needs steps/branching_factor/num_inputs >= 1, got {d}")
            if ni > bf:
                # step 1 selects its parents among step 0's branching_factor nodes
                raise ValueError(
                    f"dynamic token tree num_inputs ({ni}) cannot exceed branching_factor "
                    f"({bf}): each step selects parents from the previous step's nodes")
            return DynamicTreeSpec(steps=steps, branching_factor=bf, num_inputs=ni)
        return TokenTree.from_choices(ttc["choices"] if isinstance(ttc, dict) else ttc)

    def build_params(self) -> Dict[str, Any]:
        if self.tpu_config.quantized and self.tpu_config.quantized_checkpoints_path:
            raise NotImplementedError(
                "quantized_checkpoints_path is not supported with EAGLE yet")
        target_sd = self.get_state_dict()
        target = self.family.convert_hf_state_dict(target_sd, self.config)
        draft_sd = dict(self.get_draft_state_dict())

        def probe(sd, name):
            return name in sd or f"model.{name}" in sd

        # official drafts ship without an embedding or lm_head: borrow the target's
        if not probe(draft_sd, "embed_tokens.weight"):
            draft_sd["embed_tokens.weight"] = target_sd.get(
                "embed_tokens.weight", target_sd.get("model.embed_tokens.weight"))
        if (not probe(draft_sd, "lm_head.weight")
                and self.draft_config.vocab_size == self.config.vocab_size):
            head = target_sd.get("lm_head.weight")
            # a tied target: its embedding
            draft_sd["lm_head.weight"] = head if head is not None else draft_sd[
                "embed_tokens.weight"]
        draft = self.draft_family.convert_hf_state_dict(draft_sd, self.draft_config)
        return {"draft": maybe_quantize_params(draft, self.draft_config.tpu_config),
                "target": maybe_quantize_params(target, self.tpu_config)}

    def init_cache(self) -> Dict[str, Any]:
        cache = super().init_cache()
        tc = self.tpu_config
        d_arch = self.draft_family.build_arch(self.draft_config)
        # the feature before each cache line's next input token, in the draft's dtype
        cache["features"] = torch.zeros(
            (tc.kv_cache_batch_size + tc.kv_cache_padding_size, self.draft_config.hidden_size),
            dtype=to_torch_dtype(d_arch.dtype), device=self.device)
        return cache

    def _spec_wrapper_kwargs(self) -> Dict[str, Any]:
        return dict(is_eagle3=self.is_eagle3, aux_hidden_indices=self.aux_hidden_indices,
                    tree=self.tree)


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
        refuse_speculation(self.family.build_arch(self.config), tree=self.tree is not None)

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
