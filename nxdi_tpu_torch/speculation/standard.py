"""Standard (unfused) speculative decoding: a draft app and a target app,
driven by a host propose/verify loop (counterpart of
``nxdi_tpu/speculation/standard.py``).

The draft runs at its own configuration, at the cost of k host dispatches a
window: k draft decode steps (each one the draft's token-generation graph on
the card), then one verify of the k + 1 candidates by the target's
``speculation_model`` submodel (one graph per bucket), whose greedy tokens
are selected on the device from its logits. :class:`StandardSpecCausalLM`
presents the window contract (``is_fused_spec``: ``tokens`` and ``counts``),
so ``generate()``'s window loop drives it unchanged. Near the KV window's
edge, where the k + 1 verify positions would overflow the largest bucket,
a window falls back to one plain decode step on both apps.
"""

from __future__ import annotations

import numpy as np
import torch

from nxdi_tpu_torch.ops import sampling as sampling_ops
from nxdi_tpu_torch.runtime.application import TorchModelForCausalLM
from nxdi_tpu_torch.runtime.model_wrapper import (
    TAG_SPECULATION,
    TAG_TOKEN_GENERATION,
    ModelWrapper,
    decode_window_limit,
)


class SpecTargetCausalLM(TorchModelForCausalLM):
    """The target app with a multi-token verify submodel: the
    ``speculation_model`` scores ``speculation_length + 1`` candidates in one
    forward and returns the logits of every position."""

    def enable_models(self) -> None:
        super().enable_models()
        tc = self.tpu_config
        tkg = self.models[TAG_TOKEN_GENERATION]
        verify = self.models[TAG_SPECULATION] = ModelWrapper(
            TAG_SPECULATION, self.config, tkg.arch, self.family.build_inv_freq(self.config),
            batch_size=tc.tkg_batch_size, n_active_tokens=tc.speculation_length + 1,
            buckets=tkg.buckets, attend_to_cache=True, device=self.device,
            forward_kwargs=dict(gather_last_token=False, output_logits=True,
                                on_device_sampling=False),
            graphs=self.graphs,
        )
        # a family with its own forward (MiMo-V2's segment walk) sets it on
        # the wrappers its enable_models built, which super() ran: the
        # verify runs the same forward
        verify.forward_fn = tkg.forward_fn


def _app_cls(family, base=None):
    """The family's application class (``APPLICATION_CLS``, else the plain
    app); with ``base`` (the spec-target app) grafted in front of it, so a
    family's own forward and cache stacks serve the verify too (the JAX
    package's ``_app_cls``)."""
    cls = getattr(family, "APPLICATION_CLS", None) or TorchModelForCausalLM
    if base is None:
        return cls
    if cls is TorchModelForCausalLM or issubclass(base, cls):
        return base
    return type(f"{base.__name__}_{cls.__name__}", (base, cls), {})


class StandardSpecCausalLM:
    """A draft app and a target app on one device, orchestrated from the
    host."""

    is_fused_spec = True

    def __init__(self, model_path: str, config, draft_model_path: str, draft_config,
                 model_family=None, draft_family=None, device=None, graphs: bool = True):
        self.config = config
        self.tpu_config = config.tpu_config
        self.spec_len = config.tpu_config.speculation_length
        if self.spec_len < 1:
            raise ValueError("speculation requires speculation_length >= 1")
        if config.tpu_config.on_device_sampling_config is None:
            raise ValueError(
                "standard speculation requires on-device sampling (the draft "
                "proposes with the on-device greedy sampler); set "
                "on_device_sampling_config")
        if draft_config.tpu_config.on_device_sampling_config is None:
            draft_config.tpu_config.on_device_sampling_config = (
                config.tpu_config.on_device_sampling_config)
        self.target = _app_cls(model_family, SpecTargetCausalLM)(
            model_path, config, model_family=model_family, device=device, graphs=graphs)
        draft_family = draft_family or model_family
        self.draft = _app_cls(draft_family)(draft_model_path, draft_config,
                                            model_family=draft_family, device=device,
                                            graphs=graphs)
        self.device = self.target.device
        self.spec_windows = 0
        self.spec_accepted_tokens = 0

    @property
    def models(self):
        # generate() reads the KV window limit off the target's submodels
        return self.target.models

    @property
    def is_loaded(self):
        return self.target.is_loaded and self.draft.is_loaded

    @property
    def async_supported(self) -> bool:
        return False

    def load(self) -> None:
        self.target.load()
        self.draft.load()

    def reset_kv_cache(self) -> None:
        self.target.reset_kv_cache()
        self.draft.reset_kv_cache()

    def _window_limit(self) -> int:
        return decode_window_limit(self.tpu_config, self.target.models)

    def forward(self, input_ids: np.ndarray, position_ids: np.ndarray, **kwargs):
        if input_ids.shape[1] > 1:  # prefill: prime both caches on the prompt
            out = self.target.forward(input_ids, position_ids, **kwargs)
            self.draft.forward(input_ids, position_ids, **kwargs)
            return {"tokens": out["tokens"],
                    "counts": torch.ones((input_ids.shape[0],), dtype=torch.int32)}
        return self._spec_window(input_ids, position_ids, **kwargs)

    def _spec_window(self, cur_tok, cur_pos, **kwargs):
        B, k = cur_tok.shape[0], self.spec_len
        # the verify positions would overflow the largest window: one plain
        # step (which keeps the draft cache in step)
        if int(cur_pos.max()) + k + 1 > self._window_limit():
            out = self.target.forward(cur_tok, cur_pos, **kwargs)
            self.draft.forward(cur_tok, cur_pos, **kwargs)
            return {"tokens": out["tokens"], "counts": torch.ones((B,), dtype=torch.int32)}

        # propose: k greedy draft decode steps
        drafted = []
        d_tok, d_pos = cur_tok, cur_pos
        for _ in range(k):
            d_out = self.draft.forward(d_tok, d_pos, **kwargs)
            d_tok = d_out["tokens"].cpu().numpy().astype(np.int32)
            d_pos = d_pos + 1
            drafted.append(d_tok)

        # verify: one multi-token target forward over [cur, d_1 .. d_k], its
        # greedy tokens taken from the logits on the device
        candidates = np.concatenate([cur_tok] + drafted, axis=1)  # (B, k + 1)
        positions = cur_pos + np.arange(k + 1, dtype=np.int32)[None, :]
        t_out = self.target.forward(candidates, positions, submodel=TAG_SPECULATION, **kwargs)
        target_tokens = sampling_ops.greedy_sample(t_out["logits"]).cpu().numpy()
        matches = (candidates[:, 1:] == target_tokens[:, :-1]).astype(np.int32)
        counts = np.cumprod(matches, axis=1).sum(axis=1).astype(np.int32) + 1
        return {"tokens": torch.from_numpy(target_tokens), "counts": torch.from_numpy(counts)}
