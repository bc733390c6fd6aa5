"""EAGLE draft model family, llama lineage (counterpart of
``nxdi_tpu/models/llama_eagle.py``).

An EAGLE draft is a dense llama (``models/dense.py``'s params layout) plus

  - ``fc``          — (2H, H) projection of concat(token embedding, feature),
  - ``fc_features`` — (kH, H) EAGLE3 projection of the target's k captured
                      layers' hidden states,
  - ``d2t``         — EAGLE3's draft -> target vocab id table,
  - ``input_norm_skip`` — a per-layer flag: official drafts feed the fc
                      output into layer 0's attention without an input norm
                      (``models/base.py`` reads the flag with ``torch.where``).

Drafts have no final norm: conversion drops ``norm`` and the forward feeds
the lm_head the pre-norm stream. The draft's features and speculation windows
live in ``speculation/eagle.py``.

The JAX package's ``param_specs`` and ``param_shape_struct`` (sharding
specs and abstract structs for ahead-of-time compiles) have no counterpart
here: the port runs one device and builds eagerly.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from nxdi_tpu_torch.config import to_torch_dtype
from nxdi_tpu_torch.models import dense
from nxdi_tpu_torch.models.base import DecoderArch

build_inv_freq = dense.build_inv_freq


class LlamaEagleInferenceConfig(dense.DenseInferenceConfig):
    """Draft hyperparameters. The application sets ``target_num_layers``,
    ``target_hidden_size`` and, under EAGLE3, ``target_vocab_size``."""

    def add_derived_config(self):
        super().add_derived_config()
        # a draft always owns an explicit lm_head over its (maybe reduced) vocab
        self.tie_word_embeddings = False


def build_arch(config, **overrides) -> DecoderArch:
    return dense.build_arch(config, **overrides)


def _tensor(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x)) if not isinstance(x, torch.Tensor) else x


def convert_hf_state_dict(state_dict: Dict[str, Any], config,
                          arch: DecoderArch = None) -> Dict[str, Any]:
    """An EAGLE / EAGLE3 draft checkpoint -> the draft's params dict on the
    CPU, in the arch's dtype (the JAX package's conversion, leaf for leaf)."""
    arch = arch or build_arch(config)
    dt = to_torch_dtype(arch.dtype)
    # strip HF "model." prefixes once so the probes below are uniform
    sd = {k[len("model."):] if k.startswith("model.") else k: v for k, v in state_dict.items()}

    # official drafts have no input layernorm in layer 0: a placeholder
    # weight (never read: the skip flag bypasses it) and the flag
    skip = torch.zeros((arch.num_layers,), dtype=torch.bool)
    for i in range(arch.num_layers):
        key = f"layers.{i}.input_layernorm.weight"
        if key not in sd:
            sd[key] = torch.ones((arch.hidden_size,), dtype=dt)
            skip[i] = True
    had_norm = "norm.weight" in sd
    if not had_norm:
        sd["norm.weight"] = torch.ones((arch.hidden_size,), dtype=dt)

    # EAGLE3's reduced vocab: the draft EMBEDS target-vocab ids (the borrowed
    # target table) and its lm_head scores the draft vocab; d2t maps its
    # choices back. The dense converter assumes one vocab, so it gets a
    # placeholder embedding and the target's table goes in afterwards.
    is_eagle3 = bool(config.tpu_config.is_eagle3)
    target_embed = None
    if is_eagle3:
        target_embed = _tensor(sd["embed_tokens.weight"]).to(dt)
        sd["embed_tokens.weight"] = torch.zeros((config.vocab_size, arch.hidden_size), dtype=dt)
    else:
        sd.pop("d2t", None)  # nothing to translate without a reduced vocab

    params = dense.convert_hf_state_dict(sd, config, arch)
    if not had_norm:
        del params["norm"]
    params["layers"]["input_norm_skip"] = skip
    if target_embed is not None:
        tp = config.tpu_config.tp_degree
        pad = (-target_embed.shape[0]) % tp
        if pad:
            target_embed = torch.cat([target_embed, target_embed.new_zeros((pad, arch.hidden_size))])
        params["embed_tokens"] = target_embed.contiguous()

    def proj(prefix):
        # biases are always present (zeros when the checkpoint has none)
        w = _tensor(sd[f"{prefix}.weight"]).to(dt).t().contiguous()
        b = (_tensor(sd[f"{prefix}.bias"]).to(dt) if f"{prefix}.bias" in sd
             else torch.zeros((w.shape[1],), dtype=dt))
        return {"w": w, "b": b.contiguous()}

    params["fc"] = proj("fc")
    if "fc_features.weight" in sd:
        params["fc_features"] = proj("fc_features")
    elif is_eagle3:
        raise KeyError(
            "is_eagle3 requires an fc_features.weight in the draft checkpoint "
            "(projects the concatenated target aux hidden states)")
    if is_eagle3:
        draft_vocab = arch.vocab_size - arch.vocab_pad
        params["d2t"] = (_tensor(sd["d2t"]).to(torch.int32).contiguous() if "d2t" in sd
                         else torch.arange(draft_vocab, dtype=torch.int32))
    return params


def random_params(config, target_params: Dict[str, Any], *, target_num_layers: int,
                  seed: int = 1, std: float = 0.02, device=None) -> Dict[str, Any]:
    """A random draft in :func:`convert_hf_state_dict`'s layout, as the
    application builds it for ``target_params``: the dense layers from
    ``dense.random_params`` (seed ``seed``), every layer skipping its input
    norm, no final norm, the target's embedding (shared), the target's
    lm_head (tied: its embedding) or, for EAGLE3's reduced vocab, a random
    one, random ``fc`` / ``fc_features`` weights with zero biases and a
    random ``d2t`` (distinct target ids)."""
    from nxdi_tpu_torch.runtime.device import resolve_device

    device = resolve_device(device)
    arch = build_arch(config)
    dt = to_torch_dtype(arch.dtype)
    params = dense.random_params(arch, seed=seed, std=std, device=device)
    del params["norm"]
    params["layers"]["input_norm_skip"] = torch.ones((arch.num_layers,), dtype=torch.bool,
                                                     device=device)
    embed = target_params["embed_tokens"]
    params["embed_tokens"] = embed
    is_eagle3 = bool(config.tpu_config.is_eagle3)
    if not is_eagle3:
        head = target_params.get("lm_head")
        params["lm_head"] = head if head is not None else embed.t().contiguous()
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    H = arch.hidden_size

    def proj(n_in):
        w = torch.randn((n_in, H), generator=gen, dtype=torch.float32, device=device) * std
        return {"w": w.to(dt), "b": torch.zeros((H,), dtype=dt, device=device)}

    params["fc"] = proj(2 * H)
    if is_eagle3:
        k = len(eagle3_aux_indices_default(target_num_layers))
        params["fc_features"] = proj(k * embed.shape[1])
        params["d2t"] = torch.randperm(embed.shape[0], generator=gen, device=device)[
            : arch.vocab_size - arch.vocab_pad].to(torch.int32)
    return params


def eagle3_aux_indices_default(target_num_layers: int):
    """Which target layers feed the EAGLE3 feature concat: an early, a
    middle and a late layer (clamped for small models)."""
    L = target_num_layers
    return tuple(sorted({max(0, min(L - 1, i)) for i in (1, L // 2, L - 2)}))
