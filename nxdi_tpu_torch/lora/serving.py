"""Multi-adapter LoRA serving — the port of ``nxdi_tpu/lora/serving.py``.

Every targeted projection's param dict carries slot-stacked buffers

    ``lora_A``     (L, S, in, r)   — S = max_loras + 1 slots, slot 0 = base
    ``lora_B``     (L, S, r, out)
    ``lora_scale`` (L, S)

and ``models/base._linear`` adds ``((x @ A[id]) @ B[id]) * s`` per batch row,
the slot chosen by the ``adapter_ids`` batch input: one CUDA graph per bucket
serves any mix of adapters. Slot 0 stays all zeros, so ``adapter_id=0``
serves the base model.

More adapters than slots: :class:`AdapterCache`, a host-side LRU that writes
an adapter's weights into a device slot between requests. The writes go
into the buffers IN PLACE (``copy_`` into the slot), never into new
tensors: a captured graph keeps reading the addresses it was captured over,
and a replay checks them (:func:`lora_pointers`), so a swap after capture is
seen by the next replay.

GQA: adapters target the checkpoint's head layout; k/v ``lora_B`` and the
o-proj ``lora_A`` go through the same head replication and padding as the
base weights (``parallel/gqa.py``; the identity at the port's tp 1).

Not ported: the JAX package's ``lora_spec_update`` and ``lora_shape_struct``
(sharding specs and abstract shapes; the port runs on one device).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import torch

from nxdi_tpu_torch import checkpoint as ckpt
from nxdi_tpu_torch.config import to_torch_dtype
from nxdi_tpu_torch.parallel import gqa

# module name -> (path under params["layers"], HF checkpoint scope)
LORA_TARGETABLE_MODULES = {
    "q_proj": (("attn", "q_proj"), "self_attn"),
    "k_proj": (("attn", "k_proj"), "self_attn"),
    "v_proj": (("attn", "v_proj"), "self_attn"),
    "o_proj": (("attn", "o_proj"), "self_attn"),
    "gate_proj": (("mlp", "gate_proj"), "mlp"),
    "up_proj": (("mlp", "up_proj"), "mlp"),
    "down_proj": (("mlp", "down_proj"), "mlp"),
}


def _module_dims(arch, name: str) -> Tuple[int, int]:
    """(in_features, out_features) of a targeted projection in the padded
    on-device layout."""
    H, KV, D = arch.num_attention_heads, arch.num_kv_heads, arch.head_dim
    hs, inter = arch.hidden_size, arch.intermediate_size
    return {
        "q_proj": (hs, H * D),
        "k_proj": (hs, KV * D),
        "v_proj": (hs, KV * D),
        "o_proj": (H * D, hs),
        "gate_proj": (hs, inter),
        "up_proj": (hs, inter),
        "down_proj": (inter, hs),
    }[name]


# ---------------------------------------------------------------------------
# Adapter checkpoint ingestion
# ---------------------------------------------------------------------------

ADAPTER_CONFIG = "adapter_config.json"
ADAPTER_FILES = ("adapter_model.safetensors", "adapter_model.bin")


def load_adapter_state_dict(path: str) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """Load a PEFT-format adapter directory (``adapter_model.safetensors`` or
    ``.bin``, and ``adapter_config.json``) through the port's checkpoint
    reader. Returns (state_dict, adapter_config)."""
    cfg = {}
    cfg_path = os.path.join(path, ADAPTER_CONFIG)
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            cfg = json.load(f)
    for name in ADAPTER_FILES:
        file = os.path.join(path, name)
        if os.path.exists(file):
            return ckpt.load_state_dict(file), cfg
    return ckpt.load_state_dict(path), cfg


def _adapter_key(sd: Dict[str, Any], layer: int, scope: str, module: str, ab: str):
    """Probe the common PEFT key spellings for one projection's A/B weight."""
    for prefix in ("base_model.model.model.", "base_model.model.", "model.", ""):
        for suffix in (f"lora_{ab}.weight", f"lora_{ab}.default.weight"):
            k = f"{prefix}layers.{layer}.{scope}.{module}.{suffix}"
            if k in sd:
                return sd[k]
    return None


def convert_peft_adapter(
    sd: Dict[str, Any],
    adapter_cfg: Dict[str, Any],
    config,
    arch,
    lora_cfg,
) -> Dict[str, Dict[str, Any]]:
    """PEFT adapter state dict (tensors or numpy arrays) -> per-module host
    buffers in the padded device layout: {module: {"A": (L, in, r_max),
    "B": (L, r_max, out), "scale": float}}.

    Missing (layer, module) pairs contribute zeros: an adapter may target a
    subset of layers and modules. The rank is zero-padded to
    ``max_lora_rank``; a larger rank raises."""
    dt = to_torch_dtype(lora_cfg.lora_dtype)
    plan = gqa.plan_gqa_sharding(
        config.tpu_config.tp_degree, config.num_attention_heads, config.num_key_value_heads
    )
    D = arch.head_dim
    r_max = lora_cfg.max_lora_rank
    alpha = float(adapter_cfg.get("lora_alpha", lora_cfg.lora_alpha))
    r_cfg = adapter_cfg.get("r")

    out: Dict[str, Dict[str, Any]] = {}
    for name in lora_cfg.target_modules:
        _, scope = LORA_TARGETABLE_MODULES[name]
        fin, fout = _module_dims(arch, name)
        A = torch.zeros((arch.num_layers, fin, r_max), dtype=dt)
        B = torch.zeros((arch.num_layers, r_max, fout), dtype=dt)
        r_used = None
        for layer in range(arch.num_layers):
            a = _adapter_key(sd, layer, scope, name, "A")  # (r, in)
            b = _adapter_key(sd, layer, scope, name, "B")  # (out, r)
            if a is None or b is None:
                continue
            a = torch.as_tensor(a).to(dt)
            b = torch.as_tensor(b).to(dt)
            r = a.shape[0]
            if r > r_max:
                raise ValueError(
                    f"adapter rank {r} exceeds max_lora_rank {r_max} "
                    f"(module {name}, layer {layer})"
                )
            r_used = r
            # the head-layout transforms of the base weights' conversion
            if name in ("k_proj", "v_proj"):
                b = gqa.convert_kv(b, D, plan)  # (out_padded, r)
            elif name == "q_proj":
                b = gqa.convert_q(b, D, plan)
            elif name == "o_proj":
                a = gqa.convert_q(a.t().contiguous(), D, plan).t()  # the head-structured in dim
            A[layer, : a.shape[1], :r] = a.t()
            B[layer, :r, : b.shape[0]] = b.t()
        scale = alpha / float(r_cfg or r_used or r_max)
        out[name] = {"A": A, "B": B, "scale": scale}
    return out


# ---------------------------------------------------------------------------
# Device buffer layout
# ---------------------------------------------------------------------------

def _slots(lora_cfg) -> int:
    return lora_cfg.max_loras + 1  # slot 0 = base model (zeros)


def _lora_skips(arch, group: str) -> bool:
    """MLA attention (q_a / q_b / kv_a / kv_b, other widths) takes no
    adapter, as in the JAX package: only the MLP targets apply."""
    return group == "attn" and getattr(arch, "mla", None) is not None


def _targets(params: Dict[str, Any], names, arch=None):
    """(name, the projection's param dict) of each targeted module the
    params carry: an MoE model has no dense ``mlp`` group, and under MLA
    (``arch`` given) the attention is skipped."""
    layers = params["layers"]
    for name in names:
        group, proj = LORA_TARGETABLE_MODULES[name][0]
        if arch is not None and _lora_skips(arch, group):
            continue
        if group in layers and proj in layers[group]:
            yield name, layers[group][proj]


def attach_lora_buffers(params: Dict[str, Any], arch, lora_cfg, device=None) -> Dict[str, Any]:
    """Add all-zero slot-stacked LoRA buffers to every targeted projection's
    param dict, on ``device`` (the params' embedding's by default)."""
    dt = to_torch_dtype(lora_cfg.lora_dtype)
    S, r, L = _slots(lora_cfg), lora_cfg.max_lora_rank, arch.num_layers
    if device is None:
        device = params["embed_tokens"].device
    for name, p in _targets(params, lora_cfg.target_modules, arch):
        fin, fout = _module_dims(arch, name)
        p["lora_A"] = torch.zeros((L, S, fin, r), dtype=dt, device=device)
        p["lora_B"] = torch.zeros((L, S, r, fout), dtype=dt, device=device)
        p["lora_scale"] = torch.zeros((L, S), dtype=torch.float32, device=device)
    return params


def write_adapter_into_buffers(
    params: Dict[str, Any], slot: int, converted: Dict[str, Dict[str, Any]]
) -> Dict[str, Any]:
    """Write one converted adapter into slot ``slot`` of the buffers, in
    place (their addresses are what captured graphs read). Returns the
    params (the same object)."""
    for name, p in _targets(params, converted):
        if "lora_A" not in p:  # a skipped target (MLA attention)
            continue
        buf = converted[name]
        p["lora_A"][:, slot].copy_(buf["A"])
        p["lora_B"][:, slot].copy_(buf["B"])
        p["lora_scale"][:, slot].fill_(float(buf["scale"]))
    return params


def lora_pointers(params: Dict[str, Any]) -> tuple:
    """The addresses of every LoRA buffer of a params dict (empty without
    LoRA): part of the state a graph replay must find unchanged."""
    layers = params.get("layers") if isinstance(params, dict) else None
    if not isinstance(layers, dict):
        return ()
    ptrs = []
    for (group, proj), _ in LORA_TARGETABLE_MODULES.values():
        p = layers.get(group, {}).get(proj)
        if isinstance(p, dict) and "lora_A" in p:
            ptrs += [p[k].data_ptr() for k in ("lora_A", "lora_B", "lora_scale")]
    return tuple(ptrs)


# ---------------------------------------------------------------------------
# Dynamic multi-LoRA
# ---------------------------------------------------------------------------

class AdapterCache:
    """Host-side LRU of adapters over the device slots. ``ensure(name)``
    returns the slot id, writing the adapter into the slot (evicting the
    least recently used one) when it is not resident."""

    def __init__(self, config, arch, lora_cfg):
        self.config = config
        self.arch = arch
        self.lora_cfg = lora_cfg
        self.slot_of: Dict[str, int] = {}
        self._lru: list = []  # least recent first
        self._host: Dict[str, Dict[str, Dict[str, Any]]] = {}
        self._dirty: set = set()  # re-registered while resident

    @property
    def num_slots(self) -> int:
        return self.lora_cfg.max_loras  # slots 1..max_loras (0 = base)

    def register(self, name: str, path_or_sd, adapter_cfg: Optional[dict] = None):
        """Convert and keep an adapter on the host (no device slot yet)."""
        if isinstance(path_or_sd, str):
            sd, file_cfg = load_adapter_state_dict(path_or_sd)
            adapter_cfg = {**file_cfg, **(adapter_cfg or {})}
        else:
            sd = path_or_sd
            adapter_cfg = adapter_cfg or {}
        self._host[name] = convert_peft_adapter(
            sd, adapter_cfg, self.config, self.arch, self.lora_cfg
        )
        if name in self.slot_of:
            # already resident: its slot is rewritten on the next ensure(),
            # not served stale
            self._dirty.add(name)

    def ensure(self, name: str, params: Dict[str, Any]) -> Tuple[int, Dict[str, Any]]:
        """Slot id of ``name``, written into the device buffers if it is not
        resident (evicting the least recently used adapter when the slots
        are full)."""
        if name not in self._host:
            raise KeyError(f"adapter {name!r} was never registered")
        if name in self.slot_of:
            self._lru.remove(name)
            self._lru.append(name)
            slot = self.slot_of[name]
            if name in self._dirty:
                params = write_adapter_into_buffers(params, slot, self._host[name])
                self._dirty.discard(name)
            return slot, params
        if len(self.slot_of) < self.num_slots:
            slot = len(self.slot_of) + 1  # slot 0 is the base model
        else:
            evicted = self._lru.pop(0)
            slot = self.slot_of.pop(evicted)
            self._dirty.discard(evicted)
        params = write_adapter_into_buffers(params, slot, self._host[name])
        self.slot_of[name] = slot
        self._lru.append(name)
        return slot, params
