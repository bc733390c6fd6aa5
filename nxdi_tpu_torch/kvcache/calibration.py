"""KV-cache quantization scale calibration — the port's copy of
``nxdi_tpu/kvcache/calibration.py``.

Prefill sample prompts on an UNQUANTIZED app, read the contiguous cache
(``(L, B, KV, S, D)``, the K/V activations themselves) and reduce its
abs-max per layer (``per_tensor``), per kv head (``per_key``) or per
head-dim channel (``per_channel``). A scale is ``margin * absmax /
dtype_max``, so the stored ``x / scale`` spans the store dtype's range with
headroom.

Usage::

    scales = calibrate_kv_scales(app, prompts, mode="per_channel")
    save_kv_scales("scales.npz", scales)
    tc = TorchConfig(..., kv_quant_config=dict(
        dtype="float8_e4m3", scale_mode="per_channel",
        scales_path="scales.npz"))
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

_DTYPE_MAX = {
    "float8_e4m3": 448.0,  # e4m3fn max normal
    "float8_e5m2": 57344.0,
    "int8": 127.0,
}


def _reduce(a: np.ndarray, mode: str) -> np.ndarray:
    """abs-max of the cache stack (L, B, KV, S, D) down to the scale shape."""
    mag = np.abs(a.astype(np.float32))
    if mode == "per_tensor":
        return mag.max(axis=(1, 2, 3, 4))  # (L,)
    if mode == "per_key":
        return mag.max(axis=(1, 3, 4))  # (L, KV)
    if mode == "per_channel":
        return mag.max(axis=(1, 2, 3))  # (L, D)
    raise ValueError(f"unknown calibration mode {mode!r}")


def calibrate_kv_scales(
    app,
    prompts: Sequence[Sequence[int]],
    mode: str = "per_channel",
    store_dtype: str = "float8_e4m3",
    margin: float = 2.0,
) -> Dict[str, np.ndarray]:
    """Prefill each prompt on ``app`` (which must NOT quantize its KV cache)
    and return ``{"k_scales", "v_scales"}`` float32 abs-max scales. Zero
    slots add 0 to the max, so short prompts are safe; a floor of 1e-6
    keeps dead heads and channels off a zero scale."""
    if app.tpu_config.kv_quant_config is not None:
        raise ValueError(
            "calibrate on an app WITHOUT kv_quant_config (the cache must hold "
            "unquantized K/V activations)"
        )
    k_max = v_max = None
    for prompt in prompts:
        app.reset_kv_cache()
        ids = np.asarray([list(prompt)], dtype=np.int32)
        pos = np.arange(ids.shape[1], dtype=np.int32)[None, :]
        app.forward(ids, pos, last_token_index=np.array([ids.shape[1] - 1], np.int32))
        km = _reduce(app.kv_cache["k"].float().cpu().numpy(), mode)
        vm = _reduce(app.kv_cache["v"].float().cpu().numpy(), mode)
        k_max = km if k_max is None else np.maximum(k_max, km)
        v_max = vm if v_max is None else np.maximum(v_max, vm)
    app.reset_kv_cache()
    fmax = _DTYPE_MAX[store_dtype]
    return {
        "k_scales": np.maximum(margin * k_max / fmax, 1e-6).astype(np.float32),
        "v_scales": np.maximum(margin * v_max / fmax, 1e-6).astype(np.float32),
    }


def save_kv_scales(path: str, scales: Dict[str, np.ndarray]) -> None:
    np.savez(path, **scales)


def load_kv_scales(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        return {"k_scales": z["k_scales"], "v_scales": z["v_scales"]}
