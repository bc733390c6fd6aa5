"""Carry weights across from the JAX package.

:func:`from_jax_params` turns the JAX package's parameter pytree — as numpy
arrays, which is what its application holds after ``jax.device_get`` — into
this port's params dict. Both packages use the same keys and the same
(in, out) weight layout (the interleaved ``qkv_proj`` of ``fused_qkv``
included), so the conversion is leaf by leaf; bfloat16 arrays
(a numpy extension dtype) are reinterpreted bit for bit, without importing
the package that defines that dtype.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def _leaf(x) -> torch.Tensor:
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16).copy()).view(
            torch.bfloat16
        )
    return torch.from_numpy(np.array(arr, copy=True))


def from_jax_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """JAX-package params pytree (nested dicts of numpy arrays) -> the port's
    params dict of CPU tensors with the same keys, shapes and dtypes."""
    return {
        k: from_jax_params(v) if isinstance(v, dict) else _leaf(v)
        for k, v in params.items()
    }
