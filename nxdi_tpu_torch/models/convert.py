"""Carry weights across from the JAX package.

:func:`from_jax_params` turns the JAX package's parameter pytree — as numpy
arrays, which is what its application holds after ``jax.device_get`` — into
this port's params dict. Both packages use the same keys and the same
(in, out) weight layout (the interleaved ``qkv_proj`` of ``fused_qkv``
included), so the conversion is leaf by leaf, at any depth: a fused
speculation app's ``{"draft": ..., "target": ...}`` pair and a Medusa app's
``medusa_heads`` (``res_w``, ``res_b``, ``head``) carry across as they are,
and so does a segmented stack's list of layer segments (DeepSeek, AFMoE),
and the last dense families' leaves: ``position_embeddings``, Phi's float32
``lm_head_bias``, Apertus's float32 ``mlp.xielu`` scalars and Persimmon's
biased q / k norms (``{"w", "b"}``).
Quantized linears (``qw`` / ``scale``, MXFP4 ``qw4``, ``input_scale``)
carry across the same way.
bfloat16 and fp8 arrays (numpy extension dtypes) move as their raw bits —
``uint16`` / ``uint8`` views reinterpreted as the torch dtype — without
importing the package that defines those dtypes and without a float round
trip.
"""

from __future__ import annotations

import numpy as np
import torch


# numpy extension dtypes by name -> (the unsigned view of their bits, torch dtype)
_BIT_VIEWS = {
    "bfloat16": (np.uint16, torch.bfloat16),
    "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
    "float8_e5m2": (np.uint8, torch.float8_e5m2),
}


def _leaf(x) -> torch.Tensor:
    arr = np.asarray(x)
    if arr.dtype.name in _BIT_VIEWS:
        view, dt = _BIT_VIEWS[arr.dtype.name]
        return torch.from_numpy(np.ascontiguousarray(arr).view(view).copy()).view(dt)
    return torch.from_numpy(np.array(arr, copy=True))


def from_jax_params(params):
    """JAX-package params pytree (nested dicts of numpy arrays; a segmented
    stack's ``layers`` is a list of dicts) -> the port's params of CPU
    tensors with the same keys, structure, shapes and dtypes."""
    if isinstance(params, (list, tuple)):
        return [from_jax_params(v) for v in params]
    if isinstance(params, dict):
        return {k: from_jax_params(v) for k, v in params.items()}
    return _leaf(params)
