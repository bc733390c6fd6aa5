"""StableLM-2 family (counterpart of
``nxdi_tpu/models/stablelm/modeling_stablelm.py``): rope over ``head_dim *
partial_rotary_factor`` channels, biased LayerNorms (``layer_norm_eps``), a
gated silu MLP, optional q/k/v biases (``use_qkv_bias``) and no o bias. The
per-head q/k LayerNorm and the parallel residual are refused, as the JAX
package refuses them."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from nxdi_tpu_torch.config import InferenceConfig, to_torch_dtype
from nxdi_tpu_torch.models import dense
from nxdi_tpu_torch.models.base import DecoderArch
from nxdi_tpu_torch.ops.rope import default_inv_freq


class StableLmInferenceConfig(dense.DenseInferenceConfig):
    def add_derived_config(self):
        self.rms_norm_eps = getattr(self, "layer_norm_eps", 1e-5)
        if not hasattr(self, "partial_rotary_factor"):
            self.partial_rotary_factor = 0.25
        if not hasattr(self, "use_qkv_bias"):
            self.use_qkv_bias = False
        super().add_derived_config()
        if getattr(self, "qk_layernorm", False):
            raise NotImplementedError("stablelm per-head qk LayerNorm is not supported yet")
        if getattr(self, "use_parallel_residual", False):
            raise NotImplementedError("stablelm parallel residual is not supported yet")


def _rotary_dim(config) -> int:
    return int(config.hidden_size // config.num_attention_heads * config.partial_rotary_factor)


def build_arch(config: InferenceConfig, **overrides) -> DecoderArch:
    kwargs = dict(
        layernorm=True,
        attention_bias=bool(getattr(config, "use_qkv_bias", False)),
        rotary_dim=_rotary_dim(config),
    )
    kwargs.update(overrides)
    return dense.build_arch(config, **kwargs)


def build_inv_freq(config: InferenceConfig) -> np.ndarray:
    return default_inv_freq(_rotary_dim(config), getattr(config, "rope_theta", 10000.0))


def convert_hf_state_dict(state_dict: Dict[str, Any], config: InferenceConfig) -> Dict[str, Any]:
    arch = build_arch(config)
    L = arch.num_layers

    def src(name):
        return dense.state_tensor(state_dict, name)

    params = dense.convert_hf_state_dict(state_dict, config, arch)
    return dense.attach_norm_biases(
        params, [src(f"layers.{i}.input_layernorm.bias") for i in range(L)],
        [src(f"layers.{i}.post_attention_layernorm.bias") for i in range(L)],
        src("norm.bias"), to_torch_dtype(arch.dtype))


def random_params(config: InferenceConfig, seed: int = 0, device=None) -> Dict[str, Any]:
    """Random weights (dense.random_params) with the biased norms."""
    arch = build_arch(config)
    return dense.random_params(arch, seed=seed, device=device,
                               shapes=dense.param_shapes(arch, norm_bias=True))
