"""Orion family (counterpart of ``nxdi_tpu/models/orion/modeling_orion.py``):
the Llama block whose input, post-attention and final norms are biased
LayerNorms (eps ``rms_norm_eps``), with no projection biases."""

from __future__ import annotations

from typing import Any, Dict

from nxdi_tpu_torch.config import InferenceConfig, to_torch_dtype
from nxdi_tpu_torch.models import dense
from nxdi_tpu_torch.models.base import DecoderArch

build_inv_freq = dense.build_inv_freq


class OrionInferenceConfig(dense.DenseInferenceConfig):
    pass


def build_arch(config: InferenceConfig, **overrides) -> DecoderArch:
    kwargs = dict(layernorm=True)
    kwargs.update(overrides)
    return dense.build_arch(config, **kwargs)


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
