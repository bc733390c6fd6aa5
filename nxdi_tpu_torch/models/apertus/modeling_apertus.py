"""Apertus family (counterpart of
``nxdi_tpu/models/apertus/modeling_apertus.py``): per-head q / k RMSNorm
before rope, ``attention_layernorm`` / ``feedforward_layernorm`` pre-norms
(renamed onto the standard keys) and a NON-gated ``up_proj`` / ``down_proj``
MLP with the xIELU activation (:func:`~nxdi_tpu_torch.models.base.xielu`),
whose per-layer ``alpha_p`` / ``alpha_n`` ride the MLP params as
``mlp.xielu``. HF's XIELUActivation keeps its learnables in bf16 whatever
the model's dtype, so the converter bakes the post-softplus values with
that rounding, in float32."""

from __future__ import annotations

from typing import Any, Dict

import torch

from nxdi_tpu_torch.config import InferenceConfig
from nxdi_tpu_torch.models import dense
from nxdi_tpu_torch.models.base import DecoderArch

build_inv_freq = dense.build_inv_freq


class ApertusInferenceConfig(dense.DenseInferenceConfig):
    def add_derived_config(self):
        if not hasattr(self, "hidden_act"):
            self.hidden_act = "xielu"
        super().add_derived_config()
        if self.hidden_act != "xielu":
            raise NotImplementedError(
                f"apertus hidden_act {self.hidden_act!r} is not supported (xielu only)")


def build_arch(config: InferenceConfig, **overrides) -> DecoderArch:
    kwargs = dict(
        qk_norm=True,
        gated_mlp=False,
        hidden_act="xielu",
        attention_bias=bool(getattr(config, "attention_bias", False)),
        mlp_bias=bool(getattr(config, "mlp_bias", False)),
    )
    kwargs.update(overrides)
    return dense.build_arch(config, **kwargs)


def _softplus_bf16(x) -> torch.Tensor:
    """softplus as HF computes it: on the bf16 parameter, rounded to bf16,
    then widened to float32."""
    xb = torch.as_tensor(x).to(torch.bfloat16).double()
    return torch.log1p(torch.exp(xb)).to(torch.bfloat16).float()


def xielu_scalars(alpha_p, alpha_n) -> Dict[str, torch.Tensor]:
    """The layer's xIELU params from HF's raw learnables: softplus(alpha_p)
    and softplus(alpha_n) + beta (0.5), each rounded as bf16, in float32."""
    an = (_softplus_bf16(alpha_n).to(torch.bfloat16)
          + torch.tensor(0.5, dtype=torch.bfloat16)).float()
    return {"alpha_p": _softplus_bf16(alpha_p).reshape(-1), "alpha_n": an.reshape(-1)}


def convert_hf_state_dict(state_dict: Dict[str, Any], config: InferenceConfig) -> Dict[str, Any]:
    arch = build_arch(config)
    sd = {}
    for k, v in state_dict.items():
        sd[k.replace("attention_layernorm", "input_layernorm").replace(
            "feedforward_layernorm", "post_attention_layernorm")] = v

    def ff(get, has, cast, pre):
        mlp = {"up_proj": {"w": cast(get(pre + "mlp.up_proj.weight").t())},
               "down_proj": {"w": cast(get(pre + "mlp.down_proj.weight").t())}}
        mlp["xielu"] = xielu_scalars(get(pre + "mlp.act_fn.alpha_p"),
                                     get(pre + "mlp.act_fn.alpha_n"))
        return "mlp", mlp

    return dense.convert_hf_state_dict(sd, config, arch, ff_converter=ff)


def random_params(config: InferenceConfig, seed: int = 0, device=None) -> Dict[str, Any]:
    """Random weights (dense.random_params, the xIELU scalars at HF's
    initial 0.8)."""
    return dense.random_params(build_arch(config), seed=seed, device=device)
