"""Speculative decoding (counterpart of ``nxdi_tpu/speculation``): the
draft-model pair, fused draft + verify windows, EAGLE and EAGLE3 (chain,
static and dynamic token trees), token trees and Medusa."""

from nxdi_tpu_torch.speculation.application import (
    EagleSpecCausalLM,
    FusedSpecCausalLM,
    MedusaCausalLM,
)
from nxdi_tpu_torch.speculation.eagle import (
    EagleSpecWrapper,
    eagle_context_encoding,
    eagle_dynamic_tree_token_gen,
    eagle_token_gen,
    eagle_tree_token_gen,
)
from nxdi_tpu_torch.speculation.fused import (
    FusedSpecWrapper,
    fused_spec_context_encoding,
    fused_spec_token_gen,
)
from nxdi_tpu_torch.speculation.medusa import (
    MedusaWrapper,
    medusa_context_encoding,
    medusa_token_gen,
    medusa_tree_token_gen,
)
from nxdi_tpu_torch.speculation.standard import SpecTargetCausalLM, StandardSpecCausalLM
from nxdi_tpu_torch.speculation.token_tree import DynamicTreeSpec, TokenTree

__all__ = [
    "DynamicTreeSpec",
    "EagleSpecCausalLM",
    "EagleSpecWrapper",
    "FusedSpecCausalLM",
    "FusedSpecWrapper",
    "MedusaCausalLM",
    "MedusaWrapper",
    "SpecTargetCausalLM",
    "StandardSpecCausalLM",
    "TokenTree",
    "eagle_context_encoding",
    "eagle_dynamic_tree_token_gen",
    "eagle_token_gen",
    "eagle_tree_token_gen",
    "fused_spec_context_encoding",
    "fused_spec_token_gen",
    "medusa_context_encoding",
    "medusa_token_gen",
    "medusa_tree_token_gen",
]
