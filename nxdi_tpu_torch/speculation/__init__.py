"""Speculative decoding (counterpart of ``nxdi_tpu/speculation``): the
draft-model pair, fused draft + verify windows, token trees and Medusa.
EAGLE is not ported yet."""

from nxdi_tpu_torch.speculation.application import FusedSpecCausalLM, MedusaCausalLM
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
from nxdi_tpu_torch.speculation.token_tree import TokenTree

__all__ = [
    "FusedSpecCausalLM",
    "FusedSpecWrapper",
    "MedusaCausalLM",
    "MedusaWrapper",
    "SpecTargetCausalLM",
    "StandardSpecCausalLM",
    "TokenTree",
    "fused_spec_context_encoding",
    "fused_spec_token_gen",
    "medusa_context_encoding",
    "medusa_token_gen",
    "medusa_tree_token_gen",
]
