"""Model-family registry (counterpart of ``nxdi_tpu/models/registry.py``):
HF ``model_type`` -> the port's family module and its config class.

A family module exposes ``build_arch``, ``build_inv_freq``,
``convert_hf_state_dict`` and an ``*InferenceConfig`` class; an app is
``TorchModelForCausalLM(path, cfg_cls(TorchConfig(...), load_config=...),
model_family=module)``.

:data:`NOT_PORTED` lists the model types the JAX package registers that the
port does not serve yet: :func:`get_family` raises ``NotImplementedError``
for them, naming the type, and ``KeyError`` for a type neither package
registers.
"""

from __future__ import annotations

import importlib
from typing import Dict, Tuple

_M = "nxdi_tpu_torch.models"

_REGISTRY: Dict[str, Tuple[str, str]] = {
    # model_type -> (module path, config class name)
    "llama": (f"{_M}.llama.modeling_llama", "LlamaInferenceConfig"),
    "mixtral": (f"{_M}.mixtral.modeling_mixtral", "MixtralInferenceConfig"),
    "deepseek_v3": (f"{_M}.deepseek.modeling_deepseek", "DeepseekInferenceConfig"),
    "deepseek": (f"{_M}.deepseek.modeling_deepseek", "DeepseekInferenceConfig"),
    "mistral": (f"{_M}.mistral.modeling_mistral", "MistralInferenceConfig"),
    "qwen2": (f"{_M}.qwen2.modeling_qwen2", "Qwen2InferenceConfig"),
    "qwen3": (f"{_M}.qwen3.modeling_qwen3", "Qwen3InferenceConfig"),
    "hunyuan_v1_dense": (f"{_M}.hunyuan.modeling_hunyuan", "HunYuanInferenceConfig"),
    "gemma": (f"{_M}.gemma.modeling_gemma", "GemmaInferenceConfig"),
    "helium": (f"{_M}.helium.modeling_helium", "HeliumInferenceConfig"),
    "ernie4_5": (f"{_M}.ernie4_5.modeling_ernie4_5", "Ernie4_5InferenceConfig"),
    "granite": (f"{_M}.granite.modeling_granite", "GraniteInferenceConfig"),
    "minicpm": (f"{_M}.minicpm.modeling_minicpm", "MiniCPMInferenceConfig"),
    "minicpm4": (f"{_M}.minicpm.modeling_minicpm", "MiniCPMInferenceConfig"),
    "seed_oss": (f"{_M}.seed_oss.modeling_seed_oss", "SeedOssInferenceConfig"),
    "internlm3": (f"{_M}.internlm3.modeling_internlm3", "InternLM3InferenceConfig"),
    "smollm3": (f"{_M}.smollm3.modeling_smollm3", "SmolLM3InferenceConfig"),
    "olmo2": (f"{_M}.olmo2.modeling_olmo2", "Olmo2InferenceConfig"),
    "arcee": (f"{_M}.arcee.modeling_arcee", "ArceeInferenceConfig"),
    "ministral": (f"{_M}.ministral.modeling_ministral", "MinistralInferenceConfig"),
    "qwen3_moe": (f"{_M}.qwen3_moe.modeling_qwen3_moe", "Qwen3MoeInferenceConfig"),
    "phi3": (f"{_M}.phi3.modeling_phi3", "Phi3InferenceConfig"),
    "phimoe": (f"{_M}.phimoe.modeling_phimoe", "PhimoeInferenceConfig"),
    "dbrx": (f"{_M}.dbrx.modeling_dbrx", "DbrxInferenceConfig"),
    "minimax_m2": (f"{_M}.minimax_m2.modeling_minimax_m2", "MiniMaxM2InferenceConfig"),
    "gpt_oss": (f"{_M}.gpt_oss.modeling_gpt_oss", "GptOssInferenceConfig"),
    "afmoe": (f"{_M}.afmoe.modeling_afmoe", "AfmoeInferenceConfig"),
    "gemma3_text": (f"{_M}.gemma3.modeling_gemma3", "Gemma3InferenceConfig"),
    "gemma2": (f"{_M}.gemma2.modeling_gemma2", "Gemma2InferenceConfig"),
    "vaultgemma": (f"{_M}.vaultgemma.modeling_vaultgemma", "VaultGemmaInferenceConfig"),
    "llama4": (f"{_M}.llama4.modeling_llama4", "Llama4InferenceConfig"),
    "llama4_text": (f"{_M}.llama4.modeling_llama4", "Llama4InferenceConfig"),
    "cohere2": (f"{_M}.cohere2.modeling_cohere2", "Cohere2InferenceConfig"),
    "exaone4": (f"{_M}.exaone4.modeling_exaone4", "Exaone4InferenceConfig"),
    "olmo3": (f"{_M}.olmo3.modeling_olmo3", "Olmo3InferenceConfig"),
    "starcoder2": (f"{_M}.starcoder2.modeling_starcoder2", "Starcoder2InferenceConfig"),
    "falcon": (f"{_M}.falcon.modeling_falcon", "FalconInferenceConfig"),
    "gpt_neox": (f"{_M}.gpt_neox.modeling_gpt_neox", "GPTNeoXInferenceConfig"),
    "phi": (f"{_M}.phi.modeling_phi", "PhiInferenceConfig"),
    "glm4": (f"{_M}.glm4.modeling_glm4", "Glm4InferenceConfig"),
    "stablelm": (f"{_M}.stablelm.modeling_stablelm", "StableLmInferenceConfig"),
    "persimmon": (f"{_M}.persimmon.modeling_persimmon", "PersimmonInferenceConfig"),
    "apertus": (f"{_M}.apertus.modeling_apertus", "ApertusInferenceConfig"),
    "orion": (f"{_M}.orion.modeling_orion", "OrionInferenceConfig"),
    "opt": (f"{_M}.opt.modeling_opt", "OPTInferenceConfig"),
    "biogpt": (f"{_M}.biogpt.modeling_biogpt", "BioGptInferenceConfig"),
    "xglm": (f"{_M}.xglm.modeling_xglm", "XGLMInferenceConfig"),
    "gpt2": (f"{_M}.gpt2.modeling_gpt2", "GPT2InferenceConfig"),
    "gpt_bigcode": (f"{_M}.gpt_bigcode.modeling_gpt_bigcode", "GPTBigCodeInferenceConfig"),
    "mimo_v2": (f"{_M}.mimo_v2.modeling_mimo_v2", "MiMoV2InferenceConfig"),
    "lfm2": (f"{_M}.lfm2.modeling_lfm2", "Lfm2InferenceConfig"),
}

# registered by the JAX package, not ported yet (ROADMAP Queue 1)
NOT_PORTED = frozenset({
    "gemma3", "pixtral", "mistral3", "ovis2",
    "llava", "mllama", "qwen2_vl", "qwen3_vl", "qwen2_5_vl",
    "qwen3_next", "recurrent_gemma",
    "recurrentgemma", "qwen2_5_omni", "qwen2_5_omni_thinker", "falcon_h1",
    "janus", "idefics",
})


def register(model_type: str, module_path: str, config_cls_name: str) -> None:
    _REGISTRY[model_type] = (module_path, config_cls_name)


def get_family(model_type: str):
    """(family module, config class) of ``model_type``."""
    if model_type not in _REGISTRY:
        if model_type in NOT_PORTED:
            raise NotImplementedError(
                f"model_type {model_type!r} is registered by the JAX package but not ported "
                f"yet; ported: {sorted(_REGISTRY)}")
        raise KeyError(f"Unknown model_type {model_type!r}; registered: {sorted(_REGISTRY)}")
    module_path, cfg_name = _REGISTRY[model_type]
    module = importlib.import_module(module_path)
    return module, getattr(module, cfg_name)


def known_model_types():
    return sorted(_REGISTRY)
