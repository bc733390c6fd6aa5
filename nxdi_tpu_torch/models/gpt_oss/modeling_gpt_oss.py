"""gpt-oss family (counterpart of ``nxdi_tpu/models/gpt_oss/modeling_gpt_oss.py``):
learned per-head attention sinks joining every softmax and dropping their
mass (``attention_sink``, params ``attn.sink``), sliding-window and full
layers alternating through the ``use_sliding_window`` flags
(``DecoderArch.kv_window_pattern`` on the host: under ``window_sized_kv``
the window layers keep a W-slot ring stack beside the full layers'
full-length cache), q / k / v / o biases, YaRN rope with its
attention factor on cos / sin (``rope_mscale``, from ``dense.build_arch``),
and MoE layers whose router takes the top-k logits, then their softmax, over
experts with biases and the clamped GLU ``(up + 1) * gate *
sigmoid(1.702 * gate)``.

No attention kernel takes the sink column (the JAX rule): on the card the
attention kernel flags must be off for this family (an enabled one raises),
and the commit kernel still lands the deferred decode's rows. MXFP4
checkpoints are not ported; bf16 weights serve.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from nxdi_tpu_torch.config import InferenceConfig
from nxdi_tpu_torch.models import dense
from nxdi_tpu_torch.models.base import DecoderArch
from nxdi_tpu_torch.ops.moe import MoEArch
from nxdi_tpu_torch.parallel import gqa

GLU_ALPHA = 1.702
GLU_LIMIT = 7.0

# gpt-oss-20b at its published widths (HF openai/gpt-oss-20b config.json; the
# published weights are MXFP4, random bf16 weights serve here)
GPT_OSS_20B = dict(
    hidden_size=2880,
    intermediate_size=2880,
    num_hidden_layers=24,
    num_attention_heads=64,
    num_key_value_heads=8,
    head_dim=64,
    num_local_experts=32,
    num_experts_per_tok=4,
    sliding_window=128,
    layer_types=["sliding_attention" if i % 2 == 0 else "full_attention" for i in range(24)],
    vocab_size=201088,
    rms_norm_eps=1e-5,
    rope_theta=150000.0,
    rope_scaling=dict(rope_type="yarn", factor=32.0, beta_fast=32.0, beta_slow=1.0,
                      truncate=False, original_max_position_embeddings=4096),
    max_position_embeddings=131072,
    tie_word_embeddings=False,
    hidden_act="silu",
)


class GptOssInferenceConfig(dense.DenseInferenceConfig):
    REQUIRED = dense.DenseInferenceConfig.REQUIRED + [
        "num_local_experts",
        "num_experts_per_tok",
        "head_dim",
    ]

    def add_derived_config(self):
        super().add_derived_config()
        self.attention_bias = True
        if not hasattr(self, "sliding_window"):
            self.sliding_window = None


def _moe_arch(config: InferenceConfig) -> MoEArch:
    return MoEArch(
        num_experts=config.num_local_experts,
        top_k=config.num_experts_per_tok,
        intermediate_size=config.intermediate_size,
        topk_softmax=True,
        router_bias=True,
        expert_bias=True,
        gptoss_glu=True,
        glu_limit=GLU_LIMIT,
        glu_alpha=GLU_ALPHA,
        dispatch=config.tpu_config.moe_dispatch,
    )


build_inv_freq = dense.build_inv_freq  # yarn (ops/rope.py)


def sliding_flags(config: InferenceConfig) -> Tuple[bool, ...]:
    """Per layer, whether it is a sliding-window layer: ``layer_types``, or
    gpt-oss's default (even layers slide)."""
    lt = getattr(config, "layer_types", None)
    if lt:
        return tuple(t == "sliding_attention" for t in lt[: config.num_hidden_layers])
    return tuple(i % 2 == 0 for i in range(config.num_hidden_layers))


def build_arch(config: InferenceConfig, **overrides) -> DecoderArch:
    sw = getattr(config, "sliding_window", None)
    kwargs = dict(moe=_moe_arch(config), attention_sink=True, attention_o_bias=True,
                  sliding_window=sw, kv_window_pattern=sliding_flags(config) if sw else None)
    kwargs.update(overrides)
    return dense.build_arch(config, **kwargs)


def convert_hf_state_dict(state_dict: Dict[str, Any], config: InferenceConfig) -> Dict[str, Any]:
    arch = build_arch(config)
    plan = dense.gqa_plan(config)

    def get(name):
        for k in (name, f"model.{name}"):
            if k in state_dict:
                return torch.as_tensor(state_dict[k])
        raise KeyError(name)

    def ff(g, has, cast, pre):
        src = pre + "mlp."
        gu = get(src + "experts.gate_up_proj")  # (E, H, 2I), gate and up interleaved
        gub = get(src + "experts.gate_up_proj_bias")  # (E, 2I)
        return "moe", {
            "router": {"w": cast(get(src + "router.weight").t()),
                       "b": cast(get(src + "router.bias"))},
            "experts": {
                "gate_proj": {"w": cast(gu[..., ::2]), "b": cast(gub[..., ::2])},
                "up_proj": {"w": cast(gu[..., 1::2]), "b": cast(gub[..., 1::2])},
                "down_proj": {"w": cast(get(src + "experts.down_proj")),
                              "b": cast(get(src + "experts.down_proj_bias"))},
            },
        }

    params = dense.convert_hf_state_dict(state_dict, config, arch, ff_converter=ff)
    dt = params["norm"].dtype
    # the sinks follow the q heads' order: the q weights' permutation and pad
    # (a padded head's sink is never read: its o_proj columns are zero)
    params["layers"]["attn"]["sink"] = torch.stack([
        gqa.convert_q(get(f"layers.{i}.self_attn.sinks").to(dt)[:, None], 1, plan)[:, 0]
        for i in range(arch.num_layers)])
    params["layers"]["use_sliding_window"] = torch.tensor(sliding_flags(config))
    return params


def random_params(config: InferenceConfig, seed: int = 0, device=None) -> Dict[str, Any]:
    """Random weights (dense.random_params: sinks N(0, 0.02)) with the
    layer-type flags, on ``device``."""
    params = dense.random_params(build_arch(config), seed=seed, device=device)
    params["layers"]["use_sliding_window"] = torch.tensor(sliding_flags(config),
                                                          device=params["norm"].device)
    return params
