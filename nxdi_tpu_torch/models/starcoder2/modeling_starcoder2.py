"""StarCoder2 family (counterpart of
``nxdi_tpu/models/starcoder2/modeling_starcoder2.py``): rope with biases on
every projection (``use_bias``), biased LayerNorms (``norm_epsilon``), a
non-gated ``c_fc`` / ``c_proj`` MLP with the tanh GELU, an optional uniform
sliding window and tied embeddings."""

from __future__ import annotations

from typing import Any, Dict

from nxdi_tpu_torch.config import InferenceConfig, to_torch_dtype
from nxdi_tpu_torch.models import dense
from nxdi_tpu_torch.models.base import DecoderArch

build_inv_freq = dense.build_inv_freq

# StarCoder2-15B at its published widths (HF bigcode/starcoder2-15b
# config.json): 48 query heads over 4 kv heads of 128, windows of 4096, rope
# theta 1e5, biases everywhere, tied embeddings (the config class's default)
STARCODER2_15B = dict(
    hidden_size=6144,
    intermediate_size=24576,
    num_hidden_layers=40,
    num_attention_heads=48,
    num_key_value_heads=4,
    vocab_size=49152,
    max_position_embeddings=16384,
    norm_epsilon=1e-5,
    rope_theta=100000.0,
    sliding_window=4096,
    use_bias=True,
    hidden_act="gelu_pytorch_tanh",
    tie_word_embeddings=True,
)


class Starcoder2InferenceConfig(dense.DenseInferenceConfig):
    def add_derived_config(self):
        self.rms_norm_eps = getattr(self, "norm_epsilon", 1e-5)
        if not hasattr(self, "use_bias"):
            self.use_bias = True
        if not hasattr(self, "tie_word_embeddings"):
            self.tie_word_embeddings = True
        super().add_derived_config()


def build_arch(config: InferenceConfig, **overrides) -> DecoderArch:
    bias = bool(getattr(config, "use_bias", True))
    kwargs = dict(
        layernorm=True,
        gated_mlp=False,
        attention_bias=bias,
        attention_o_bias=bias,
        mlp_bias=bias,
        sliding_window=getattr(config, "sliding_window", None),
        hidden_act=getattr(config, "hidden_act", "gelu_pytorch_tanh"),
        tie_word_embeddings=bool(getattr(config, "tie_word_embeddings", True)),
    )
    kwargs.update(overrides)
    return dense.build_arch(config, **kwargs)


def convert_hf_state_dict(state_dict: Dict[str, Any], config: InferenceConfig) -> Dict[str, Any]:
    arch = build_arch(config)

    def src(name):
        return dense.state_tensor(state_dict, name)

    def ff(get, has, cast, pre):
        mlp = {"up_proj": {"w": cast(get(pre + "mlp.c_fc.weight").t())},
               "down_proj": {"w": cast(get(pre + "mlp.c_proj.weight").t())}}
        if arch.mlp_bias:
            mlp["up_proj"]["b"] = cast(get(pre + "mlp.c_fc.bias"))
            mlp["down_proj"]["b"] = cast(get(pre + "mlp.c_proj.bias"))
        return "mlp", mlp

    params = dense.convert_hf_state_dict(state_dict, config, arch, ff_converter=ff)
    L = arch.num_layers
    return dense.attach_norm_biases(
        params, [src(f"layers.{i}.input_layernorm.bias") for i in range(L)],
        [src(f"layers.{i}.post_attention_layernorm.bias") for i in range(L)],
        src("norm.bias"), to_torch_dtype(arch.dtype))


def random_params(config: InferenceConfig, seed: int = 0, device=None) -> Dict[str, Any]:
    """Random weights (dense.random_params) with the biased norms."""
    arch = build_arch(config)
    return dense.random_params(arch, seed=seed, device=device,
                               shapes=dense.param_shapes(arch, norm_bias=True))
