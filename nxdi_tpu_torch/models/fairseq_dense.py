"""The shared decoder of the fairseq-descended families (counterpart of
``nxdi_tpu/models/fairseq_dense.py``; OPT, BioGPT, XGLM): biased pre-norm
LayerNorms (``self_attn_layer_norm`` / ``final_layer_norm``), a non-gated
``fc1`` / ``fc2`` MLP, q / k / v / out projections with biases, absolute
positions from a learned or sinusoidal table (``learned_pos_embeds``, no
rope) whose fairseq offset of 2 is cut off at conversion, so the forward
looks rows up at plain ``position_ids``, an optional sqrt(H) embedding scale
and a final LayerNorm. :func:`check_positions` refuses a ``seq_len`` past
the table, for every learned-position family (GPT-2 and BigCode too)."""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from nxdi_tpu_torch.config import InferenceConfig, to_torch_dtype
from nxdi_tpu_torch.models import dense
from nxdi_tpu_torch.models.base import DecoderArch
from nxdi_tpu_torch.ops.rope import default_inv_freq


def build_arch(config: InferenceConfig, **overrides) -> DecoderArch:
    kwargs = dict(
        layernorm=True,
        learned_pos_embeds=True,
        no_rope=True,
        gated_mlp=False,
        attention_bias=True,
        attention_o_bias=True,
        mlp_bias=True,
    )
    kwargs.update(overrides)
    return dense.build_arch(config, **kwargs)


def build_inv_freq(config: InferenceConfig) -> np.ndarray:
    # unread (no_rope); the forward's signature takes a table
    return default_inv_freq(dense.head_dim_of(config), 10000.0)


def check_positions(config: InferenceConfig, rows: int) -> None:
    """Refuse a ``seq_len`` past the learned position table's ``rows``
    (GPT-2: its ``n_positions``): a real position there has no row."""
    seq_len = config.tpu_config.seq_len
    if seq_len > rows:
        raise ValueError(f"seq_len {seq_len} exceeds the checkpoint's learned position table "
                         f"({rows} positions)")


def sinusoid_table(num_positions: int, dim: int, padding_idx: Optional[int]) -> np.ndarray:
    """The fairseq / tensor2tensor sinusoid (HF
    XGLMSinusoidalPositionalEmbedding.get_embedding): [sin | cos] halves,
    zero-padded to an odd dim, the padding row zeroed."""
    half = dim // 2
    freq = np.exp(np.arange(half, dtype=np.float64) * -(np.log(10000.0) / (half - 1)))
    ang = np.arange(num_positions, dtype=np.float64)[:, None] * freq[None, :]
    emb = np.concatenate([np.sin(ang), np.cos(ang)], axis=1).astype(np.float32)
    if dim % 2 == 1:
        emb = np.concatenate([emb, np.zeros((num_positions, 1), np.float32)], axis=1)
    if padding_idx is not None:
        emb[padding_idx] = 0.0
    return emb


class FairseqInferenceConfig(dense.DenseInferenceConfig):
    """The learned-position families' configs: a ``seq_len`` past the
    position table raises (:func:`check_positions`)."""

    def add_derived_config(self):
        super().add_derived_config()
        check_positions(self, self.max_position_embeddings)


def convert_hf_state_dict(
    state_dict: Dict[str, Any],
    config: InferenceConfig,
    arch: DecoderArch,
    *,
    prefix: str,
    pos_table: Optional[Callable[[], np.ndarray]] = None,
    pos_key: str = "embed_positions.weight",
    pos_offset: int = 2,
    final_norm_key: str = "final_layer_norm",
) -> Dict[str, Any]:
    """The fairseq layout into the dense one. ``prefix``: the HF submodule
    path (``model.decoder.`` for OPT, ``biogpt.`` for BioGPT, ``model.`` for
    XGLM); ``pos_table`` makes the position table where the checkpoint has
    none (XGLM's sinusoid buffer)."""
    L = arch.num_layers
    dt = to_torch_dtype(arch.dtype)

    def src(name):
        return dense.state_tensor(state_dict, name, (prefix, ""))

    sd = {"embed_tokens.weight": src("embed_tokens.weight"),
          "norm.weight": src(final_norm_key + ".weight")}
    for head_key in ("lm_head.weight", "output_projection.weight"):
        if head_key in state_dict:
            sd["lm_head.weight"] = state_dict[head_key]
            break
    for i in range(L):
        pre = f"layers.{i}."
        for name, hf in (("q_proj", "q_proj"), ("k_proj", "k_proj"), ("v_proj", "v_proj"),
                         ("o_proj", "out_proj")):
            for kind in ("weight", "bias"):
                sd[f"{pre}self_attn.{name}.{kind}"] = src(f"{pre}self_attn.{hf}.{kind}")
        sd[pre + "input_layernorm.weight"] = src(pre + "self_attn_layer_norm.weight")
        sd[pre + "post_attention_layernorm.weight"] = src(pre + "final_layer_norm.weight")

    def ff(get, has, cast, pre):
        return "mlp", {"up_proj": {"w": cast(src(pre + "fc1.weight").t()),
                                   "b": cast(src(pre + "fc1.bias"))},
                       "down_proj": {"w": cast(src(pre + "fc2.weight").t()),
                                     "b": cast(src(pre + "fc2.bias"))}}

    params = dense.convert_hf_state_dict(sd, config, arch, ff_converter=ff)
    dense.attach_norm_biases(
        params, [src(f"layers.{i}.self_attn_layer_norm.bias") for i in range(L)],
        [src(f"layers.{i}.final_layer_norm.bias") for i in range(L)],
        src(final_norm_key + ".bias"), dt)
    table = torch.as_tensor(pos_table() if pos_table is not None else src(pos_key))
    # the fairseq offset: rows are looked up at position_ids + 2, so the first
    # two rows go and the forward reads plain position_ids
    params["position_embeddings"] = table[pos_offset:].to(dt).contiguous()
    return params


def random_params(config: InferenceConfig, arch: DecoderArch, rows: int, seed: int = 0,
                  device=None) -> Dict[str, Any]:
    """Random weights (dense.random_params) with the biased norms and a
    ``rows``-row position table."""
    return dense.random_params(arch, seed=seed, device=device,
                               shapes=dense.param_shapes(arch, norm_bias=True, positions=rows))
