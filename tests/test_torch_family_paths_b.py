"""LoRA serving and quantized KV stores on the family switches, part 2 (part
1, ``test_torch_family_paths.py``, holds the helpers): the MoE families
(LoRA on the attention projections only: an MoE layer has no dense MLP),
LongRoPE and xIELU, each held to the JAX package; the window-sized ring
under a one-byte store with per-tensor scales, past the window, against the
JAX ring app; and the refusals kept, each raised by both packages."""

import numpy as np
import pytest
import torch

from nxdi_tpu.config import TpuConfig
from nxdi_tpu.generation.hf_adapter import HuggingFaceGenerationAdapter as JaxAdapter
from nxdi_tpu_torch.config import TorchConfig
from nxdi_tpu_torch.generation.hf_adapter import HuggingFaceGenerationAdapter

from test_torch_families import jax_family_app, port_family_app
from test_torch_family_paths import KV_STORES, OTHERS, check_case, tiny
from test_torch_slice import fresh_jax_compiles


@pytest.fixture(autouse=True, scope="module")
def _fresh_jax_compiles():
    with fresh_jax_compiles():
        yield


@pytest.mark.parametrize("case", sorted(OTHERS))
def test_lora_and_quantized_kv_match_jax(case):
    tapp = check_case(case)
    if tapp.models["token_generation_model"].arch.moe is not None:
        assert "mlp" not in tapp.params["layers"] or not any(
            "lora_A" in d for d in tapp.params["layers"]["mlp"].values()
            if isinstance(d, dict))


def test_ring_under_a_one_byte_store_matches_jax():
    """Gemma-3's interleaved ring (``k_win`` / ``v_win`` beside the global
    stack) on an e4m3 store (``direct_cast``: the JAX package wires no
    scales into the ring), 3x past the window of 8: greedy tokens equal the
    JAX ring app's, every store one byte. Per-tensor scales on the ring
    raise at load in both packages, in the same words."""
    model_type, cfg, sd = tiny("gemma3_text")
    kw = dict(window_sized_kv=True, sliding_window=8, kv_cache_quant=True)
    japp = jax_family_app(model_type, cfg, sd, **kw)
    tapp = port_family_app(model_type, cfg, sd=sd, **kw)
    prompt = np.array([[5, 9, 3, 17, 2, 8, 11, 42, 7, 13]], dtype=np.int64)
    want = JaxAdapter(japp).generate(prompt, max_new_tokens=14)
    got = HuggingFaceGenerationAdapter(tapp).generate(prompt, max_new_tokens=14)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert {tapp.kv_cache[k].dtype for k in ("k", "v", "k_win", "v_win")} == {
        torch.float8_e4m3fn}
    scaled = dict(window_sized_kv=True, sliding_window=8, kv_quant_config=dict(KV_STORES[0]))
    for build in (jax_family_app, port_family_app):
        with pytest.raises(NotImplementedError, match="not wired into the window ring"):
            build(model_type, cfg, sd=sd, **scaled)


PER_KEY = dict(dtype="float8_e4m3", scale_mode="per_key", k_scales=[0.5, 0.5],
               v_scales=[0.5, 0.5])


@pytest.mark.parametrize("kw,match", [
    (dict(fused_qkv=True, lora_config=dict(max_loras=1, max_lora_rank=4)),
     "fused_qkv does not compose with LoRA"),
    (dict(is_block_kv_layout=True, pa_block_size=8, pa_num_blocks=16, kv_quant_config=PER_KEY),
     "composes with the contiguous KV layout only"),
    (dict(window_sized_kv=True, sliding_window=8, kv_quant_config=PER_KEY),
     "composes with the contiguous KV layout only"),
])
def test_refusals_kept_match_jax(kw, match):
    """What the JAX package still refuses on these paths, the port refuses
    with its words: LoRA under ``fused_qkv``, per-key / per-channel KV
    scales on a paged or ring layout."""
    with pytest.raises(ValueError, match=match):
        TpuConfig(**kw)
    with pytest.raises(ValueError, match=match):
        TorchConfig(**kw)


def test_dynamic_rope_warns_and_matches_jax():
    """The ``dynamic`` rope type (ROADMAP Queue 1 item 4) as the JAX package
    takes it: the default frequencies, with the same warning that positions
    past the original context rotate wrongly."""
    from nxdi_tpu.ops import rope as jrope
    from nxdi_tpu_torch.ops import rope as trope

    scaling = {"rope_type": "dynamic", "factor": 2.0, "original_max_position_embeddings": 64}
    with pytest.warns(UserWarning, match="treated as default frequencies") as got:
        port = trope.inv_freq_from_hf_config(64, 10000.0, scaling, 256)
    with pytest.warns(UserWarning) as want:
        ref = jrope.inv_freq_from_hf_config(64, 10000.0, scaling, 256)
    assert str(got[0].message) == str(want[0].message)
    np.testing.assert_array_equal(port, ref)
    np.testing.assert_array_equal(port, trope.default_inv_freq(64, 10000.0))
    legacy = {"type": "dynamic", "factor": 4.0}  # the older key
    with pytest.warns(UserWarning, match="dynamic"):
        np.testing.assert_array_equal(trope.inv_freq_from_hf_config(32, 500000.0, legacy),
                                      jrope.inv_freq_from_hf_config(32, 500000.0, legacy))
