"""LFM2 in the port (``nxdi_tpu_torch/models/lfm2/``) and the seq-id routing
of raw state stacks (``models/state_routing.py``), held against the JAX
package and HF ``Lfm2ForCausalLM`` on the CPU at the JAX package's test
config (hidden 64, four layers: conv, attention, conv, attention; a conv
kernel of 3), float32: prefill logits within 1e-5 of the JAX app's, 16
greedy tokens equal to the JAX app's and HF's, under static ``generate()``
and under continuous batching on shuffled cache lines; the converter leaf
for leaf; the cache's shapes; the refusals of both packages.

HF's default init (std 0.02) makes a tiny model repeat one token, so the
checkpoint is redrawn at std 0.2 (norms 1 + N(0, 0.1)): the tokens vary."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nxdi_tpu.config import OnDeviceSamplingConfig as JaxODSC
from nxdi_tpu.config import TpuConfig
from nxdi_tpu.generation.hf_adapter import HuggingFaceGenerationAdapter as JaxAdapter
from nxdi_tpu.models import state_routing as jsr
from nxdi_tpu.models.lfm2 import modeling_lfm2 as jlf
from nxdi_tpu.utils.accuracy import hf_greedy_generate as hf_greedy
from nxdi_tpu_torch.config import OnDeviceSamplingConfig, TorchConfig
from nxdi_tpu_torch.generation.hf_adapter import HuggingFaceGenerationAdapter
from nxdi_tpu_torch.models import state_routing as tsr
from nxdi_tpu_torch.models.convert import from_jax_params
from nxdi_tpu_torch.models.lfm2 import modeling_lfm2 as tlf

from test_torch_mimo_v2 import (CB, LOGIT_TOL, NEW, P0, P1, PROMPT, assert_logits_close,
                                interleaved, logged)
from test_torch_slice import fresh_jax_compiles

HF_CFG = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=4, num_attention_heads=4,
              num_key_value_heads=2, vocab_size=256, max_position_embeddings=256, norm_eps=1e-5,
              rope_theta=10000.0, conv_L_cache=3, conv_bias=False, block_multiple_of=32,
              layer_types=["conv", "full_attention", "conv", "full_attention"],
              tie_word_embeddings=True)


@pytest.fixture(autouse=True, scope="module")
def _fresh_jax_compiles():
    with fresh_jax_compiles():
        yield


@pytest.fixture(scope="module")
def hf():
    """(HF model, its config dict, its state dict as numpy)."""
    from transformers import Lfm2Config, Lfm2ForCausalLM

    torch.manual_seed(0)
    cfg = Lfm2Config(**HF_CFG)
    model = Lfm2ForCausalLM(cfg).eval()
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for name, p in model.named_parameters():
            noise = torch.randn(p.shape, generator=gen)
            p.copy_(1.0 + 0.1 * noise if name.endswith("norm.weight") else 0.2 * noise)
    return model, cfg.to_dict(), {k: v.detach().numpy() for k, v in model.state_dict().items()}


def _tc(**kw):
    d = dict(tp_degree=1, seq_len=64, max_context_length=32, batch_size=2, dtype="float32",
             skip_warmup=True, output_logits=True)
    d.update(kw)
    return d


def jax_app(hf, **kw):
    _, cfg, sd = hf

    class App(jlf.Lfm2ForCausalLM):
        def get_state_dict(self):
            return sd

    app = App("<memory>", jlf.Lfm2InferenceConfig(
        TpuConfig(on_device_sampling_config=JaxODSC(), **_tc(**kw)), load_config=lambda: cfg),
        model_family=jlf)
    app.load()
    return app


def port_app(hf, **kw):
    _, cfg, sd = hf
    app = tlf.Lfm2ForCausalLM("<memory>", tlf.Lfm2InferenceConfig(
        TorchConfig(on_device_sampling_config=OnDeviceSamplingConfig(), **_tc(**kw)),
        load_config=lambda: cfg), device="cpu")
    app.get_state_dict = lambda: {k: torch.from_numpy(v) for k, v in sd.items()}
    app.load()
    return app


def _logits(app):
    B, S = PROMPT.shape
    out = app.forward(PROMPT.astype(np.int32), np.tile(np.arange(S, dtype=np.int32), (B, 1)),
                      last_token_index=np.full((B,), S - 1, np.int32))
    lg = out["logits"]
    return lg.numpy() if isinstance(lg, torch.Tensor) else np.asarray(jax.device_get(lg))


@pytest.fixture(scope="module")
def jax_static(hf):
    return jax_app(hf)


def test_lfm2_matches_jax_and_hf(hf, jax_static):
    """Every dispatch's logits within 1e-5 of the JAX app's; 16 greedy tokens
    equal to the JAX app's and HF's, two rows at once; the conv tail carried
    across the prefill into the decode."""
    tapp = port_app(hf)
    np.testing.assert_allclose(_logits(tapp), _logits(jax_static), atol=LOGIT_TOL, rtol=0)
    want, jlogs = logged(jax_static, lambda: JaxAdapter(jax_static).generate(
        PROMPT, max_new_tokens=NEW))
    got, logs = logged(tapp, lambda: HuggingFaceGenerationAdapter(tapp).generate(
        PROMPT, max_new_tokens=NEW))
    assert_logits_close(logs, jlogs)
    np.testing.assert_array_equal(got, want)
    expected = hf_greedy(hf[0], PROMPT, NEW)
    np.testing.assert_array_equal(got, expected)
    assert len(set(got[0, PROMPT.shape[1]:].tolist())) > 3  # the tokens vary
    kc = tapp.kv_cache
    assert set(kc) == {"k", "v", "conv"}
    assert tuple(kc["k"].shape) == (2, 2, 2, 64, 16) and tuple(kc["conv"].shape) == (2, 2, 64, 3)


def test_lfm2_converter_matches_jax(hf, jax_static):
    """The port's converter gives the JAX app's params leaf for leaf."""
    _, cfg, sd = hf
    got = tlf.convert_hf_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                                    tlf.Lfm2InferenceConfig(TorchConfig(**_tc()),
                                                            load_config=lambda: cfg))
    want = from_jax_params(jax.device_get(jax_static.params))
    assert got.keys() == want.keys() and len(got["layers"]) == 4
    for g, w in zip([got["embed_tokens"], got["norm"]] + got["layers"],
                    [want["embed_tokens"], want["norm"]] + want["layers"]):
        pairs = g.items() if isinstance(g, dict) else [("", g)]
        if isinstance(g, dict):
            assert g.keys() == w.keys()
        for k, v in pairs:
            ref = w[k] if isinstance(w, dict) else w
            assert v.dtype == ref.dtype, k
            np.testing.assert_array_equal(v.numpy(), ref.numpy(), err_msg=k)
    assert tuple(tlf.param_shapes(tlf.Lfm2InferenceConfig(
        TorchConfig(**_tc()), load_config=lambda: cfg))["layers"][0]["w1"]) == (64, 96)


def test_lfm2_continuous_batching_shuffled(hf):
    """Interleaved prefills into shuffled cache lines, conv tails and
    attention stacks routed by seq_ids: every dispatch's logits within 1e-5
    of the JAX app's run, both streams (16 tokens and more) equal to its and
    to HF's greedy tokens of each prompt alone."""
    *want, jlogs = interleaved(jax_app(hf, **CB))
    *got, logs = interleaved(port_app(hf, **CB))
    assert_logits_close(logs, jlogs)
    assert got == want
    for prompt, toks in zip((P0, P1), got):
        assert len(toks) >= NEW
        exp = hf_greedy(hf[0], np.array([prompt]), len(toks))[0, len(prompt):]
        np.testing.assert_array_equal(toks, exp)


REFUSALS = {
    "async_mode": dict(async_mode=True),
    "is_block_kv_layout": dict(is_block_kv_layout=True, pa_num_blocks=16, pa_block_size=16),
    "speculation": dict(speculation_length=2),
    "quantized": dict(quantized=True),
}


@pytest.mark.parametrize("case", sorted(REFUSALS) + ["window_sized_kv", "device_loop"])
def test_lfm2_refusals(hf, case):
    """Each refusal of the JAX app raises in the port too, naming the mode;
    the port also refuses what the JAX app would ignore or run with its
    one-step forward."""
    _, cfg, _ = hf
    if case in REFUSALS:
        kw, err = REFUSALS[case], ValueError
        with pytest.raises(ValueError, match=f"lfm2 does not support: {case}"):
            jlf.Lfm2ForCausalLM("<m>", jlf.Lfm2InferenceConfig(
                TpuConfig(**_tc(**kw)), load_config=lambda: cfg), model_family=jlf)
    else:
        kw, err = ({"window_sized_kv": True, "sliding_window": 8} if case == "window_sized_kv"
                   else {"device_loop": True}), NotImplementedError
    with pytest.raises(err, match=f"lfm2 does not support:? {case}"):
        tlf.Lfm2ForCausalLM("<m>", tlf.Lfm2InferenceConfig(
            TorchConfig(on_device_sampling_config=OnDeviceSamplingConfig(), **_tc(**kw)),
            load_config=lambda: cfg), device="cpu")


@pytest.mark.parametrize("routed", [False, True])
def test_state_routing_matches_jax(routed):
    """``take_rows`` / ``put_rows`` against the JAX functions on random stacks:
    a shuffled order, an id past the lines (clipped on the read, dropped on
    the write), and no ids (the whole layer)."""
    rng = np.random.default_rng(3)
    stack = rng.standard_normal((3, 4, 5, 2)).astype(np.float32)
    rows = rng.standard_normal((4 if not routed else 3, 5, 2)).astype(np.float32)
    sids = np.array([2, 0, 7], np.int32) if routed else None
    jt = np.asarray(jsr.take_rows(jnp.asarray(stack[1]), None if sids is None else jnp.asarray(
        sids)))
    tt = tsr.take_rows(torch.from_numpy(stack[1]), None if sids is None else torch.from_numpy(
        sids))
    np.testing.assert_array_equal(tt.numpy(), jt)
    jp = np.asarray(jsr.put_rows(jnp.asarray(stack), 1, jnp.asarray(rows),
                                 None if sids is None else jnp.asarray(sids)))
    tstack = torch.from_numpy(stack.copy())
    out = tsr.put_rows(tstack, 1, torch.from_numpy(rows),
                       None if sids is None else torch.from_numpy(sids))
    assert out is tstack
    np.testing.assert_array_equal(tstack.numpy(), jp)
    if routed:
        np.testing.assert_array_equal(tt[2].numpy(), stack[1, 3])  # id 7 read line 3
        np.testing.assert_array_equal(tstack[1, 3].numpy(), stack[1, 3])  # and wrote nothing
        np.testing.assert_array_equal(tstack[1, 2].numpy(), rows[0])
