"""The port's Llama slice (greedy generate on the CPU, kernels' plain
versions) held against the JAX package with its attention kernels on
(Pallas in interpret mode) and against HF, on the tiny random llama."""

import contextlib
import json
import os

import numpy as np
import pytest
import torch

import jax
from jax.experimental.compilation_cache import compilation_cache as jax_cc

from nxdi_tpu.config import OnDeviceSamplingConfig as JaxODSC
from nxdi_tpu.config import TpuConfig
from nxdi_tpu.generation.hf_adapter import HuggingFaceGenerationAdapter as JaxAdapter
from nxdi_tpu.models.llama import modeling_llama as jml
from nxdi_tpu.runtime.application import TpuModelForCausalLM
from nxdi_tpu.utils.accuracy import hf_greedy_generate
from nxdi_tpu_torch.config import OnDeviceSamplingConfig, TorchConfig
from nxdi_tpu_torch.generation.hf_adapter import HuggingFaceGenerationAdapter, load_pretrained_config
from nxdi_tpu_torch.models.convert import from_jax_params
from nxdi_tpu_torch.models.llama import modeling_llama as tml
from nxdi_tpu_torch.runtime.application import TorchModelForCausalLM

LOGIT_TOL = 1e-4
PROMPT = np.array([[5, 9, 3, 17, 2, 8, 11, 42]], dtype=np.int64)
BUCKETS = dict(enable_bucketing=True, context_encoding_buckets=[8, 16, 32],
               token_generation_buckets=[16, 32, 64])


@contextlib.contextmanager
def one_torch_thread():
    """Run torch's CPU work on one intra-op thread, the caller's count given
    back on exit. The port's tests run tiny shapes, which gain nothing from
    more threads; under pytest-xdist every worker's default of one OpenMP
    thread a core oversubscribes the cores, and the spinning threads made
    the port's files 3-4 times slower than alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@contextlib.contextmanager
def fresh_jax_compiles():
    """A port test module's environment: the JAX reference compiled without
    the persistent compilation cache, which is given back on exit, and
    torch on one thread (:func:`one_torch_thread`). ``enable_persistent_cache``
    of the JAX package turns the cache on for the whole process, and
    XLA:CPU results loaded from it give some greedy runs wrong tokens
    (ROADMAP Queue 3): a port test that follows such a test on one worker
    would compare against them."""
    saved = jax.config.jax_compilation_cache_dir
    jax.config.update("jax_compilation_cache_dir", None)
    jax_cc.reset_cache()
    jax.clear_caches()
    try:
        with one_torch_thread():
            yield
    finally:
        jax.config.update("jax_compilation_cache_dir", saved)
        jax_cc.reset_cache()


@pytest.fixture(autouse=True, scope="module")
def _fresh_jax_compiles():
    with fresh_jax_compiles():
        yield


def _common(**kw):
    d = dict(tp_degree=1, seq_len=64, max_context_length=32, batch_size=1, dtype="float32",
             attn_kernel_enabled=True, attn_tkg_kernel_enabled=True, skip_warmup=True)
    d.update(kw)
    return d


def jax_app(hf_model, hf_cfg, **kw):
    sd = {k: v.detach().numpy() for k, v in hf_model.state_dict().items()}
    cfg = jml.LlamaInferenceConfig(
        TpuConfig(on_device_sampling_config=JaxODSC(), **_common(**kw)),
        load_config=lambda: hf_cfg.to_dict(),
    )

    class App(TpuModelForCausalLM):
        def get_state_dict(self):
            return sd

    app = App("<memory>", cfg, model_family=jml)
    app.load()
    return app


def port_app(hf_model, hf_cfg, params=None, model_path="<memory>", **kw):
    sd = {k: v.detach() for k, v in hf_model.state_dict().items()}
    cfg = tml.LlamaInferenceConfig(
        TorchConfig(on_device_sampling_config=OnDeviceSamplingConfig(), **_common(**kw)),
        load_config=(lambda: hf_cfg.to_dict()) if model_path == "<memory>"
        else load_pretrained_config(model_path),
    )

    class App(TorchModelForCausalLM):
        def get_state_dict(self):
            return sd if model_path == "<memory>" else super().get_state_dict()

        def build_params(self):
            return params if params is not None else super().build_params()

    app = App(model_path, cfg, model_family=tml, device="cpu")
    app.load()
    return app


def _prefill_logits(app, prompt):
    out = app.forward(prompt.astype(np.int32),
                      np.tile(np.arange(prompt.shape[1], dtype=np.int32), (prompt.shape[0], 1)),
                      last_token_index=np.full((prompt.shape[0],), prompt.shape[1] - 1, np.int32))
    logits = out["logits"]
    return logits.numpy() if isinstance(logits, torch.Tensor) else np.asarray(jax.device_get(logits))


def _strategies(app):
    """Attention strategies each package's programs ran, by submodel."""
    out = {}
    for tag, w in app.models.items():
        if hasattr(w, "_programs"):  # JAX: one traced program per bucket
            seen = [s for p in w._programs.values() for s in p.attention_strategies]
        else:
            seen = [s for ss in w.attention_strategies.values() for s in ss]
        out[tag] = set(seen)
    return out


def test_prefill_logits_strategies_and_carried_weights(tiny_hf_llama):
    hf_model, hf_cfg = tiny_hf_llama
    japp = jax_app(hf_model, hf_cfg, output_logits=True)
    tapp = port_app(hf_model, hf_cfg, output_logits=True)
    ref = _prefill_logits(japp, PROMPT)
    np.testing.assert_allclose(_prefill_logits(tapp, PROMPT), ref, atol=LOGIT_TOL, rtol=LOGIT_TOL)

    expected = hf_greedy_generate(hf_model, PROMPT, max_new_tokens=20)
    np.testing.assert_array_equal(JaxAdapter(japp).generate(PROMPT, max_new_tokens=20), expected)
    np.testing.assert_array_equal(HuggingFaceGenerationAdapter(tapp).generate(PROMPT, max_new_tokens=20),
                                  expected)
    want = {"context_encoding_model": {"cte_flash_kernel"},
            "token_generation_model": {"tkg_fused_kernel_stacked"}}
    assert _strategies(tapp) == want
    assert {k: v for k, v in _strategies(japp).items() if k in want} == want

    carried = port_app(hf_model, hf_cfg, params=from_jax_params(jax.device_get(japp.params)),
                       output_logits=True)
    np.testing.assert_allclose(_prefill_logits(carried, PROMPT), ref, atol=LOGIT_TOL, rtol=LOGIT_TOL)


def test_greedy_batched_right_padded(tiny_hf_llama):
    hf_model, hf_cfg = tiny_hf_llama
    p0, p1 = [5, 9, 3, 17, 2, 8], [7, 13, 21]
    prompt = np.zeros((2, 6), dtype=np.int64)
    prompt[0], prompt[1, :3] = p0, p1
    mask = (prompt != 0).astype(np.int32)
    japp = jax_app(hf_model, hf_cfg, batch_size=2)
    tapp = port_app(hf_model, hf_cfg, batch_size=2)
    got = HuggingFaceGenerationAdapter(tapp).generate(prompt, attention_mask=mask, max_new_tokens=10)
    np.testing.assert_array_equal(got, JaxAdapter(japp).generate(prompt, attention_mask=mask,
                                                                 max_new_tokens=10))
    e0 = hf_greedy_generate(hf_model, np.array([p0]), 10)
    e1 = hf_greedy_generate(hf_model, np.array([p1]), 10)
    np.testing.assert_array_equal(got[0, : e0.shape[1]], e0[0])
    np.testing.assert_array_equal(got[1, 3:13], e1[0, 3:])


def test_buckets_match_and_generate_through_them(tiny_hf_llama):
    hf_model, hf_cfg = tiny_hf_llama
    japp = jax_app(hf_model, hf_cfg, **BUCKETS)
    tapp = port_app(hf_model, hf_cfg, **BUCKETS)
    for tag in ("context_encoding_model", "token_generation_model"):
        jw, tw = japp.models[tag], tapp.models[tag]
        assert jw.buckets == tw.buckets
        top = tw.buckets[-1]
        assert [jw.select_bucket(n) for n in range(1, top + 1)] == [
            tw.select_bucket(n) for n in range(1, top + 1)]
    prompt = np.array([[5, 9, 3, 17, 2, 8, 11, 42, 7, 1]], dtype=np.int64)  # CTE bucket 16
    got = HuggingFaceGenerationAdapter(tapp).generate(prompt, max_new_tokens=24)
    np.testing.assert_array_equal(got, hf_greedy_generate(hf_model, prompt, max_new_tokens=24))
    assert set(tapp.models["token_generation_model"].attention_strategies) == {16, 32, 64}
    assert set(tapp.models["context_encoding_model"].attention_strategies) == {16}


def test_checkpoint_directory_and_config_round_trip(tiny_hf_llama, tmp_path):
    """load() from a saved HF directory (safetensors), and a port config
    that the JAX package reads back with the same meaning."""
    hf_model, hf_cfg = tiny_hf_llama
    hf_model.save_pretrained(tmp_path)
    tapp = port_app(hf_model, hf_cfg, model_path=str(tmp_path))
    np.testing.assert_array_equal(HuggingFaceGenerationAdapter(tapp).generate(PROMPT, max_new_tokens=8),
                                  hf_greedy_generate(hf_model, PROMPT, max_new_tokens=8))
    path = tapp.config.save(str(tmp_path / "cfg"))
    with open(path) as f:
        d = json.load(f)["tpu_config"]
    jtc = TpuConfig.from_dict(d)
    for key, value in d.items():
        got = jtc.to_dict()[key]
        assert got == value, (key, got, value)
    from nxdi_tpu_torch.config import InferenceConfig

    assert InferenceConfig.load(str(tmp_path / "cfg")).tpu_config.to_dict() == d


def test_plain_strategies_with_kernels_off(tiny_hf_llama):
    """Kernel flags off: the plain paths (cte_xla, tkg_two_part_xla) run and
    still match the JAX package and HF."""
    hf_model, hf_cfg = tiny_hf_llama
    off = dict(attn_kernel_enabled=False, attn_tkg_kernel_enabled=False)
    japp = jax_app(hf_model, hf_cfg, **off)
    tapp = port_app(hf_model, hf_cfg, **off)
    got = HuggingFaceGenerationAdapter(tapp).generate(PROMPT, max_new_tokens=12)
    np.testing.assert_array_equal(got, JaxAdapter(japp).generate(PROMPT, max_new_tokens=12))
    np.testing.assert_array_equal(got, hf_greedy_generate(hf_model, PROMPT, max_new_tokens=12))
    assert _strategies(tapp) == {"context_encoding_model": {"cte_xla"},
                                 "token_generation_model": {"tkg_two_part_xla"}}


def test_ineligible_kernel_raises_on_the_card_only():
    """The kernel gate: on the CPU the JAX eligibility decides; on a CUDA
    tensor a failed condition under an enabled flag raises, naming it."""
    from nxdi_tpu_torch.models.base import _card_limits, _kernel_gate

    card = _card_limits(12, torch.bfloat16)
    assert _kernel_gate("attn_kernel_enabled", True, False, [], card) is True
    assert _kernel_gate("attn_kernel_enabled", True, False, ["5 heads not divisible"], []) is False
    assert _kernel_gate("attn_kernel_enabled", False, True, [], card) is False
    with pytest.raises(NotImplementedError, match="head_dim 12"):
        _kernel_gate("attn_kernel_enabled", True, True, [], card)
    with pytest.raises(NotImplementedError, match="dtype torch.float16 is not float32"):
        _kernel_gate("attn_tkg_kernel_enabled", True, True, [],
                     _card_limits(64, torch.float16))


def test_fresh_jax_compiles_bypasses_the_persistent_cache(tmp_path):
    """With a persistent cache on (as ``enable_persistent_cache`` leaves it),
    a compile lands in it; under fresh_jax_compiles none does, and the
    setting comes back on exit."""
    keys = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs",
            "jax_persistent_cache_min_entry_size_bytes")
    outer = {k: getattr(jax.config, k) for k in keys}
    on, off = str(tmp_path / "on"), str(tmp_path / "off")
    try:
        for k, v in zip(keys, (on, 0.0, 0)):
            jax.config.update(k, v)
        jax_cc.reset_cache()
        jax.jit(lambda x: x * 3.0)(np.float32(1.0)).block_until_ready()
        assert os.listdir(on)
        jax.config.update(keys[0], off)
        with fresh_jax_compiles():
            assert jax.config.jax_compilation_cache_dir is None
            assert float(jax.jit(lambda x: x * 5.0)(np.float32(1.0))) == 5.0
        assert jax.config.jax_compilation_cache_dir == off
        assert not os.path.exists(off)
    finally:
        for k, v in outer.items():
            jax.config.update(k, v)
        jax_cc.reset_cache()
