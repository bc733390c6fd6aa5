"""The port's multi-adapter LoRA serving (``nxdi_tpu_torch/lora/serving.py``)
held against HF models with the adapter merged into their weights
(W' = W + (alpha / r) * B @ A), against the JAX package's LoRA app (the
cases of ``tests/integration/test_lora_serving.py``), and against the JAX
config's refusals, on the CPU in float32. Greedy tokens must be equal; the
adapter buffers must keep their addresses across adapter swaps."""

import json
import os
import re

import numpy as np
import pytest
import torch

from nxdi_tpu.config import LoraServingConfig as JaxLoraConfig
from nxdi_tpu.config import OnDeviceSamplingConfig as JaxODSC
from nxdi_tpu.config import TpuConfig
from nxdi_tpu.generation.hf_adapter import HuggingFaceGenerationAdapter as JaxAdapter
from nxdi_tpu.models.llama import modeling_llama as jml
from nxdi_tpu.runtime.application import TpuModelForCausalLM
from nxdi_tpu.utils.accuracy import hf_greedy_generate as hf_greedy
from nxdi_tpu_torch.config import LoraServingConfig, OnDeviceSamplingConfig, TorchConfig
from nxdi_tpu_torch.generation.hf_adapter import HuggingFaceGenerationAdapter
from nxdi_tpu_torch.lora import lora_pointers
from nxdi_tpu_torch.models import base as tbase
from nxdi_tpu_torch.models.llama import modeling_llama as tml
from nxdi_tpu_torch.models.mixtral import modeling_mixtral as tmx
from nxdi_tpu_torch.runtime.application import TorchModelForCausalLM
from nxdi_tpu_torch.runtime.model_wrapper import replay_state
from test_torch_moe import make_tiny_hf_mixtral
from test_torch_slice import fresh_jax_compiles

H = 64
LAYERS = 2
RANK = 4
ALPHA = 8.0
TARGETS = ["q_proj", "v_proj", "gate_proj", "down_proj"]
DIMS = {"q_proj": (H, 64), "v_proj": (H, 32), "gate_proj": (H, 128), "down_proj": (128, H)}
SCOPE = {"q_proj": "self_attn", "v_proj": "self_attn", "gate_proj": "mlp", "down_proj": "mlp"}
ADAPTER_CFG = {"r": RANK, "lora_alpha": ALPHA}
PROMPT = np.array([[5, 9, 3, 17, 2, 8, 11, 42]], dtype=np.int64)


@pytest.fixture(autouse=True, scope="module")
def _fresh_jax_compiles():
    with fresh_jax_compiles():
        yield


def _key(i, m, ab):
    return f"base_model.model.model.layers.{i}.{SCOPE[m]}.{m}.lora_{ab}.weight"


def make_adapter_sd(seed, dims=DIMS, scale=0.02):
    """A PEFT-format adapter state dict over ``dims``' modules, every layer."""
    rng = np.random.default_rng(seed)
    sd = {}
    for i in range(LAYERS):
        for m, (fin, fout) in dims.items():
            sd[_key(i, m, "A")] = (rng.standard_normal((RANK, fin)) * scale).astype(np.float32)
            sd[_key(i, m, "B")] = (rng.standard_normal((fout, RANK)) * scale).astype(np.float32)
    return sd


def merged(model, adapter_sd, modules=TARGETS):
    """A copy of HF ``model`` with W' = W + (alpha / r) * B @ A baked in."""
    import copy

    model = copy.deepcopy(model)
    sd = model.state_dict()
    for i in range(LAYERS):
        for m in modules:
            key = f"model.layers.{i}.{SCOPE[m]}.{m}.weight"
            sd[key] = sd[key] + torch.from_numpy(
                ALPHA / RANK * (adapter_sd[_key(i, m, "B")] @ adapter_sd[_key(i, m, "A")]))
    model.load_state_dict(sd)
    return model.eval()


@pytest.fixture(scope="module")
def tiny():
    """The JAX package's tiny LoRA llama (hidden 64, 4 heads of 16, 2 kv
    heads, intermediate 128, vocab 256), at 2 layers."""
    from transformers import LlamaConfig, LlamaForCausalLM

    torch.manual_seed(0)
    cfg = LlamaConfig(hidden_size=H, intermediate_size=128, num_hidden_layers=LAYERS,
                      num_attention_heads=4, num_key_value_heads=2, vocab_size=256,
                      max_position_embeddings=256, rms_norm_eps=1e-5, rope_theta=10000.0,
                      tie_word_embeddings=False)
    model = LlamaForCausalLM(cfg).eval()
    return model, cfg, {k: v.detach().numpy() for k, v in model.state_dict().items()}


def _common(batch_size=1, **kw):
    return dict(tp_degree=1, seq_len=64, max_context_length=32, batch_size=batch_size,
                dtype="float32", skip_warmup=True, **kw)


def _lora(max_loras, targets=TARGETS):
    return dict(max_loras=max_loras, max_lora_rank=RANK, target_modules=targets,
                lora_dtype="float32", lora_alpha=ALPHA)


def port_app(hf_cfg, sd, max_loras=1, family=tml, cfg_cls=None, targets=TARGETS, **kw):
    cfg_cls = cfg_cls or tml.LlamaInferenceConfig
    cfg = cfg_cls(TorchConfig(on_device_sampling_config=OnDeviceSamplingConfig(),
                              lora_config=LoraServingConfig(**_lora(max_loras, targets)),
                              **_common(**kw)),
                  load_config=lambda: hf_cfg.to_dict())

    class App(TorchModelForCausalLM):
        def get_state_dict(self):
            return {k: torch.from_numpy(v) for k, v in sd.items()}

    app = App("<memory>", cfg, model_family=family, device="cpu")
    app.load()
    return app


def jax_app(hf_cfg, sd, max_loras=1, **kw):
    cfg = jml.LlamaInferenceConfig(
        TpuConfig(on_device_sampling_config=JaxODSC(), lora_config=JaxLoraConfig(**_lora(max_loras)),
                  **_common(**kw)),
        load_config=lambda: hf_cfg.to_dict())

    class App(TpuModelForCausalLM):
        def get_state_dict(self):
            return sd

    app = App("<memory>", cfg, model_family=jml)
    app.load()
    return app


def test_single_adapter_matches_merged_hf(tiny):
    hf_model, hf_cfg, sd = tiny
    adapter_sd = make_adapter_sd(21)
    app = port_app(hf_cfg, sd)
    slot = app.set_lora_adapter("a", adapter_sd, adapter_cfg=ADAPTER_CFG)
    assert slot == app.lora_adapter_id("a") == 1 and app.lora_adapter_id(None) == 0
    gen = HuggingFaceGenerationAdapter(app)
    np.testing.assert_array_equal(
        gen.generate(PROMPT, max_new_tokens=16, adapter_ids=np.array([slot])),
        hf_greedy(merged(hf_model, adapter_sd), PROMPT, 16))
    base = hf_greedy(hf_model, PROMPT, 16)
    np.testing.assert_array_equal(
        gen.generate(PROMPT, max_new_tokens=16, adapter_ids=np.array([0])), base)
    np.testing.assert_array_equal(gen.generate(PROMPT, max_new_tokens=16), base)


def test_per_row_adapters_match_jax_and_merged_hf(tiny):
    """Two adapters and the base row in one batch: each row follows its own
    adapter, as in the JAX package's app."""
    hf_model, hf_cfg, sd = tiny
    sds = {"a": make_adapter_sd(21), "b": make_adapter_sd(22)}
    prompts = np.repeat(PROMPT, 3, axis=0)
    outs = []
    for app, Adapter in ((jax_app(hf_cfg, sd, max_loras=2, batch_size=3), JaxAdapter),
                         (port_app(hf_cfg, sd, max_loras=2, batch_size=3),
                          HuggingFaceGenerationAdapter)):
        for name, asd in sds.items():
            app.set_lora_adapter(name, asd, adapter_cfg=ADAPTER_CFG)
        ids = np.array([app.lora_adapter_id("a"), 0, app.lora_adapter_id("b")])
        outs.append(Adapter(app).generate(prompts, max_new_tokens=12, adapter_ids=ids))
    np.testing.assert_array_equal(outs[1], outs[0])
    np.testing.assert_array_equal(outs[1][0], hf_greedy(merged(hf_model, sds["a"]), PROMPT, 12)[0])
    np.testing.assert_array_equal(outs[1][1], hf_greedy(hf_model, PROMPT, 12)[0])
    np.testing.assert_array_equal(outs[1][2], hf_greedy(merged(hf_model, sds["b"]), PROMPT, 12)[0])


def test_lru_eviction_writes_in_place(tiny):
    """More adapters than slots: the LRU evicts into the same slot and swaps
    back, every write into the buffers in place (their addresses, which a
    captured graph reads, never change)."""
    hf_model, hf_cfg, sd = tiny
    sd_a, sd_b = make_adapter_sd(21), make_adapter_sd(22)
    app = port_app(hf_cfg, sd, max_loras=1)
    gen = HuggingFaceGenerationAdapter(app)
    ptrs = lora_pointers(app.params)
    assert len(ptrs) == 3 * len(TARGETS)
    state = replay_state(app.params, app.kv_cache)

    sa = app.set_lora_adapter("a", sd_a, adapter_cfg=ADAPTER_CFG)
    out_a = gen.generate(PROMPT, max_new_tokens=10, adapter_ids=np.array([sa]))
    np.testing.assert_array_equal(out_a, hf_greedy(merged(hf_model, sd_a), PROMPT, 10))
    sb = app.set_lora_adapter("b", sd_b, adapter_cfg=ADAPTER_CFG)
    assert sb == sa and "a" not in app.adapter_cache.slot_of
    out_b = gen.generate(PROMPT, max_new_tokens=10, adapter_ids=np.array([sb]))
    np.testing.assert_array_equal(out_b, hf_greedy(merged(hf_model, sd_b), PROMPT, 10))
    sa2 = app.set_lora_adapter("a")
    np.testing.assert_array_equal(
        gen.generate(PROMPT, max_new_tokens=10, adapter_ids=np.array([sa2])), out_a)
    # re-registering a resident adapter rewrites its slot on the next ensure
    app.set_lora_adapter("a", sd_b, adapter_cfg=ADAPTER_CFG)
    np.testing.assert_array_equal(
        gen.generate(PROMPT, max_new_tokens=10, adapter_ids=np.array([sa2])), out_b)
    assert lora_pointers(app.params) == ptrs
    assert replay_state(app.params, app.kv_cache) == state


def test_quantized_base_matches_jax(tiny):
    """LoRA deltas over an int8 base: the port's tokens are the JAX app's,
    and the adapter changes the rollout."""
    _, hf_cfg, sd = tiny
    sd_a = make_adapter_sd(21, scale=0.3)  # a delta that moves 2 layers' greedy tokens
    quant = dict(quantized=True, quantization_dtype="int8")
    outs = []
    for app, Adapter in ((jax_app(hf_cfg, sd, **quant), JaxAdapter),
                         (port_app(hf_cfg, sd, **quant), HuggingFaceGenerationAdapter)):
        assert "qw" in app.params["layers"]["attn"]["q_proj"]
        slot = app.set_lora_adapter("a", sd_a, adapter_cfg=ADAPTER_CFG)
        gen = Adapter(app)
        outs.append((gen.generate(PROMPT, max_new_tokens=8, adapter_ids=np.array([slot])),
                     gen.generate(PROMPT, max_new_tokens=8, adapter_ids=np.array([0]))))
    np.testing.assert_array_equal(outs[1][0], outs[0][0])
    np.testing.assert_array_equal(outs[1][1], outs[0][1])
    assert not np.array_equal(outs[1][0], outs[1][1])


def test_lora_on_tiny_mixtral_targets_attention_only():
    """On an MoE model the dense ``mlp`` targets have nothing to attach to:
    only the attention projections carry adapters, and the tokens equal the
    HF Mixtral with the attention deltas merged."""
    hf_model, hf_cfg = make_tiny_hf_mixtral(layers=LAYERS)
    sd = {k: v.detach().numpy() for k, v in hf_model.state_dict().items()}
    adapter_sd = make_adapter_sd(23, dims=dict(DIMS, gate_proj=(H, 96), down_proj=(96, H)))
    app = port_app(hf_cfg, sd, family=tmx, cfg_cls=tmx.MixtralInferenceConfig)
    assert "mlp" not in app.params["layers"]
    assert "lora_A" in app.params["layers"]["attn"]["q_proj"]
    slot = app.set_lora_adapter("a", adapter_sd, adapter_cfg=ADAPTER_CFG)
    out = HuggingFaceGenerationAdapter(app).generate(PROMPT, max_new_tokens=10,
                                                     adapter_ids=np.array([slot]))
    want = hf_greedy(merged(hf_model, adapter_sd, modules=["q_proj", "v_proj"]), PROMPT, 10)
    np.testing.assert_array_equal(out, want)


def test_adapters_load_from_peft_directories(tiny, tmp_path):
    """``lora_ckpt_paths`` adapters (adapter_model.safetensors +
    adapter_config.json) are resident after load()."""
    from safetensors.torch import save_file

    hf_model, hf_cfg, sd = tiny
    adapter_sd = make_adapter_sd(24)
    path = tmp_path / "adapter"
    os.makedirs(path)
    save_file({k: torch.from_numpy(v) for k, v in adapter_sd.items()},
              str(path / "adapter_model.safetensors"))
    (path / "adapter_config.json").write_text(json.dumps(ADAPTER_CFG))
    cfg = tml.LlamaInferenceConfig(
        TorchConfig(on_device_sampling_config=OnDeviceSamplingConfig(),
                    lora_config=dict(_lora(1), lora_ckpt_paths={"p": str(path)}), **_common()),
        load_config=lambda: hf_cfg.to_dict())
    assert TorchConfig.from_dict(cfg.tpu_config.to_dict()).lora_config.lora_ckpt_paths == {
        "p": str(path)}

    class App(TorchModelForCausalLM):
        def get_state_dict(self):
            return {k: torch.from_numpy(v) for k, v in sd.items()}

    app = App("<memory>", cfg, model_family=tml, device="cpu")
    app.load()
    slot = app.lora_adapter_id("p")
    out = HuggingFaceGenerationAdapter(app).generate(PROMPT, max_new_tokens=8,
                                                     adapter_ids=np.array([slot]))
    np.testing.assert_array_equal(out, hf_greedy(merged(hf_model, adapter_sd), PROMPT, 8))


# the JAX config's refusals of LoRA, each with a config that is valid without it
REFUSALS = {
    "fused_qkv": dict(fused_qkv=True),
    "mlp_kernel": dict(mlp_kernel_enabled=True),
    "async_mode": dict(async_mode=True, on_device_sampling_config={}),
    "speculation": dict(speculation_length=2),
    "k_step": dict(decode_steps_per_dispatch=4, on_device_sampling_config={}),
    "device_loop": dict(device_loop=True, on_device_sampling_config={}),
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_config_refusals_match_jax(name):
    kw = dict(seq_len=64, lora_config=_lora(1), **REFUSALS[name])
    with pytest.raises(ValueError) as ref:
        TpuConfig(**kw)
    assert "lora" in str(ref.value).lower() or "adapter" in str(ref.value).lower()
    with pytest.raises(ValueError, match=re.escape(str(ref.value))):
        TorchConfig(**kw)
    # valid without the adapters
    kw.pop("lora_config")
    TorchConfig(**kw)


def test_mlp_kernel_refuses_adapters():
    """mlp_block under mlp_kernel_enabled raises on adapter ids, naming
    them (the JAX rule), before any kernel runs."""
    cfg = tml.LlamaInferenceConfig(
        TorchConfig(seq_len=16, mlp_kernel_enabled=True), hidden_size=16, intermediate_size=32,
        num_hidden_layers=1, num_attention_heads=2, num_key_value_heads=1, vocab_size=32,
        rms_norm_eps=1e-5)
    arch = tml.build_arch(cfg)
    with pytest.raises(NotImplementedError, match="does not support LoRA adapters"):
        tbase.mlp_block(arch, {}, torch.zeros(1, 1, 16), adapter_ids=torch.zeros(1, dtype=torch.int32))
