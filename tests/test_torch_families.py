"""The model registry and the dense Llama-lineage families of the port, each
held against the JAX package's family on a tiny random config: the JAX
app's params carried across with ``from_jax_params``, float32 prefill logits
within 1e-5 of the JAX app's, greedy tokens equal to the JAX app's and, where
transformers has the class, to HF's. The attention kernel flags are on in
both packages (Pallas in interpret mode; the port's kernels' plain versions
on the CPU). Mistral's and Ministral's window (8) is shorter than the
prompt, so it bites in the prefill and in every decode step; Qwen3's head
dim (24) is decoupled from hidden / heads. MiniCPM and InternLM3 have no
transformers class: their weights are a tiny Llama's, and they are held to
the JAX app alone."""

import numpy as np
import pytest
import torch

import jax

from nxdi_tpu.config import OnDeviceSamplingConfig as JaxODSC
from nxdi_tpu.config import TpuConfig
from nxdi_tpu.generation.hf_adapter import HuggingFaceGenerationAdapter as JaxAdapter
from nxdi_tpu.models import registry as jreg
from nxdi_tpu.runtime.application import TpuModelForCausalLM
from nxdi_tpu.utils.accuracy import hf_greedy_generate
from nxdi_tpu_torch.config import OnDeviceSamplingConfig, TorchConfig
from nxdi_tpu_torch.generation.hf_adapter import HuggingFaceGenerationAdapter
from nxdi_tpu_torch.models import registry as treg
from nxdi_tpu_torch.models.convert import from_jax_params
from nxdi_tpu_torch.runtime.application import TorchModelForCausalLM

from test_torch_slice import fresh_jax_compiles

LOGIT_TOL = 1e-5
PROMPT = np.array([[5, 9, 3, 17, 2, 8, 11, 42, 7, 13, 21, 4]], dtype=np.int64)
NEW = 10
TINY = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, vocab_size=256, max_position_embeddings=256,
            rms_norm_eps=1e-5, rope_theta=10000.0, tie_word_embeddings=False)
# model_type -> (transformers class, or None: a tiny Llama's weights; config overrides)
FAMILIES = {
    "mistral": ("MistralForCausalLM", dict(sliding_window=8)),
    "qwen2": ("Qwen2ForCausalLM", dict(tie_word_embeddings=True)),
    "qwen3": ("Qwen3ForCausalLM", dict(head_dim=24)),
    "hunyuan_v1_dense": ("HunYuanDenseV1ForCausalLM", dict(head_dim=16)),
    "gemma": ("GemmaForCausalLM", dict(head_dim=16, tie_word_embeddings=True)),
    "helium": ("HeliumForCausalLM", dict(attention_bias=True, head_dim=16)),
    "ernie4_5": ("Ernie4_5ForCausalLM", dict(use_bias=True)),
    "granite": ("GraniteForCausalLM", dict(embedding_multiplier=2.0, attention_multiplier=0.2,
                                           residual_multiplier=0.5, logits_scaling=1.5)),
    "minicpm": (None, dict(scale_emb=12.0, scale_depth=1.4, dim_model_base=32)),
    "seed_oss": ("SeedOssForCausalLM", dict(attention_bias=True, attention_out_bias=True,
                                            head_dim=16)),
    "internlm3": (None, dict(qkv_bias=True, bias=True)),
    "smollm3": ("SmolLM3ForCausalLM", dict(no_rope_layers=[1, 0], pad_token_id=0)),
    "olmo2": ("Olmo2ForCausalLM", {}),
    "arcee": ("ArceeForCausalLM", {}),
    "ministral": ("MinistralForCausalLM", dict(head_dim=16, sliding_window=8,
                                               layer_types=["sliding_attention",
                                                            "full_attention"])),
}
FLAGS = dict(attn_kernel_enabled=True, attn_tkg_kernel_enabled=True)


@pytest.fixture(autouse=True, scope="module")
def _fresh_jax_compiles():
    with fresh_jax_compiles():
        yield


def tiny_family(model_type, seed=0):
    """(HF model or None, the HF config dict, the state dict as numpy)."""
    import transformers

    cls_name, over = FAMILIES[model_type]
    torch.manual_seed(seed)
    if cls_name is None:  # remote-code families: a tiny Llama's weights
        bias = model_type == "internlm3"
        base = transformers.LlamaConfig(**TINY, attention_bias=bias, mlp_bias=bias)
        model = transformers.LlamaForCausalLM(base).eval()
        cfg = {**base.to_dict(), **over, "model_type": model_type}
        sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
        return None, cfg, sd
    cfg_obj = getattr(transformers, cls_name.replace("ForCausalLM", "Config"))(**{**TINY, **over})
    model = getattr(transformers, cls_name)(cfg_obj).eval()
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    return model, cfg_obj.to_dict(), sd


def _tc(**kw):
    d = dict(tp_degree=1, seq_len=64, max_context_length=32, batch_size=1, dtype="float32",
             skip_warmup=True, output_logits=True, **FLAGS)
    d.update(kw)
    return d


def jax_family_app(model_type, cfg, sd, **kw):
    family, cfg_cls = jreg.get_family(model_type)
    config = cfg_cls(TpuConfig(on_device_sampling_config=JaxODSC(), **_tc(**kw)),
                     load_config=lambda: dict(cfg))

    class App(TpuModelForCausalLM):
        def get_state_dict(self):
            return sd

    app = App("<memory>", config, model_family=family)
    app.load()
    return app


def port_family_app(model_type, cfg, params=None, sd=None, **kw):
    family, cfg_cls = treg.get_family(model_type)
    config = cfg_cls(TorchConfig(on_device_sampling_config=OnDeviceSamplingConfig(), **_tc(**kw)),
                     load_config=lambda: dict(cfg))

    class App(TorchModelForCausalLM):
        def get_state_dict(self):
            return {k: torch.from_numpy(v) for k, v in sd.items()}

        def build_params(self):
            return params if params is not None else super().build_params()

    app = App("<memory>", config, model_family=family, device="cpu")
    app.load()
    return app


def prefill_logits(app, prompt=PROMPT):
    S = prompt.shape[1]
    out = app.forward(prompt.astype(np.int32), np.arange(S, dtype=np.int32)[None],
                      last_token_index=np.array([S - 1], np.int32))
    logits = out["logits"]
    return logits.numpy() if isinstance(logits, torch.Tensor) else np.asarray(
        jax.device_get(logits))


def strategies(app):
    return {tag: {s for ss in w.attention_strategies.values() for s in ss}
            for tag, w in app.models.items()}


@pytest.mark.parametrize("model_type", sorted(FAMILIES))
def test_family_matches_jax_and_hf(model_type):
    """The port's family against the JAX package's on the same params:
    prefill logits within 1e-5, greedy tokens equal (and equal to HF's where
    transformers has the class); the kernels' plain versions ran where the
    JAX rule runs its kernels (per-layer flags: plain attention)."""
    hf_model, cfg, sd = tiny_family(model_type)
    japp = jax_family_app(model_type, cfg, sd)
    tapp = port_family_app(model_type, cfg, params=from_jax_params(jax.device_get(japp.params)))
    np.testing.assert_allclose(prefill_logits(tapp), prefill_logits(japp), atol=LOGIT_TOL,
                               rtol=0)
    want = JaxAdapter(japp).generate(PROMPT, max_new_tokens=NEW)
    got = HuggingFaceGenerationAdapter(tapp).generate(PROMPT, max_new_tokens=NEW)
    np.testing.assert_array_equal(got, want)
    if hf_model is not None:
        np.testing.assert_array_equal(got, hf_greedy_generate(hf_model, PROMPT, NEW))
    flagged = model_type in ("smollm3", "ministral")  # per-layer flags: the JAX rule
    seen = strategies(tapp)
    assert seen["context_encoding_model"] == {"cte_xla" if flagged else "cte_flash_kernel"}
    assert seen["token_generation_model"] == {
        "tkg_two_part_xla" if flagged else "tkg_fused_kernel_stacked"}


@pytest.mark.parametrize("model_type", ["mistral", "gemma", "olmo2", "smollm3"])
def test_family_converter_matches_jax(model_type):
    """The port's converter of the HF checkpoint gives the JAX converter's
    params leaf for leaf (keys, shapes, values), new keys included:
    per-layer flags, flat and gemma norms."""
    _, cfg, sd = tiny_family(model_type)
    jfam, jcfg_cls = jreg.get_family(model_type)
    tfam, tcfg_cls = treg.get_family(model_type)
    jparams = jfam.convert_hf_state_dict(
        sd, jcfg_cls(TpuConfig(**_tc()), load_config=lambda: dict(cfg)))
    tparams = tfam.convert_hf_state_dict(
        {k: torch.from_numpy(v) for k, v in sd.items()},
        tcfg_cls(TorchConfig(**_tc()), load_config=lambda: dict(cfg)))

    def leaves(tree, path=()):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, path + (k,))
        else:
            yield path, tree

    want = dict(leaves(from_jax_params(jparams)))
    got = dict(leaves(tparams))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=str(k))


def test_registry_keys_and_errors():
    """Every ported type resolves to the port's module and config class; a
    type the JAX package registers but the port does not raises, naming it;
    an unknown type raises KeyError listing the registered ones."""
    ported = set(FAMILIES) | {"llama", "mixtral", "deepseek", "deepseek_v3", "minicpm4",
                              "qwen3_moe", "gpt_oss", "minimax_m2", "dbrx", "phimoe", "afmoe",
                              "phi3", "gemma3_text", "gemma2", "vaultgemma", "llama4",
                              "llama4_text", "cohere2", "exaone4", "olmo3", "starcoder2",
                              "falcon", "gpt_neox", "phi", "glm4", "stablelm", "persimmon",
                              "apertus", "orion", "opt", "biogpt", "xglm", "gpt2",
                              "gpt_bigcode", "mimo_v2", "lfm2"}
    assert set(treg.known_model_types()) == ported
    for t in ported:
        module, cfg_cls = treg.get_family(t)
        assert module.__name__.startswith("nxdi_tpu_torch.models.")
        assert cfg_cls.__name__ == jreg.get_family(t)[1].__name__
    assert treg.NOT_PORTED | ported == set(jreg.known_model_types())
    assert not treg.NOT_PORTED & ported
    with pytest.raises(NotImplementedError, match="'falcon_h1' is registered by the JAX package"):
        treg.get_family("falcon_h1")
    with pytest.raises(KeyError, match="Unknown model_type 'no_such'.*'qwen3'"):
        treg.get_family("no_such")
