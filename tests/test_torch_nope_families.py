"""The global-NoPE hybrids and OLMo-3 in the port (``cohere2``: Command R7B's
parallel block; ``exaone4``; ``olmo3``), each held against the JAX package's
family and HF (``Cohere2ForCausalLM``, ``Exaone4ForCausalLM``,
``Olmo3ForCausalLM``) on a tiny random config: the JAX app's params carried
across with ``from_jax_params``, float32 prefill logits within 1e-5 of the
JAX app's, greedy tokens equal to the JAX app's and HF's, the converters
leaf for leaf, Command R7B on the window-sized ring, each switch dropped, and
the refusals.

The switches bite at these widths: the window (8) is far shorter than the
64-token prompts, layer 0 of 2 slides and ropes while layer 1 is global (and
NoPE on the hybrids), OLMo-3's global rope table is scaled linearly by 2 so
it differs from the window layers' plain one, and the norm weights are
drawn away from one (Cohere's around zero, with its projections scaled up
and its logits times 2, so that the greedy tokens of its tied head vary).
The attention kernel flags are on in both packages; the per-layer flags keep
every attention kernel off on the CPU (the JAX rule)."""

import functools
import types

import numpy as np
import pytest
import torch

import jax

from nxdi_tpu.config import TpuConfig
from nxdi_tpu.generation.hf_adapter import HuggingFaceGenerationAdapter as JaxAdapter
from nxdi_tpu.models import registry as jreg
from nxdi_tpu.utils.accuracy import hf_greedy_generate
from nxdi_tpu_torch.config import OnDeviceSamplingConfig, TorchConfig
from nxdi_tpu_torch.generation.hf_adapter import HuggingFaceGenerationAdapter
from nxdi_tpu_torch.models import registry as treg
from nxdi_tpu_torch.models.convert import from_jax_params
from nxdi_tpu_torch.runtime.application import (
    TorchModelForCausalLM,
    refuse_speculation,
    refuse_unported,
)

from test_torch_families import LOGIT_TOL, _tc, jax_family_app, port_family_app, strategies
from test_torch_slice import fresh_jax_compiles

W = 8
NEW = 10
PROMPTS = np.random.default_rng(23).integers(1, 256, size=(2, 64)).astype(np.int64)
APP = dict(seq_len=128, max_context_length=64)
TINY = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, head_dim=16, vocab_size=256, max_position_embeddings=256,
            rope_theta=10000.0, sliding_window=W,
            layer_types=["sliding_attention", "full_attention"], attn_implementation="eager")
# model_type -> (transformers class, config overrides, the norm weights' mean
# and std, weight scales by name)
CASES = {
    "cohere2": ("Cohere2ForCausalLM", dict(layer_norm_eps=1e-5, logit_scale=2.0,
                                           tie_word_embeddings=True),
                (0.0, 1.0), dict(q_proj=3.0, k_proj=3.0, o_proj=4.0, down_proj=4.0)),
    "exaone4": ("Exaone4ForCausalLM", dict(rms_norm_eps=1e-5, tie_word_embeddings=False),
                (1.0, 0.3), {}),
    "olmo3": ("Olmo3ForCausalLM", dict(rms_norm_eps=1e-5, tie_word_embeddings=False,
                                       rope_scaling=dict(rope_type="linear", factor=2.0)),
              (1.0, 0.3), {}),
}


@pytest.fixture(autouse=True, scope="module")
def _fresh_jax_compiles():
    with fresh_jax_compiles():
        yield


@functools.lru_cache(maxsize=None)
def tiny_case(model_type):
    """(HF model, its config dict, the state dict as numpy): the case's
    random norm weights and weight scales."""
    import transformers

    cls_name, over, (mean, std), scales = CASES[model_type]
    torch.manual_seed(0)
    cfg = getattr(transformers, cls_name.replace("ForCausalLM", "Config"))(**{**TINY, **over})
    model = getattr(transformers, cls_name)(cfg).eval()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "norm" in name:
                p.normal_(mean, std)
            for key, f in scales.items():
                if key in name:
                    p.mul_(f)
    return model, cfg.to_dict(), {k: v.detach().numpy() for k, v in model.state_dict().items()}


@functools.lru_cache(maxsize=None)
def apps(model_type):
    """(JAX app, port app on the JAX app's params)."""
    _, cfg, sd = tiny_case(model_type)
    japp = jax_family_app(model_type, cfg, sd, **APP)
    tapp = port_family_app(model_type, cfg, params=from_jax_params(jax.device_get(japp.params)),
                           **APP)
    return japp, tapp


def logits_of(app, prompt=PROMPTS[:1]):
    S = prompt.shape[1]
    out = app.forward(prompt.astype(np.int32), np.arange(S, dtype=np.int32)[None],
                      last_token_index=np.array([S - 1], np.int32))
    logits = out["logits"]
    return logits.numpy() if isinstance(logits, torch.Tensor) else np.asarray(
        jax.device_get(logits))


def configs(model_type, cfg=None, **tc):
    cfg = cfg or tiny_case(model_type)[1]
    _, jcls = jreg.get_family(model_type)
    _, tcls = treg.get_family(model_type)
    return (jcls(TpuConfig(**_tc(**APP, **tc)), load_config=lambda: dict(cfg)),
            tcls(TorchConfig(**_tc(**APP, **tc)), load_config=lambda: dict(cfg)))


@pytest.mark.parametrize("model_type", sorted(CASES))
def test_family_matches_jax_and_hf(model_type):
    """The port's family against the JAX package's on the same params:
    prefill logits of a 64-token prompt within 1e-5, greedy tokens equal to
    the JAX app's and to HF's; plain attention on both strategies (the
    per-layer flags: the JAX rule)."""
    hf_model, _, _ = tiny_case(model_type)
    japp, tapp = apps(model_type)
    np.testing.assert_allclose(logits_of(tapp), logits_of(japp), atol=LOGIT_TOL, rtol=0)
    prompt = PROMPTS[:1]
    want = JaxAdapter(japp).generate(prompt, max_new_tokens=NEW)
    got = HuggingFaceGenerationAdapter(tapp).generate(prompt, max_new_tokens=NEW)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, hf_greedy_generate(hf_model, prompt, NEW))
    assert len(set(got[0, prompt.shape[1]:].tolist())) > 2  # the tokens move
    seen = strategies(tapp)
    assert seen["context_encoding_model"] == {"cte_xla"}
    assert seen["token_generation_model"] == {"tkg_two_part_xla"}


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


@pytest.mark.parametrize("model_type", sorted(CASES) + ["exaone4 global"])
def test_converter_matches_jax(model_type):
    """The port's converter gives the JAX converter's params leaf for leaf:
    Cohere's one norm on both keys, EXAONE's post-norms on the OLMo-2 keys,
    the window / rope / local-rope flags (none on a non-hybrid EXAONE: every
    layer global and roped); random_params has the same tree."""
    name = model_type.split()[0]
    _, cfg, sd = tiny_case(name)
    if model_type == "exaone4 global":
        cfg = dict(cfg, sliding_window=None, layer_types=None)
    jcfg, tcfg = configs(name, cfg)
    jfam, tfam = jreg.get_family(name)[0], treg.get_family(name)[0]
    want = dict(_leaves(from_jax_params(jfam.convert_hf_state_dict(sd, jcfg))))
    got = dict(_leaves(tfam.convert_hf_state_dict(
        {k: torch.from_numpy(v) for k, v in sd.items()}, tcfg)))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=str(k))
    flags = {k[1] for k in got if k[0] == "layers" and k[1].startswith("use_")}
    assert flags == {"cohere2": {"use_sliding_window", "use_rope"},
                     "exaone4": {"use_sliding_window", "use_rope"},
                     "olmo3": {"use_sliding_window", "use_local_rope"},
                     "exaone4 global": set()}[model_type]
    for f in flags:
        assert got[("layers", f)].tolist() == [True, False]
    rand = dict(_leaves(tfam.random_params(tcfg, device="cpu")))
    assert rand.keys() == got.keys()
    for k in got:
        assert (rand[k].shape, rand[k].dtype) == (got[k].shape, got[k].dtype), k


def test_cohere2_ring_matches_hf_and_jax():
    """Command R7B's shape on the window-sized ring (its global layer keeps
    the full-length cache, its window layer an 8-slot ring): generate() of
    two 64-token prompts 3x past the window, attention kernel flags on,
    equal to HF greedy and to the JAX package's ring app."""
    hf_model, cfg, sd = tiny_case("cohere2")
    ring = dict(APP, window_sized_kv=True, sliding_window=W, batch_size=2)
    tapp = port_family_app("cohere2", cfg, sd=sd, **ring)
    got = HuggingFaceGenerationAdapter(tapp).generate(PROMPTS, max_new_tokens=3 * W)
    np.testing.assert_array_equal(got, hf_greedy_generate(hf_model, PROMPTS, 3 * W))
    shapes = {k: tuple(v.shape) for k, v in tapp.kv_cache.items()}
    assert shapes["k"] == (1, 2, 2, 128, 16) and shapes["k_win"] == (1, 2, 2, W, 16)
    assert strategies(tapp)["token_generation_model"] == {"tkg_two_part_xla"}
    japp = jax_family_app("cohere2", cfg, sd, **ring)
    np.testing.assert_array_equal(JaxAdapter(japp).generate(PROMPTS, max_new_tokens=3 * W), got)


def _dropped(model_type, arch_over, drop=(), inv=None):
    """The port app on the JAX app's params with ``arch_over`` set in its
    arch, the layer params ``drop`` removed (and its rope table from
    ``inv(config)``)."""
    _, cfg, _ = tiny_case(model_type)
    japp, _ = apps(model_type)
    family, cfg_cls = treg.get_family(model_type)
    shim = types.SimpleNamespace(
        build_arch=lambda c, **kw: family.build_arch(c, **{**arch_over, **kw}),
        build_inv_freq=inv or family.build_inv_freq)
    params = from_jax_params(jax.device_get(japp.params))
    for key in drop:
        params["layers"].pop(key)

    class App(TorchModelForCausalLM):
        def build_params(self):
            return params

    config = cfg_cls(TorchConfig(on_device_sampling_config=OnDeviceSamplingConfig(),
                                 **_tc(**APP)), load_config=lambda: dict(cfg))
    app = App("<memory>", config, model_family=shim, device="cpu")
    app.load()
    return app


# switch -> (family, the arch fields that drop it, layer params dropped, a rope table)
SWITCHES = {
    "parallel_block": ("cohere2", dict(parallel_block=False), (), None),
    "global NoPE": ("exaone4", {}, ("use_rope",), None),
    "use_local_rope": ("olmo3", {}, ("use_local_rope",),
                       lambda c: treg.get_family("olmo3")[0].build_inv_freq(c)[0]),
}


@pytest.mark.parametrize("switch", sorted(SWITCHES))
def test_dropped_switch_leaves_jax(switch):
    """Each switch bites: the port with it dropped (the parallel block as a
    sequential one; EXAONE's global layer roped; OLMo-3's global table on
    every layer) is far from the JAX app's logits."""
    model_type, over, drop, inv = SWITCHES[switch]
    japp, _ = apps(model_type)
    dropped = _dropped(model_type, over, drop, inv)
    assert np.abs(logits_of(dropped) - logits_of(japp)).max() > 1e-3


def test_registry_and_refusals():
    """The registry serves the three types. Chain speculation, the mixed
    step and LoRA carry Cohere's parallel block, window and LayerNorm (as in
    the JAX package); a token tree on its windowed stack is refused, naming
    the window."""
    for t in ("cohere2", "exaone4", "olmo3"):
        assert treg.get_family(t)[0].__name__ == f"nxdi_tpu_torch.models.{t}.modeling_{t}"
    fam, cfg_cls = treg.get_family("cohere2")
    cfg = tiny_case("cohere2")[1]

    def config(**kw):
        return cfg_cls(TorchConfig(**_tc(**kw)), load_config=lambda: dict(cfg))

    refuse_speculation(fam.build_arch(config()), tree=False)
    with pytest.raises(NotImplementedError, match="token-tree speculation.*sliding_window"):
        refuse_speculation(fam.build_arch(config()), tree=True)
    refuse_unported(fam, config(lora_config=dict(max_loras=2, max_lora_rank=4,
                                                 target_modules=["q_proj"])))
    refuse_unported(fam, config(mixed_dispatch=True, is_block_kv_layout=True))


def test_published_widths():
    """Command R7B builds its arch at the published widths: 32 query heads
    over 8 kv heads of 128, 32 layers, windows of 4096 on three layers of
    four (the fourth global and NoPE), the parallel block over one
    weight-only LayerNorm, logits times 0.25, tied embeddings, and under
    window_sized_kv the 8 global layers' cache beside the 24 window layers'
    ring."""
    from nxdi_tpu_torch.models.cohere2 import modeling_cohere2 as tc2

    cfg = tc2.Cohere2InferenceConfig(
        TorchConfig(**_tc(dtype="bfloat16", window_sized_kv=True, sliding_window=4096,
                          seq_len=8192)), **tc2.COMMAND_R7B)
    a = tc2.build_arch(cfg)
    assert (a.num_layers, a.num_attention_heads, a.num_kv_heads, a.head_dim) == (32, 32, 8, 128)
    assert (a.intermediate_size, a.vocab_size, a.logits_scaling) == (14336, 256000, 4.0)
    assert a.parallel_block and a.layernorm and a.rope_interleaved and a.tie_word_embeddings
    assert [a.layer_window(i) for i in range(4)] == [4096, 4096, 4096, None]
    assert a.layer_chunk(0) is None
    assert a.interleaved_split() == (8, 24)
