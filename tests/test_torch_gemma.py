"""The Gemma 2/3 lineage of the port (``gemma3_text``, ``gemma2``,
``vaultgemma``), each held against the JAX package's family on a tiny random
config: the JAX app's params carried across with ``from_jax_params``,
float32 prefill logits within 1e-5 of the JAX app's, greedy tokens equal to
the JAX app's and to HF's (eager attention: HF's SDPA path drops the
attention softcap). The attention kernel flags are on in both packages
(Pallas in interpret mode; the port's plain versions on the CPU); the
per-layer flags and the softcap keep every attention kernel off there (the
JAX rule).

The switches bite at these widths: Gemma-2's and VaultGemma's q / k
projections are scaled up so the attention scores reach the softcap (5) and
their (untied) heads so the logits pass theirs (3), every norm weight is
drawn away from zero (the (1 + w) form), the window (8) is shorter than the
12-token prompt, Gemma-3's local rope base differs from its global one
(scaled linearly by 2), and the softmax scale is ``query_pre_attn_scalar``
(12) ** -0.5, not head_dim's. The scales were chosen so that the greedy
tokens vary (a tied head over large embeddings repeats a token)."""

import functools
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nxdi_tpu.config import TpuConfig
from nxdi_tpu.generation.hf_adapter import HuggingFaceGenerationAdapter as JaxAdapter
from nxdi_tpu.models import registry as jreg
from nxdi_tpu.ops import attention as jattn
from nxdi_tpu.ops import rope as jrope
from nxdi_tpu.utils.accuracy import hf_greedy_generate
from nxdi_tpu_torch.config import OnDeviceSamplingConfig, TorchConfig
from nxdi_tpu_torch.generation.hf_adapter import HuggingFaceGenerationAdapter
from nxdi_tpu_torch.models import base as tbase
from nxdi_tpu_torch.models import registry as treg
from nxdi_tpu_torch.models.convert import from_jax_params
from nxdi_tpu_torch.ops import attention as tattn
from nxdi_tpu_torch.ops import rope as trope
from nxdi_tpu_torch.runtime.application import (
    TorchModelForCausalLM,
    refuse_speculation,
    refuse_unported,
)

from test_torch_families import (
    LOGIT_TOL,
    NEW,
    PROMPT,
    _tc,
    jax_family_app,
    port_family_app,
    prefill_logits,
    strategies,
)
from test_torch_slice import fresh_jax_compiles

TINY = dict(hidden_size=64, intermediate_size=128, num_attention_heads=4, num_key_value_heads=2,
            head_dim=16, vocab_size=256, max_position_embeddings=256, rms_norm_eps=1e-5,
            rope_theta=10000.0, query_pre_attn_scalar=12, sliding_window=8,
            attn_implementation="eager")
CAPS = dict(attn_logit_softcapping=5.0, final_logit_softcapping=3.0,
            tie_word_embeddings=False)
# the capped families' weight scales: q / k projections, embeddings, head
CAPPED = dict(q_proj=6.0, k_proj=6.0, embed_tokens=4.0, lm_head=20.0)
# model_type -> (transformers class, its config class, config overrides, weight scales)
CASES = {
    "gemma3_text": ("Gemma3ForCausalLM", "Gemma3TextConfig", dict(
        num_hidden_layers=3, sliding_window_pattern=3, rope_local_base_freq=1000.0,
        rope_scaling=dict(rope_type="linear", factor=2.0)), {}),
    "gemma2": ("Gemma2ForCausalLM", "Gemma2Config", dict(num_hidden_layers=2, **CAPS), CAPPED),
    "vaultgemma": ("VaultGemmaForCausalLM", "VaultGemmaConfig",
                   dict(num_hidden_layers=2, **CAPS), CAPPED),
}


@pytest.fixture(autouse=True, scope="module")
def _fresh_jax_compiles():
    with fresh_jax_compiles():
        yield


@functools.lru_cache(maxsize=None)
def tiny_case(model_type):
    """(HF model, its config dict, the state dict as numpy): random norms
    N(0, 0.3) and the case's weight scales, so the (1 + w) norms and the
    softcaps bite."""
    import transformers

    cls_name, cfg_name, over, scales = CASES[model_type]
    torch.manual_seed(0)
    cfg_obj = getattr(transformers, cfg_name)(**{**TINY, **over})
    model = getattr(transformers, cls_name)(cfg_obj).eval()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "norm" in name:
                p.normal_(0, 0.3)
            for key, f in scales.items():
                if key in name:
                    p.mul_(f)
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    return model, cfg_obj.to_dict(), sd


@functools.lru_cache(maxsize=None)
def apps(model_type):
    """(JAX app, port app on the JAX app's params)."""
    _, cfg, sd = tiny_case(model_type)
    japp = jax_family_app(model_type, cfg, sd)
    tapp = port_family_app(model_type, cfg, params=from_jax_params(jax.device_get(japp.params)))
    return japp, tapp


def _attn_inputs(seed=5):
    rng = np.random.default_rng(seed)
    B, H, KV, S, W, D = 2, 4, 2, 3, 9, 8
    arrs = dict(q=rng.standard_normal((B, H, S, D)) * 3, k=rng.standard_normal((B, KV, W, D)) * 3,
                v=rng.standard_normal((B, KV, W, D)), k2=rng.standard_normal((B, KV, S, D)) * 3,
                v2=rng.standard_normal((B, KV, S, D)), sink=rng.standard_normal(H))
    arrs = {n: a.astype(np.float32) for n, a in arrs.items()}
    arrs["qpos"] = np.tile(np.arange(W, W + S, dtype=np.int32), (B, 1))
    arrs["kvpos"] = np.tile(np.arange(W, dtype=np.int32), (B, 1))
    return arrs


@pytest.mark.parametrize("fn", ["grouped", "positions", "two_part"])
@pytest.mark.parametrize("sink", [False, True])
def test_softcapped_attention_matches_jax(fn, sink):
    """cap * tanh(s / cap) on the scaled scores, before the mask and the
    sink, in the plain grouped, positional and two-part attention, against
    the JAX functions (f32, within 2e-6); the cap (2) bites: without it the
    outputs move by more than 1e-2."""
    a = _attn_inputs()
    t = {n: torch.from_numpy(x) for n, x in a.items()}
    j = {n: jnp.asarray(x) for n, x in a.items()}

    def run(mod, x, cap):
        s = x["sink"] if sink else None
        if fn == "grouped":
            mask = x["kvpos"][:, None, :] <= x["qpos"][:, :, None] - 2
            return mod.grouped_attention(x["q"], x["k"], x["v"], mask, scale=0.5, sink=s,
                                         logit_softcap=cap)
        if fn == "positions":
            return mod.attention_with_positions(x["q"], x["k"], x["v"], x["qpos"], x["kvpos"],
                                                scale=0.5, sliding_window=6, sink=s,
                                                logit_softcap=cap)
        return mod.attention_two_part(x["q"], x["k"], x["v"], x["k2"], x["v2"], x["qpos"],
                                      x["kvpos"], x["qpos"], scale=0.5, sliding_window=6, sink=s,
                                      logit_softcap=cap)

    got = run(tattn, t, 2.0).numpy()
    np.testing.assert_allclose(got, np.asarray(run(jattn, j, 2.0)), atol=2e-6, rtol=0)
    assert np.abs(got - run(tattn, t, None).numpy()).max() > 1e-2


def test_local_global_rope_matches_jax():
    """Gemma-3's [global, local] table (the global pair linear-scaled) and
    its cos / sin pair equal the JAX family's table (bit for bit) and the
    JAX forward's stacked cos / sin (within 2e-7: torch's and XLA's cos round
    a few values one ulp apart)."""
    _, cfg, _ = tiny_case("gemma3_text")
    jfam, jcfg_cls = jreg.get_family("gemma3_text")
    tfam, tcfg_cls = treg.get_family("gemma3_text")
    want = jfam.build_inv_freq(jcfg_cls(TpuConfig(**_tc()), load_config=lambda: dict(cfg)))
    got = tfam.build_inv_freq(tcfg_cls(TorchConfig(**_tc()), load_config=lambda: dict(cfg)))
    np.testing.assert_array_equal(got, want)
    assert got.shape == (2, 8) and not np.allclose(got[0], got[1])
    pos = np.arange(40, dtype=np.int32).reshape(2, 20)
    cos, sin = trope.rope_cos_sin_pair(torch.from_numpy(pos), got)
    for i in range(2):
        jc, js = jrope.rope_cos_sin(jnp.asarray(pos), want[i])
        np.testing.assert_allclose(cos[i].numpy(), np.asarray(jc), atol=2e-7, rtol=0)
        np.testing.assert_allclose(sin[i].numpy(), np.asarray(js), atol=2e-7, rtol=0)


@pytest.mark.parametrize("model_type", sorted(CASES))
def test_family_matches_jax_and_hf(model_type):
    """The port's family against the JAX package's on the same params:
    prefill logits within 1e-5, greedy tokens equal to the JAX app's and to
    HF's eager model; plain attention on both strategies (per-layer flags,
    the softcap: the JAX rule)."""
    hf_model, _, _ = tiny_case(model_type)
    japp, tapp = apps(model_type)
    np.testing.assert_allclose(prefill_logits(tapp), prefill_logits(japp), atol=LOGIT_TOL,
                               rtol=0)
    want = JaxAdapter(japp).generate(PROMPT, max_new_tokens=NEW)
    got = HuggingFaceGenerationAdapter(tapp).generate(PROMPT, max_new_tokens=NEW)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, hf_greedy_generate(hf_model, PROMPT, NEW))
    assert len(set(got[0, PROMPT.shape[1]:].tolist())) > 2  # the tokens move
    seen = strategies(tapp)
    assert seen["context_encoding_model"] == {"cte_xla"}
    assert seen["token_generation_model"] == {"tkg_two_part_xla"}


@pytest.mark.parametrize("model_type", sorted(CASES))
def test_converter_matches_jax(model_type):
    """The port's converter of the HF checkpoint gives the JAX converter's
    params leaf for leaf: the sandwich norms, VaultGemma's renamed pre-MLP
    norm, the window and local-rope flags."""
    _, cfg, sd = tiny_case(model_type)
    jfam, jcfg_cls = jreg.get_family(model_type)
    tfam, tcfg_cls = treg.get_family(model_type)
    want = from_jax_params(jfam.convert_hf_state_dict(
        sd, jcfg_cls(TpuConfig(**_tc()), load_config=lambda: dict(cfg))))
    got = tfam.convert_hf_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                                     tcfg_cls(TorchConfig(**_tc()), load_config=lambda: dict(cfg)))

    def leaves(tree, path=()):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, path + (k,))
        else:
            yield path, tree

    want, got = dict(leaves(want)), dict(leaves(got))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=str(k))
    if model_type == "gemma3_text":
        assert got[("layers", "use_local_rope")].tolist() == [True, True, False]
    # the random weights of the card's runs carry the converter's tree
    config = tcfg_cls(TorchConfig(**_tc()), load_config=lambda: dict(cfg))
    rand = dict(leaves(tfam.random_params(config, device="cpu")))
    assert rand.keys() == got.keys()
    for k in got:
        assert (rand[k].shape, rand[k].dtype) == (got[k].shape, got[k].dtype), k


def _dropped(model_type, arch_over, inv=None):
    """The port app on the JAX app's params with ``arch_over`` set in its arch
    (and its rope table from ``inv(config)``)."""
    _, cfg, _ = tiny_case(model_type)
    japp, _ = apps(model_type)
    family, cfg_cls = treg.get_family(model_type)
    shim = types.SimpleNamespace(
        build_arch=lambda c, **kw: family.build_arch(c, **{**arch_over, **kw}),
        build_inv_freq=inv or family.build_inv_freq)
    params = from_jax_params(jax.device_get(japp.params))
    if inv is not None:
        params["layers"].pop("use_local_rope")

    class App(TorchModelForCausalLM):
        def build_params(self):
            return params

    config = cfg_cls(TorchConfig(on_device_sampling_config=OnDeviceSamplingConfig(), **_tc()),
                     load_config=lambda: dict(cfg))
    app = App("<memory>", config, model_family=shim, device="cpu")
    app.load()
    return app


# switch -> (family, the arch fields that drop it, a rope table for the dropped arch)
SWITCHES = {
    "attn_logit_softcap": ("gemma2", dict(attn_logit_softcap=None), None),
    "final_logit_softcap": ("gemma2", dict(final_logit_softcap=None), None),
    "use_local_rope": ("gemma3_text", {}, lambda c: trope.default_inv_freq(16, 10000.0) / 2),
    "sandwich_norm": ("gemma3_text", dict(sandwich_norm=False), None),
    "gemma_norm": ("vaultgemma", dict(gemma_norm=False), None),
}


@pytest.mark.parametrize("switch", sorted(SWITCHES))
def test_dropped_switch_leaves_jax(switch):
    """Each switch bites: the port with it dropped (Gemma-3's local rope: one
    global table for every layer) is far from the JAX app's logits."""
    model_type, over, inv = SWITCHES[switch]
    japp, _ = apps(model_type)
    dropped = _dropped(model_type, over, inv)
    assert np.abs(prefill_logits(dropped) - prefill_logits(japp)).max() > 1e-3


def test_registry_and_refusals():
    """The registry serves the three types; the multimodal ``gemma3`` still
    raises. The mixed step and chain speculation carry the softcaps and the
    window (``test_torch_family_mixed.py``, ``test_torch_family_spec*.py``);
    a token tree on the windowed target is refused, naming the window;
    LoRA carries the local rope pair (as in the JAX package). On the card
    an attention kernel flag on a softcapped model raises, naming the
    softcap; the CPU takes the JAX rule."""
    for t in ("gemma3_text", "gemma2", "vaultgemma"):
        assert treg.get_family(t)[0].__name__.startswith("nxdi_tpu_torch.models.")
    with pytest.raises(NotImplementedError, match="'gemma3' is registered by the JAX package"):
        treg.get_family("gemma3")
    fam, cfg_cls = treg.get_family("gemma2")
    cfg = tiny_case("gemma2")[1]
    refuse_unported(fam, cfg_cls(TorchConfig(**_tc(mixed_dispatch=True,
                                                   is_block_kv_layout=True)),
                                 load_config=lambda: dict(cfg)))
    arch = fam.build_arch(cfg_cls(TorchConfig(**_tc()), load_config=lambda: dict(cfg)))
    refuse_speculation(arch, tree=False)
    with pytest.raises(NotImplementedError, match="token-tree speculation.*sliding_window"):
        refuse_speculation(arch, tree=True)
    g3, g3_cls = treg.get_family("gemma3_text")
    g3cfg = tiny_case("gemma3_text")[1]
    refuse_unported(g3, g3_cls(TorchConfig(**_tc(lora_config=dict(
        max_loras=2, max_lora_rank=4, target_modules=["q_proj"]))),
        load_config=lambda: dict(g3cfg)))
    with pytest.raises(NotImplementedError, match="attention logit softcap"):
        tbase._kernel_gate("attn_tkg_kernel_enabled", True, True, tbase._softcap_refused(arch), [])
    assert not tbase._kernel_gate("attn_kernel_enabled", True, False,
                                  tbase._softcap_refused(arch), [])


def test_published_widths():
    """Gemma-3-27B and Gemma-2-9B build their archs at the published widths:
    Gemma-3's 10 global layers of 62 (pattern 6), its softmax scale
    168 ** -0.5 (not head_dim's), the linear-scaled global table beside the
    local one, its interleaved ring split; Gemma-2's caps (50 / 30), head dim
    256 and alternating windows of 4096."""
    from nxdi_tpu_torch.models.gemma2 import modeling_gemma2 as tg2
    from nxdi_tpu_torch.models.gemma3 import modeling_gemma3 as tg3

    c3 = tg3.Gemma3InferenceConfig(TorchConfig(**_tc(window_sized_kv=True, sliding_window=1024,
                                                     seq_len=8192, dtype="bfloat16")),
                                   **tg3.GEMMA_3_27B)
    a3 = tg3.build_arch(c3)
    assert (a3.num_layers, a3.num_attention_heads, a3.num_kv_heads, a3.head_dim) == (62, 32, 16,
                                                                                      128)
    assert a3.interleaved_split() == (10, 52) and a3.hidden_act == "gelu_pytorch_tanh"
    assert a3.attention_scale == 168 ** -0.5 and a3.embed_scale == 5376 ** 0.5
    inv = tg3.build_inv_freq(c3)
    np.testing.assert_allclose(inv[0], trope.default_inv_freq(128, 1e6) / 8)
    np.testing.assert_allclose(inv[1], trope.default_inv_freq(128, 1e4))
    c2 = tg2.Gemma2InferenceConfig(TorchConfig(**_tc()), **tg2.GEMMA_2_9B)
    a2 = tg2.build_arch(c2)
    assert (a2.attn_logit_softcap, a2.final_logit_softcap, a2.head_dim) == (50.0, 30.0, 256)
    assert a2.kv_window_pattern[:4] == (True, False, True, False) and a2.sliding_window == 4096
