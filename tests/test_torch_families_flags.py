"""The family switches of the dense Llama-lineage families, op by op and
layer by layer against the JAX package's functions, and the paths around
them: a windowed Mistral on the paged engine against the JAX engine, a
windowed Mixtral against the JAX app, Gemma's fused projections (the tanh
GELU through the fused MLP kernel's plain version) against the JAX app's
Pallas kernels, the published widths the card runs, and the refusals of
the paths that do not carry a switch."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nxdi_tpu.config import OnDeviceSamplingConfig as JaxODSC
from nxdi_tpu.config import TpuConfig
from nxdi_tpu.generation.hf_adapter import HuggingFaceGenerationAdapter as JaxAdapter
from nxdi_tpu.kvcache.kv_cache import KVCacheSpec as JaxSpec
from nxdi_tpu.models import base as jbase
from nxdi_tpu.models.mixtral import modeling_mixtral as jmx
from nxdi_tpu.ops import norms as jnorms
from nxdi_tpu.ops import rope as jrope
from nxdi_tpu.runtime.application import TpuModelForCausalLM
from nxdi_tpu.serving import InferenceEngine as JaxEngine
from nxdi_tpu.serving import SamplingParams as JaxSP
from nxdi_tpu.serving import SchedulerConfig as JaxSC
from nxdi_tpu.utils.accuracy import hf_greedy_generate
from nxdi_tpu_torch.config import OnDeviceSamplingConfig, TorchConfig
from nxdi_tpu_torch.generation.hf_adapter import HuggingFaceGenerationAdapter
from nxdi_tpu_torch.kvcache.kv_cache import KVCacheSpec
from nxdi_tpu_torch.models import base as tbase
from nxdi_tpu_torch.models import dense as tdense
from nxdi_tpu_torch.models.convert import from_jax_params
from nxdi_tpu_torch.models.gemma import modeling_gemma as tgemma
from nxdi_tpu_torch.models.mistral import modeling_mistral as tmistral
from nxdi_tpu_torch.models.mixtral import modeling_mixtral as tmx
from nxdi_tpu_torch.models.qwen3 import modeling_qwen3 as tqwen3
from nxdi_tpu_torch.ops import norms as tnorms
from nxdi_tpu_torch.ops import rope as trope
from nxdi_tpu_torch.runtime.application import (TorchModelForCausalLM, family_switches,
                                                 refuse_speculation)
from nxdi_tpu_torch.serving import InferenceEngine, SamplingParams, SchedulerConfig

from test_torch_families import (
    FLAGS,
    LOGIT_TOL,
    NEW,
    PROMPT,
    jax_family_app,
    port_family_app,
    prefill_logits,
    strategies,
    tiny_family,
)
from test_torch_slice import fresh_jax_compiles

JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


@pytest.fixture(autouse=True, scope="module")
def _fresh_jax_compiles():
    with fresh_jax_compiles():
        yield


def _np(t):
    return np.asarray(jax.device_get(t)).astype(np.float32) if not isinstance(
        t, torch.Tensor) else t.float().numpy()


def _pair(rng, shape, dtype):
    x = rng.standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x).to(dtype), jnp.asarray(x).astype(JDT[dtype])


# ---------------------------------------------------------------------------
# Ops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_interleaved_rope_matches_jax(dtype):
    """The adjacent-pair (GPT-J) rope against the JAX function, bit for bit
    in f32 and bf16, at positions up to 300."""
    rng = np.random.default_rng(0)
    tq, jq = _pair(rng, (2, 4, 7, 32), dtype)
    tk, jk = _pair(rng, (2, 2, 7, 32), dtype)
    pos = np.array([[0, 1, 2, 3, 4, 5, 6], [294, 295, 296, 297, 298, 299, 300]], np.int32)
    inv = trope.default_inv_freq(32, 10000.0)
    tcos, tsin = trope.rope_cos_sin(torch.from_numpy(pos), inv)
    jcos, jsin = jrope.rope_cos_sin(jnp.asarray(pos), inv)
    for t, j in zip(trope.apply_rotary_pos_emb_interleaved(tq, tk, tcos, tsin),
                    jrope.apply_rotary_pos_emb_interleaved(jq, jk, jcos, jsin)):
        np.testing.assert_allclose(_np(t), _np(j), rtol=0, atol=1e-6)


@pytest.mark.parametrize("gemma_style", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rms_norm_matches_jax(gemma_style, dtype):
    """RMSNorm, with and without Gemma's (1 + w) float32 weight, against the
    JAX function: within 1e-6 in f32 (the mean's summation order differs),
    within one bf16 rounding in bf16."""
    rng = np.random.default_rng(1)
    tx, jx = _pair(rng, (3, 5, 48), dtype)
    tw, jw = _pair(rng, (48,), dtype)
    tol = dict(rtol=0, atol=1e-6) if dtype == torch.float32 else dict(rtol=2 ** -8, atol=0)
    np.testing.assert_allclose(_np(tnorms.rms_norm(tx, tw, 1e-6, gemma_style=gemma_style)),
                               _np(jnorms.rms_norm(jx, jw, 1e-6, gemma_style=gemma_style)), **tol)


@pytest.mark.parametrize("name", sorted(tbase.ACT_FNS))
def test_activations_match_jax(name):
    """Every activation of ACT_FNS against the JAX package's (its "gelu" is
    jax.nn.gelu's default, the tanh approximation; the port's "gelu_exact",
    HF's "gelu", is jax.nn.gelu without the approximation)."""
    x = np.linspace(-6, 6, 257).astype(np.float32)
    jax_act = (functools.partial(jax.nn.gelu, approximate=False) if name == "gelu_exact"
               else jbase.ACT_FNS[name])
    np.testing.assert_allclose(tbase.ACT_FNS[name](torch.from_numpy(x)).numpy(),
                               np.asarray(jax_act(jnp.asarray(x))), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

L_H, L_HEADS, L_KV, L_D, L_I, L_S = 48, 4, 2, 16, 80, 10

LAYER_CASES = {
    # OLMo-2: flat q/k norms, post-block norms; a scaled residual
    "olmo2": dict(qk_norm_flat=True, qk_norm_flat_qdim=L_HEADS * L_D, post_block_norm=True,
                  residual_multiplier=0.5),
    # Arcee: a non-gated relu2 MLP, o_proj bias
    "arcee": dict(gated_mlp=False, hidden_act="relu2", attention_o_bias=True),
    # Gemma: (1 + w) norms, tanh GELU, per-head q/k norms (Qwen3's), a scale
    "gemma_qk": dict(gemma_norm=True, hidden_act="gelu_pytorch_tanh", qk_norm=True,
                     attention_scale=0.3),
    # a no-rope, windowed layer of a mixed stack (SmolLM3's / Ministral's flags)
    "flags_on": dict(sliding_window=4, rope_interleaved=True),
    "flags_off": dict(sliding_window=4),
}


def _layer_params(case, rng, arch):
    def r(*shape):
        return (rng.standard_normal(shape) * 0.2).astype(np.float32)

    attn = {n: {"w": r(L_H, w)} for n, w in (("q_proj", L_HEADS * L_D), ("k_proj", L_KV * L_D),
                                             ("v_proj", L_KV * L_D))}
    attn["o_proj"] = {"w": r(L_HEADS * L_D, L_H)}
    if arch["attention_o_bias"]:
        attn["o_proj"]["b"] = r(L_H)
    if arch["qk_norm"]:
        attn["q_norm"], attn["k_norm"] = 1 + r(L_D), 1 + r(L_D)
    if arch["qk_norm_flat"]:
        attn["q_norm"], attn["k_norm"] = 1 + r(L_HEADS * L_D), 1 + r(L_KV * L_D)
    mlp = {"up_proj": {"w": r(L_H, L_I)}, "down_proj": {"w": r(L_I, L_H)}}
    if arch["gated_mlp"]:
        mlp["gate_proj"] = {"w": r(L_H, L_I)}
    lp = {"input_layernorm": 1 + r(L_H), "post_attention_layernorm": 1 + r(L_H),
          "attn": attn, "mlp": mlp}
    if case.startswith("flags"):
        on = case == "flags_on"
        lp["use_rope"] = np.array(not on)
        lp["use_sliding_window"] = np.array(on)
    return lp


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_decoder_layer_matches_jax(case):
    """One decoder layer's prefill (its cache write included) against the
    JAX package's ``decoder_layer`` for each switch; the per-layer flags ride
    the layer's params as 0-d bools."""
    flags = {**dict(gated_mlp=True, qk_norm=False, qk_norm_flat=False, attention_o_bias=False),
             **LAYER_CASES[case]}
    common = dict(num_layers=1, hidden_size=L_H, num_attention_heads=L_HEADS,
                  num_kv_heads=L_KV, head_dim=L_D, intermediate_size=L_I, vocab_size=64,
                  vocab_pad=0, dtype="float32", **flags)
    jarch, tarch = jbase.DecoderArch(**common), tbase.DecoderArch(**common)
    rng = np.random.default_rng(2)
    lp = _layer_params(case, rng, flags)
    x = rng.standard_normal((2, L_S, L_H)).astype(np.float32)
    pos = np.tile(np.arange(L_S, dtype=np.int32), (2, 1))
    inv = trope.default_inv_freq(L_D, 10000.0)
    jcos, jsin = jrope.rope_cos_sin(jnp.asarray(pos), inv)
    tcos, tsin = trope.rope_cos_sin(torch.from_numpy(pos), inv)
    spec = dict(num_layers=1, batch_size=2, num_kv_heads=L_KV, max_len=16, head_dim=L_D,
                dtype="float32")
    zeros = np.zeros((2, L_KV, 16, L_D), np.float32)
    jh, (jk, _) = jbase.decoder_layer(
        jarch, jax.tree_util.tree_map(jnp.asarray, lp), jnp.asarray(x), jcos, jsin,
        jnp.asarray(zeros), jnp.asarray(zeros), jnp.asarray(pos), JaxSpec(**spec), False)
    tk, tv = torch.zeros(zeros.shape), torch.zeros(zeros.shape)
    th, _ = tbase.decoder_layer(
        tarch, from_jax_params(lp), torch.from_numpy(x), tcos, tsin, tk, tv,
        torch.from_numpy(pos), KVCacheSpec(**spec), False,
        window=tarch.layer_window(0))
    # f32 rounding of outputs up to ~20 (the summation orders differ)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-5, atol=2e-5)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=0, atol=2e-6)


# ---------------------------------------------------------------------------
# Paths
# ---------------------------------------------------------------------------


def test_windowed_paged_engine_matches_jax():
    """A Mistral (window 8) on the paged engine: the JAX rule leaves the
    paged kernels under a window, so both packages attend plain over the
    gathered window (the same strategies); every stream equals the JAX
    engine's and HF's."""
    hf_model, cfg, sd = tiny_family("mistral")
    kw = dict(batch_size=2, is_block_kv_layout=True, pa_block_size=8, pa_num_blocks=32,
              ctx_batch_size=1, tkg_batch_size=3, is_prefix_caching=True,
              attn_block_tkg_kernel_enabled=True)
    japp = jax_family_app("mistral", cfg, sd, **kw)
    tapp = port_family_app("mistral", cfg, params=from_jax_params(jax.device_get(japp.params)),
                           **kw)
    shared = [5, 9, 3, 17, 2, 8, 11, 42, 7, 13]
    prompts = [shared + [21, 4], [7, 13, 21, 4, 33, 6, 9, 40, 2, 11], shared + [33, 6, 9]]

    def drive(eng, sp):
        reqs = [eng.add_request(p, sp(max_new_tokens=8)) for p in prompts]
        got = {o.request_id: o.token_ids for o in eng.run()}
        return [got[r.request_id] for r in reqs]

    want = drive(JaxEngine(japp, JaxSC(prefix_cache=True)), JaxSP)
    got = drive(InferenceEngine(tapp, SchedulerConfig(prefix_cache=True)), SamplingParams)
    assert got == want
    for p, toks in zip(prompts, got):
        assert toks == hf_greedy_generate(hf_model, np.array([p]), 8)[0, len(p):].tolist()
    for tag, w in tapp.models.items():
        ref = {s for p in japp.models[tag]._programs.values() for s in p.attention_strategies}
        assert {s for ss in w.attention_strategies.values() for s in ss} == ref, tag
    assert "cte_paged_kernel" not in set().union(*strategies(tapp).values())


def test_smollm3_mixed_engine_matches_jax():
    """SmolLM3's per-layer rope flags on the mixed engine (one packed
    dispatch a step): the JAX rule leaves the ragged kernel for plain
    attention on a flagged stack, in both packages; the streams equal the
    JAX engine's and HF's."""
    hf_model, cfg, sd = tiny_family("smollm3")
    kw = dict(batch_size=2, is_block_kv_layout=True, pa_block_size=8, pa_num_blocks=32,
              ctx_batch_size=1, tkg_batch_size=3, mixed_dispatch=True)
    japp = jax_family_app("smollm3", cfg, sd, **kw)
    tapp = port_family_app("smollm3", cfg, params=from_jax_params(jax.device_get(japp.params)),
                           **kw)
    prompts = [[5, 9, 3, 17, 2, 8, 11, 42, 7, 13], [7, 13, 21, 4, 33], [9, 9, 2, 40, 17, 3]]

    def drive(eng, sp):
        reqs = [eng.add_request(p, sp(max_new_tokens=6)) for p in prompts]
        got = {o.request_id: o.token_ids for o in eng.run()}
        return [got[r.request_id] for r in reqs]

    got = drive(InferenceEngine(tapp, SchedulerConfig()), SamplingParams)
    assert got == drive(JaxEngine(japp, JaxSC()), JaxSP)
    for p, toks in zip(prompts, got):
        assert toks == hf_greedy_generate(hf_model, np.array([p]), 6)[0, len(p):].tolist()
    assert strategies(tapp)["mixed_model"] == {"mixed_ragged_xla"}


def test_windowed_mixtral_matches_jax_and_hf():
    """Mixtral takes the HF config's window now: a window of 8 under a
    12-token prompt, against the JAX app (logits within 1e-5, tokens) and
    HF."""
    from transformers import MixtralConfig, MixtralForCausalLM

    torch.manual_seed(0)
    hf_cfg = MixtralConfig(hidden_size=64, intermediate_size=96, num_hidden_layers=2,
                           num_attention_heads=4, num_key_value_heads=2, vocab_size=256,
                           max_position_embeddings=256, rms_norm_eps=1e-5, rope_theta=10000.0,
                           num_local_experts=4, num_experts_per_tok=2, sliding_window=8,
                           tie_word_embeddings=False)
    hf_model = MixtralForCausalLM(hf_cfg).eval()
    sd = {k: v.detach().numpy() for k, v in hf_model.state_dict().items()}
    tc = dict(tp_degree=1, seq_len=64, max_context_length=32, batch_size=1, dtype="float32",
              skip_warmup=True, output_logits=True, **FLAGS)

    class JApp(TpuModelForCausalLM):
        def get_state_dict(self):
            return sd

    japp = JApp("<memory>", jmx.MixtralInferenceConfig(
        TpuConfig(on_device_sampling_config=JaxODSC(), **tc),
        load_config=lambda: hf_cfg.to_dict()), model_family=jmx)
    japp.load()

    class TApp(TorchModelForCausalLM):
        def build_params(self):
            return from_jax_params(jax.device_get(japp.params))

    tapp = TApp("<memory>", tmx.MixtralInferenceConfig(
        TorchConfig(on_device_sampling_config=OnDeviceSamplingConfig(), **tc),
        load_config=lambda: hf_cfg.to_dict()), model_family=tmx, device="cpu")
    tapp.load()
    assert tmx.build_arch(tapp.config).sliding_window == 8
    np.testing.assert_allclose(prefill_logits(tapp), prefill_logits(japp), atol=LOGIT_TOL, rtol=0)
    got = HuggingFaceGenerationAdapter(tapp).generate(PROMPT, max_new_tokens=NEW)
    np.testing.assert_array_equal(got, JaxAdapter(japp).generate(PROMPT, max_new_tokens=NEW))
    np.testing.assert_array_equal(got, hf_greedy_generate(hf_model, PROMPT, NEW))


def test_gemma_fused_projections_match_jax():
    """Gemma with the fused QKV weight and the QKV and MLP kernel flags: the
    tanh GELU through the fused MLP kernel's plain version against the JAX
    app's Pallas kernels (interpret mode), logits within 1e-5, tokens equal."""
    kw = dict(fused_qkv=True, qkv_kernel_enabled=True, mlp_kernel_enabled=True)
    hf_model, cfg, sd = tiny_family("gemma")
    japp = jax_family_app("gemma", cfg, sd, **kw)
    tapp = port_family_app("gemma", cfg, params=from_jax_params(jax.device_get(japp.params)),
                           **kw)
    np.testing.assert_allclose(prefill_logits(tapp), prefill_logits(japp), atol=LOGIT_TOL, rtol=0)
    got = HuggingFaceGenerationAdapter(tapp).generate(PROMPT, max_new_tokens=NEW)
    np.testing.assert_array_equal(got, JaxAdapter(japp).generate(PROMPT, max_new_tokens=NEW))
    np.testing.assert_array_equal(got, hf_greedy_generate(hf_model, PROMPT, NEW))
    for seen in strategies(tapp).values():
        assert {"qkv_fused_kernel", "mlp_fused_kernel"} <= seen


def test_published_widths():
    """MISTRAL_7B_V01, QWEN3_8B and GEMMA_2B build their published archs:
    Mistral's window 4096; Qwen3's q/k norms at head dim 128; Gemma's head
    dim 256 over one kv head (G 8), its tanh GELU, sqrt(2048) embed scale,
    tied head and (1 + w) norms; their random params have the converter's
    shapes."""
    m = tmistral.build_arch(tmistral.MistralInferenceConfig(
        TorchConfig(seq_len=16), **dict(tmistral.MISTRAL_7B_V01, num_hidden_layers=1)))
    assert (m.sliding_window, m.head_dim, m.num_attention_heads // m.num_kv_heads) == (4096, 128, 4)
    q = tqwen3.build_arch(tqwen3.Qwen3InferenceConfig(
        TorchConfig(seq_len=16), **dict(tqwen3.QWEN3_8B, num_hidden_layers=1)))
    assert q.qk_norm and (q.head_dim, q.vocab_size, q.rms_norm_eps) == (128, 151936, 1e-6)
    g = tgemma.build_arch(tgemma.GemmaInferenceConfig(
        TorchConfig(seq_len=16), **dict(tgemma.GEMMA_2B, num_hidden_layers=1)))
    assert (g.head_dim, g.num_attention_heads, g.num_kv_heads, g.hidden_act) == (
        256, 8, 1, "gelu_pytorch_tanh")
    assert g.gemma_norm and g.tie_word_embeddings and g.embed_scale == 2048 ** 0.5
    small = dict(hidden_size=64, intermediate_size=96, vocab_size=128)

    def shapes(tree):
        return {k: shapes(v) if isinstance(v, dict) else tuple(v.shape) for k, v in tree.items()}

    for fam, cfg_cls, widths in ((tqwen3, tqwen3.Qwen3InferenceConfig, tqwen3.QWEN3_8B),
                                 (tgemma, tgemma.GemmaInferenceConfig, tgemma.GEMMA_2B)):
        cfg = cfg_cls(TorchConfig(seq_len=16, dtype="float32"),
                      **dict(widths, num_hidden_layers=2, head_dim=16, **small))
        arch = fam.build_arch(cfg)
        params = tdense.random_params(arch, device="cpu")
        assert shapes(params) == tdense.param_shapes(arch)
        sd = {"model.embed_tokens.weight": params["embed_tokens"], "model.norm.weight":
              params["norm"], "lm_head.weight": params.get("lm_head", params["embed_tokens"].t()).t()}
        for i in range(2):
            lay = tbase.layer_params(params["layers"], i)
            for n in ("input_layernorm", "post_attention_layernorm"):
                sd[f"model.layers.{i}.{n}.weight"] = lay[n]
            for n, p in lay["attn"].items():
                key = f"model.layers.{i}.self_attn.{n}.weight"
                sd[key] = p if n.endswith("norm") else p["w"].t()
            for n, p in lay["mlp"].items():
                sd[f"model.layers.{i}.mlp.{n}.weight"] = p["w"].t()
        assert shapes(fam.convert_hf_state_dict(sd, cfg)) == tdense.param_shapes(arch)
    # a gemma-style norm's zero offset is a unit scale
    tiny_g = dataclasses.replace(g, num_layers=1, vocab_size=64, hidden_size=16,
                                 intermediate_size=32, head_dim=8, num_attention_heads=2)
    assert not tdense.random_params(tiny_g, device="cpu")["norm"].any()


# ---------------------------------------------------------------------------
# Refusals and the card's limits
# ---------------------------------------------------------------------------


def test_window_sized_kv_refused():
    """The ring config builds (its slot count from sliding_window) and
    refuses the paged layout, as the JAX package's does."""
    assert TorchConfig(window_sized_kv=True, sliding_window=8).window_ring_slots == 8
    with pytest.raises(ValueError, match="window_sized_kv composes with contiguous decode"):
        TorchConfig(window_sized_kv=True, sliding_window=8, is_block_kv_layout=True,
                    pa_num_blocks=8, pa_block_size=8)


@pytest.mark.parametrize("model_type,kw,switch", [
    ("qwen3", dict(lora_config=dict(max_loras=2, max_lora_rank=4)), "LoRA serving.*qk_norm"),
    ("gemma", dict(kv_cache_quant=True), "quantized KV cache.*gemma_norm"),
    ("mistral", dict(batch_size=2, is_block_kv_layout=True, pa_block_size=8, pa_num_blocks=16,
                     mixed_dispatch=True, ctx_batch_size=1, tkg_batch_size=2),
     "mixed_dispatch.*sliding_window"),
])
def test_paths_carry_a_switch(model_type, kw, switch):
    """LoRA, a quantized KV cache and the mixed step carry the switch named
    (as in the JAX package): the app builds with the path on
    (``tests/test_torch_family_paths*.py`` hold the LoRA and KV tokens to
    the JAX package's, ``tests/test_torch_family_mixed.py`` the mixed
    step's)."""
    _, cfg, sd = tiny_family(model_type)
    app = port_family_app(model_type, cfg, sd=sd, **kw)
    path = ("lora_config" if "LoRA" in switch else "mixed_dispatch" if "mixed" in switch
            else "kv_quant_config")
    assert getattr(app.tpu_config, path)
    if path == "mixed_dispatch":
        assert app.mixed_supported
    assert switch.split(".*")[1] in family_switches(app.models["token_generation_model"].arch)


def test_speculation_carries_and_moe_refuses_switches():
    """Speculation (chains and trees) carries a family switch such as
    Granite's multipliers; MoE routing refuses every switch but those it
    carries; Arcee's non-gated MLP refuses the fused MLP kernel (the JAX
    rule)."""
    _, cfg, sd = tiny_family("granite")
    arch = port_family_app("granite", cfg, sd=sd).models["token_generation_model"].arch
    assert "attention_scale" in family_switches(arch)
    for tree in (False, True):
        refuse_speculation(arch, tree=tree)
    from nxdi_tpu_torch.runtime.application import refuse_unported

    mcfg = tmx.MixtralInferenceConfig(TorchConfig(seq_len=16), **dict(
        tmx.MIXTRAL_8X7B, num_hidden_layers=1, sliding_window=64))
    refuse_unported(tmx, mcfg)  # the window alone passes

    class Scaled:
        @staticmethod
        def build_arch(c):
            return tmx.build_arch(c, residual_multiplier=0.5)

    with pytest.raises(NotImplementedError, match="mixture-of-experts.*residual_multiplier"):
        refuse_unported(Scaled, mcfg)
    _, acfg, asd = tiny_family("arcee")
    app = port_family_app("arcee", acfg, sd=asd, mlp_kernel_enabled=True)
    with pytest.raises(NotImplementedError, match="non-gated MLP"):
        prefill_logits(app)


def test_card_limits_by_kernel():
    """Head dim 256 passes every kernel's limits, the paged prefill's and
    the ragged kernel's included, over a bf16 pool and a one-byte store;
    264 does not; on the card an enabled paged flag under a window raises,
    naming it (the JAX rule, kept as a failure there)."""
    assert tbase._card_limits(256, torch.bfloat16) == []
    assert tbase._card_limits(256, torch.bfloat16, store=torch.float8_e4m3fn) == []
    assert tbase._card_limits(256, torch.float32, store=torch.int8) == []
    assert tbase._card_limits(264, torch.bfloat16)[0].startswith("head_dim 264")
    assert "up to 256" in tbase._card_limits(264, torch.bfloat16, store=torch.int8)[0]
    arch = tbase.DecoderArch(num_layers=1, hidden_size=16, num_attention_heads=2,
                             num_kv_heads=1, head_dim=8, intermediate_size=16, vocab_size=8,
                             vocab_pad=0, sliding_window=8)
    with pytest.raises(NotImplementedError, match="sliding_window 8"):
        tbase._kernel_gate("attn_block_tkg_kernel_enabled", True, True,
                           tbase._window_refused(arch), [])
    assert not tbase._kernel_gate("attn_kernel_enabled", True, False, [], [],
                                  tbase.LayerFlags(torch.tensor(True)).ref_only())
    assert tbase._kernel_gate("attn_kernel_enabled", True, True, [], [],
                              tbase.LayerFlags(torch.tensor(True)).ref_only())
