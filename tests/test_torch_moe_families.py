"""The MoE families of the port (Qwen3-MoE, gpt-oss, MiniMax-M2, DBRX,
Phi-3.5-MoE, AFMoE) and the Phi-3 family, each held against the JAX
package's family on a tiny random config: the JAX app's params carried
across with ``from_jax_params``, float32 prefill logits within 1e-5 of the
JAX app's, greedy tokens equal to the JAX app's and, where transformers has
the class, to HF's. The attention kernel flags are on in both packages
(Pallas in interpret mode; the port's kernels' plain versions on the CPU).

gpt-oss's window (8) is shorter than the 12-token prompt and its sinks are
drawn N(0, 1), so both bite; DBRX's ``clip_qkv`` (0.2) clamps; LongRoPE's
``original_max`` (16) lies between the prompt and its last generated token.
MiniMax-M2 and AFMoE have no transformers class: their checkpoints are
random HF-layout state dicts, held to the JAX app alone. Each switch also
has a test that drops it from the port's arch and sees the logits leave the
JAX app's."""

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
from nxdi_tpu.ops import norms as jnorms
from nxdi_tpu.ops import rope as jrope
from nxdi_tpu.serving import InferenceEngine as JaxEngine
from nxdi_tpu.serving import SamplingParams as JaxSP
from nxdi_tpu.serving import SchedulerConfig as JaxSC
from nxdi_tpu.utils.accuracy import hf_greedy_generate
from nxdi_tpu_torch.config import OnDeviceSamplingConfig, TorchConfig
from nxdi_tpu_torch.generation.hf_adapter import HuggingFaceGenerationAdapter
from nxdi_tpu_torch.models import base as tbase
from nxdi_tpu_torch.models import dense as tdense
from nxdi_tpu_torch.models import registry as treg
from nxdi_tpu_torch.models.convert import from_jax_params
from nxdi_tpu_torch.ops import attention as tattn
from nxdi_tpu_torch.ops import norms as tnorms
from nxdi_tpu_torch.ops import rope as trope
from nxdi_tpu_torch.runtime.application import (
    TorchModelForCausalLM,
    refuse_speculation,
    refuse_unported,
)
from nxdi_tpu_torch.serving import InferenceEngine, SamplingParams, SchedulerConfig

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

TINY = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, vocab_size=256, max_position_embeddings=256,
            rms_norm_eps=1e-5, rope_theta=10000.0, tie_word_embeddings=False)
LONGROPE = dict(type="longrope", short_factor=[1.0 + 0.05 * i for i in range(8)],
                long_factor=[2.0 + 0.25 * i for i in range(8)])
# case -> (model_type, transformers class or None, config overrides)
CASES = {
    "qwen3_moe": ("qwen3_moe", "Qwen3MoeForCausalLM", dict(
        head_dim=16, num_experts=8, num_experts_per_tok=2, moe_intermediate_size=32,
        norm_topk_prob=True, decoder_sparse_step=1, mlp_only_layers=[])),
    "phi3": ("phi3", "Phi3ForCausalLM", dict(pad_token_id=0, eos_token_id=None)),
    "phi3_longrope": ("phi3", "Phi3ForCausalLM", dict(
        max_position_embeddings=64, original_max_position_embeddings=16,
        rope_scaling=LONGROPE, pad_token_id=0, eos_token_id=None)),
    "phimoe": ("phimoe", "PhimoeForCausalLM", dict(
        num_local_experts=8, num_experts_per_tok=2, router_jitter_noise=0.01,
        input_jitter_noise=0.0, attention_bias=True, lm_head_bias=False, rope_scaling=None,
        sliding_window=None)),
    "dbrx": ("dbrx", "DbrxForCausalLM", None),
    "gpt_oss": ("gpt_oss", "GptOssForCausalLM", dict(
        intermediate_size=32, head_dim=16, num_local_experts=4, num_experts_per_tok=2,
        sliding_window=8, rope_theta=150000.0)),
    "minimax_m2": ("minimax_m2", None, dict(
        intermediate_size=32, num_attention_heads=8, num_key_value_heads=4, head_dim=16,
        rotary_dim=8, use_qk_norm=True, num_local_experts=8, num_experts_per_tok=2,
        rms_norm_eps=1e-6, hidden_act="silu")),
    "afmoe": ("afmoe", None, dict(
        head_dim=16, moe_intermediate_size=32, num_dense_layers=1, num_local_experts=8,
        num_experts_per_tok=2, num_shared_experts=1, route_norm=True, route_scale=1.5,
        sliding_window=8, global_attn_every_n_layers=2, mup_enabled=True)),
}
DBRX_CFG = dict(d_model=64, n_heads=4, n_layers=2, max_seq_len=256, vocab_size=256,
                attn_config={"kv_n_heads": 2, "rope_theta": 10000.0, "clip_qkv": 0.2},
                ffn_config={"ffn_hidden_size": 32, "moe_num_experts": 8, "moe_top_k": 2})
# the cases whose layers carry per-layer flags or sinks: plain attention (the JAX rule)
PLAIN = {"gpt_oss", "afmoe"}
LONG_PROMPT = np.array([[(7 * i + 3) % 250 + 1 for i in range(20)]], dtype=np.int64)


@pytest.fixture(autouse=True, scope="module")
def _fresh_jax_compiles():
    with fresh_jax_compiles():
        yield


def _minimax_sd(cfg, rng):
    H, D = cfg["hidden_size"], cfg["head_dim"]
    NH, NKV = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    E, I, V = cfg["num_local_experts"], cfg["intermediate_size"], cfg["vocab_size"]

    def w(*shape, scale=0.05):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    sd = {"model.embed_tokens.weight": w(V, H), "model.norm.weight": 1 + w(H, scale=0.02),
          "lm_head.weight": w(V, H)}
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}."
        sd[p + "input_layernorm.weight"] = 1 + w(H, scale=0.02)
        sd[p + "post_attention_layernorm.weight"] = 1 + w(H, scale=0.02)
        for name, rows in (("q_proj", NH * D), ("k_proj", NKV * D), ("v_proj", NKV * D)):
            sd[p + f"self_attn.{name}.weight"] = w(rows, H)
        sd[p + "self_attn.o_proj.weight"] = w(H, NH * D)
        sd[p + "self_attn.q_norm.weight"] = 1 + w(NH * D, scale=0.2)
        sd[p + "self_attn.k_norm.weight"] = 1 + w(NKV * D, scale=0.2)
        sd[p + "block_sparse_moe.gate.weight"] = w(E, H)
        sd[p + "block_sparse_moe.e_score_correction_bias"] = w(E, scale=0.5)
        for j in range(E):
            q = f"{p}block_sparse_moe.experts.{j}."
            sd[q + "w1.weight"], sd[q + "w3.weight"], sd[q + "w2.weight"] = (
                w(I, H), w(I, H), w(H, I))
    return sd


def _afmoe_sd(cfg, rng):
    H, D, HQ, KV = cfg["hidden_size"], cfg["head_dim"], cfg["num_attention_heads"], \
        cfg["num_key_value_heads"]
    E, MI, DI, V = cfg["num_local_experts"], cfg["moe_intermediate_size"], \
        cfg["intermediate_size"], cfg["vocab_size"]

    def w(*shape, scale=0.05):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    sd = {"model.embed_tokens.weight": w(V, H, scale=0.02),
          "model.norm.weight": 1 + w(H, scale=0.1), "lm_head.weight": w(V, H)}
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}."
        for n in ("input_layernorm", "post_attention_layernorm", "pre_mlp_layernorm",
                  "post_mlp_layernorm"):
            sd[p + n + ".weight"] = 1 + w(H, scale=0.1)
        sd[p + "self_attn.q_proj.weight"] = w(HQ * D, H)
        sd[p + "self_attn.k_proj.weight"] = w(KV * D, H)
        sd[p + "self_attn.v_proj.weight"] = w(KV * D, H)
        sd[p + "self_attn.o_proj.weight"] = w(H, HQ * D)
        sd[p + "self_attn.gate_proj.weight"] = w(HQ * D, H, scale=0.3)
        sd[p + "self_attn.q_norm.weight"] = 1 + w(D, scale=0.1)
        sd[p + "self_attn.k_norm.weight"] = 1 + w(D, scale=0.1)
        if i < cfg["num_dense_layers"]:
            for n, shape in (("gate_proj", (DI, H)), ("up_proj", (DI, H)), ("down_proj", (H, DI))):
                sd[p + f"mlp.{n}.weight"] = w(*shape)
            continue
        sd[p + "mlp.router.gate.weight"] = w(E, H, scale=0.3)
        sd[p + "mlp.expert_bias"] = w(E, scale=0.5)
        for j in range(E):
            for n, shape in (("gate_proj", (MI, H)), ("up_proj", (MI, H)), ("down_proj", (H, MI))):
                sd[p + f"mlp.experts.{j}.{n}.weight"] = w(*shape)
        for n, shape in (("gate_proj", (MI, H)), ("up_proj", (MI, H)), ("down_proj", (H, MI))):
            sd[p + f"mlp.shared_experts.{n}.weight"] = w(*shape)
    return sd


_CACHE = {}


def tiny_case(case):
    """(model_type, HF model or None, the config dict, the state dict as
    numpy), made once per case."""
    if case in _CACHE:
        return _CACHE[case]
    import transformers

    model_type, cls_name, over = CASES[case]
    torch.manual_seed(0)
    if cls_name is None:
        cfg = {**TINY, **over, "model_type": model_type}
        make = _minimax_sd if model_type == "minimax_m2" else _afmoe_sd
        out = (model_type, None, cfg, make(cfg, np.random.default_rng(0)))
    else:
        kw = DBRX_CFG if case == "dbrx" else {**TINY, **over}
        cfg_obj = getattr(transformers, cls_name.replace("ForCausalLM", "Config"))(**kw)
        model = getattr(transformers, cls_name)(cfg_obj).eval()
        if model_type == "gpt_oss":
            with torch.no_grad():  # sinks of the scores' scale, so they bite
                for layer in model.model.layers:
                    layer.self_attn.sinks.normal_(0.0, 1.0)
        sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
        out = (model_type, model, cfg_obj.to_dict(), sd)
    _CACHE[case] = out
    return out


def apps(case):
    """(JAX app, port app on the JAX app's params), made once per case."""
    key = ("apps", case)
    if key not in _CACHE:
        model_type, _, cfg, sd = tiny_case(case)
        japp = jax_family_app(model_type, cfg, sd)
        tapp = port_family_app(model_type, cfg,
                               params=from_jax_params(jax.device_get(japp.params)))
        _CACHE[key] = (japp, tapp)
    return _CACHE[key]


# ---------------------------------------------------------------------------
# Ops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("biased", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_matches_jax(biased, dtype):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((3, 5, 48)) * 3 + 1).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(48)).astype(np.float32)
    b = (0.1 * rng.standard_normal(48)).astype(np.float32) if biased else None
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = jnorms.layer_norm(jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt),
                             None if b is None else jnp.asarray(b).astype(jdt), eps=1e-5)
    got = tnorms.layer_norm(torch.from_numpy(x).to(dtype), torch.from_numpy(w).to(dtype),
                            None if b is None else torch.from_numpy(b).to(dtype), eps=1e-5)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=tol, rtol=0)


@pytest.mark.parametrize("two_part", [False, True])
def test_sink_attention_matches_jax(two_part):
    """The sink column in the plain grouped and two-part attention, against
    the JAX functions (G 2, a window of 4 on); a zero-mass sink (-inf-like)
    gives the sink-free result, a large one shrinks every output."""
    rng = np.random.default_rng(3)
    B, H, KV, S, W, D = 2, 4, 2, 3, 9, 8
    q = rng.standard_normal((B, H, S, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, KV, W, D)).astype(np.float32) for _ in range(2))
    k2, v2 = (rng.standard_normal((B, KV, S, D)).astype(np.float32) for _ in range(2))
    sink = rng.standard_normal(H).astype(np.float32)
    qpos = np.tile(np.arange(W, W + S, dtype=np.int32), (B, 1))
    kvpos = np.tile(np.arange(W, dtype=np.int32), (B, 1))
    t = {n: torch.from_numpy(a) for n, a in dict(q=q, k=k, v=v, k2=k2, v2=v2, qpos=qpos,
                                                  kvpos=kvpos).items()}
    j = {n: jnp.asarray(a) for n, a in dict(q=q, k=k, v=v, k2=k2, v2=v2, qpos=qpos,
                                             kvpos=kvpos).items()}

    def run(mod, a, s):
        if two_part:
            return mod.attention_two_part(a["q"], a["k"], a["v"], a["k2"], a["v2"], a["qpos"],
                                          a["kvpos"], a["qpos"], sliding_window=4, sink=s)
        return mod.attention_with_positions(a["q"], a["k"], a["v"], a["qpos"][:, :1] * 0 + W,
                                            a["kvpos"], sliding_window=4, sink=s)

    got = run(tattn, t, torch.from_numpy(sink)).numpy()
    np.testing.assert_allclose(got, np.asarray(run(jattn, j, jnp.asarray(sink))), atol=2e-6,
                               rtol=0)
    plain = run(tattn, t, None).numpy()
    assert np.abs(got - plain).max() > 1e-2  # the sink takes mass
    np.testing.assert_allclose(run(tattn, t, torch.full((H,), -1e4)).numpy(), plain, atol=1e-6)


def test_longrope_tables_match_jax():
    for orig, mx in ((16, 64), (4096, 131072), (64, 64)):
        jt, jf = jrope.longrope_inv_freq(16, 10000.0, LONGROPE, mx, orig)
        tt, tf = trope.longrope_inv_freq(16, 10000.0, LONGROPE, mx, orig)
        np.testing.assert_array_equal(tt, jt)
        assert tf == jf
    with pytest.raises(ValueError, match="longrope.*phi3"):
        trope.inv_freq_from_hf_config(16, 10000.0, LONGROPE)


# ---------------------------------------------------------------------------
# Families against the JAX package and HF
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(CASES))
def test_family_matches_jax_and_hf(case):
    """Prefill logits within 1e-5 of the JAX app's, greedy tokens equal to
    its (and HF's where transformers has the class); the kernels' plain
    versions ran where the JAX rule runs its kernels (sinks and per-layer
    flags: plain attention)."""
    _, hf_model, _, _ = tiny_case(case)
    japp, tapp = apps(case)
    np.testing.assert_allclose(prefill_logits(tapp), prefill_logits(japp), atol=LOGIT_TOL,
                               rtol=0)
    want = HuggingFaceGenerationAdapter(tapp).generate(PROMPT, max_new_tokens=NEW)
    np.testing.assert_array_equal(want, JaxAdapter(japp).generate(PROMPT, max_new_tokens=NEW))
    if hf_model is not None:
        np.testing.assert_array_equal(want, hf_greedy_generate(hf_model, PROMPT, NEW))
    seen = strategies(tapp)
    plain = case in PLAIN
    assert {s for s in seen["context_encoding_model"] if not s.startswith("moe")} == {
        "cte_xla" if plain else "cte_flash_kernel"}
    assert {s for s in seen["token_generation_model"] if not s.startswith("moe")} == {
        "tkg_two_part_xla" if plain else "tkg_fused_kernel_stacked"}


def test_longrope_both_sides_of_original_max():
    """LongRoPE's regime: a 12-token prefill takes the short set and a
    20-token one (past original_max 16) the long set, each within 1e-5 of the
    JAX app's, and each set matters (the other set's logits are far off);
    generate() crosses the boundary mid-rollout (test_family_matches_jax_and_hf)."""
    japp, tapp = apps("phi3_longrope")
    assert tapp.models["context_encoding_model"].arch.longrope_original_max == 16
    short_only = _switched("phi3_longrope", dict(longrope_original_max=None),
                           inv=lambda f, c: f.build_inv_freq(c)[0])
    long_only = _switched("phi3_longrope", dict(longrope_original_max=None),
                          inv=lambda f, c: f.build_inv_freq(c)[1])
    for prompt, same, other in ((PROMPT, short_only, long_only),
                                (LONG_PROMPT, long_only, short_only)):
        got = prefill_logits(tapp, prompt)
        np.testing.assert_allclose(got, prefill_logits(japp, prompt), atol=LOGIT_TOL, rtol=0)
        np.testing.assert_allclose(prefill_logits(same, prompt), got, atol=1e-6, rtol=0)
        assert np.abs(prefill_logits(other, prompt) - got).max() > 1e-3


def test_phimoe_longrope_matches_hf():
    """Phi-3.5-MoE under LongRoPE with its cos / sin scale (HF
    ``short_mscale`` / ``long_mscale``): the JAX package applies none
    (ROADMAP Queue 3), so the port is held to HF: tokens across
    original_max, prefill logits on both sides."""
    import transformers

    over = dict(CASES["phimoe"][2], max_position_embeddings=64,
                original_max_position_embeddings=16,
                rope_scaling=dict(LONGROPE, short_mscale=1.2, long_mscale=1.2,
                                  original_max_position_embeddings=16))
    torch.manual_seed(0)
    cfg_obj = transformers.PhimoeConfig(**{**TINY, **over})
    model = transformers.PhimoeForCausalLM(cfg_obj).eval()
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    tapp = port_family_app("phimoe", cfg_obj.to_dict(), sd=sd)
    arch = tapp.models["context_encoding_model"].arch
    assert (arch.longrope_original_max, arch.rope_mscale) == (16, 1.2)
    got = HuggingFaceGenerationAdapter(tapp).generate(PROMPT, max_new_tokens=NEW)
    np.testing.assert_array_equal(got, hf_greedy_generate(model, PROMPT, NEW))
    for prompt in (PROMPT, LONG_PROMPT):
        with torch.no_grad():
            want = model(torch.from_numpy(prompt)).logits[:, -1].numpy()
        np.testing.assert_allclose(prefill_logits(tapp, prompt)[:, -1], want, atol=1e-4, rtol=0)


def _switched(case, arch_over, inv=None):
    """The port app of ``case`` on the JAX app's params with ``arch_over``
    set in its arch (and its frequency table from ``inv(family, config)``)."""
    model_type, _, cfg, _ = tiny_case(case)
    japp, _ = apps(case)
    family, cfg_cls = treg.get_family(model_type)
    shim = types.SimpleNamespace(
        build_arch=lambda c, **kw: family.build_arch(c, **{**arch_over, **kw}),
        build_inv_freq=(lambda c: inv(family, c)) if inv else family.build_inv_freq,
        segmented=getattr(family, "segmented", None))
    params = from_jax_params(jax.device_get(japp.params))

    class App(TorchModelForCausalLM):
        def build_params(self):
            return params

    config = cfg_cls(TorchConfig(on_device_sampling_config=OnDeviceSamplingConfig(), **_tc()),
                     load_config=lambda: dict(cfg))
    app = App("<memory>", config, model_family=shim, device="cpu")
    app.load()
    return app


# (case, the arch fields that drop the switch, a table builder for the dropped arch, prompt)
SWITCHES = {
    "attention_sink": ("gpt_oss", dict(attention_sink=False), None),
    "layernorm": ("dbrx", dict(layernorm=False), None),
    "clip_qkv": ("dbrx", dict(clip_qkv=None), None),
    "rotary_dim": ("minimax_m2", dict(rotary_dim=None),
                   lambda f, c: trope.default_inv_freq(c.head_dim, c.rope_theta)),
    "attn_out_gate": ("afmoe", dict(attn_out_gate=False), None),
    "sandwich_norm": ("afmoe", dict(sandwich_norm=False), None),
}


@pytest.mark.parametrize("switch", sorted(SWITCHES))
def test_dropped_switch_leaves_jax(switch):
    """Each MoE family's switch bites: the port with it dropped from its arch
    is far from the JAX app's logits (the parity above holds only with it)."""
    case, over, inv = SWITCHES[switch]
    japp, _ = apps(case)
    dropped = _switched(case, over, inv=inv)
    assert np.abs(prefill_logits(dropped) - prefill_logits(japp)).max() > 1e-3


def test_gpt_oss_paged_engine_matches_jax():
    """gpt-oss (sinks, alternating window 8) on the paged engine with every
    attention kernel flag on: the JAX rule leaves every kernel under sinks,
    so both packages attend plain with the sink column over the gathered
    window (the same strategies); the streams equal the JAX engine's and
    HF's."""
    _, hf_model, cfg, sd = tiny_case("gpt_oss")
    kw = dict(batch_size=2, is_block_kv_layout=True, pa_block_size=8, pa_num_blocks=32,
              ctx_batch_size=1, tkg_batch_size=3, is_prefix_caching=True,
              attn_block_tkg_kernel_enabled=True)
    japp = jax_family_app("gpt_oss", cfg, sd, **kw)
    tapp = port_family_app("gpt_oss", cfg, params=from_jax_params(jax.device_get(japp.params)),
                           **kw)
    shared = [5, 9, 3, 17, 2, 8, 11, 42, 7, 13]
    prompts = [shared + [21, 4], [7, 13, 21, 4, 33, 6, 9, 40, 2, 11], shared + [33, 6, 9]]

    def drive(eng, sp):
        reqs = [eng.add_request(p, sp(max_new_tokens=8)) for p in prompts]
        got = {o.request_id: o.token_ids for o in eng.run()}
        return [got[r.request_id] for r in reqs]

    got = drive(InferenceEngine(tapp, SchedulerConfig(prefix_cache=True)), SamplingParams)
    assert got == drive(JaxEngine(japp, JaxSC(prefix_cache=True)), JaxSP)
    for p, toks in zip(prompts, got):
        assert toks == hf_greedy_generate(hf_model, np.array([p]), 8)[0, len(p):].tolist()
    for tag, w in tapp.models.items():
        ref = {s for p in japp.models[tag]._programs.values() for s in p.attention_strategies}
        got_s = {s for ss in w.attention_strategies.values() for s in ss if not s.startswith("moe")}
        assert got_s == ref, tag
    assert not {"cte_paged_kernel", "tkg_paged_kernel"} & set().union(*strategies(tapp).values())


def _leaves(tree, path=()):
    if isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


@pytest.mark.parametrize("case", ["dbrx", "afmoe", "gpt_oss", "minimax_m2", "phimoe", "phi3"])
def test_converter_matches_jax(case):
    """The port's converter of the HF checkpoint gives the JAX converter's
    params leaf for leaf (keys, shapes, dtypes, values): DBRX's fused Wqkv
    and packed experts, AFMoE's [dense head, MoE tail] segments with their
    flags, gpt-oss's sinks and biased experts, MiniMax-M2's flat norms and
    correction bias, Phi-3.5-MoE's biased norms, Phi-3's fused projections."""
    model_type, _, cfg, sd = tiny_case(case)
    jfam, jcfg_cls = jreg.get_family(model_type)
    tfam, tcfg_cls = treg.get_family(model_type)
    jparams = jfam.convert_hf_state_dict(
        sd, jcfg_cls(TpuConfig(**_tc()), load_config=lambda: dict(cfg)))
    tparams = tfam.convert_hf_state_dict(
        {k: torch.from_numpy(v) for k, v in sd.items()},
        tcfg_cls(TorchConfig(**_tc()), load_config=lambda: dict(cfg)))
    want = dict(_leaves(from_jax_params(jparams)))
    got = dict(_leaves(tparams))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=str(k))
    if case == "afmoe":
        assert isinstance(tparams["layers"], list) and len(tparams["layers"]) == 2
        assert "mlp" in tparams["layers"][0] and "moe" in tparams["layers"][1]


@pytest.mark.parametrize("case", ["afmoe", "gpt_oss", "phimoe", "minimax_m2"])
def test_random_params_match_converter_shapes(case):
    """A family's random weights have its converter's keys, shapes and
    dtypes (biased norms, sinks, the out-gate, sandwich norms, flags,
    the float32 correction bias)."""
    model_type, _, cfg, sd = tiny_case(case)
    tfam, tcfg_cls = treg.get_family(model_type)
    config = tcfg_cls(TorchConfig(**_tc()), load_config=lambda: dict(cfg))
    conv = dict(_leaves(tfam.convert_hf_state_dict(
        {k: torch.from_numpy(v) for k, v in sd.items()}, config)))
    rand = getattr(tfam, "random_params", None)
    params = rand(config, device="cpu") if rand else tdense.random_params(
        tfam.build_arch(config), device="cpu")
    got = dict(_leaves(params))
    assert got.keys() == conv.keys()
    for k in conv:
        assert (got[k].shape, got[k].dtype) == (conv[k].shape, conv[k].dtype), k


# ---------------------------------------------------------------------------
# Refusals and the card's gates
# ---------------------------------------------------------------------------


def test_moe_row_carries_the_families_switches():
    """The MoE row of refuse_unported lets each family through; mixed
    dispatch and chain speculation carry gpt-oss's sinks and window
    (``test_torch_family_mixed.py``, ``test_torch_family_spec*.py``), a
    token tree on its windowed stack is refused; LoRA carries them (AFMoE's gate and sandwich norms on an
    all-MoE stack) and still refuses AFMoE's segmented stack (a dense layer
    before the MoE ones: the JAX package attaches no adapter there); on the
    card an enabled attention flag on a sink model raises, naming the
    sinks."""
    for case in CASES:
        model_type, _, cfg, _ = tiny_case(case)
        fam, cfg_cls = treg.get_family(model_type)
        refuse_unported(fam, cfg_cls(TorchConfig(**_tc()), load_config=lambda: dict(cfg)))
    fam, cfg_cls = treg.get_family("gpt_oss")
    cfg = tiny_case("gpt_oss")[2]
    refuse_unported(fam, cfg_cls(TorchConfig(**_tc(mixed_dispatch=True,
                                                   is_block_kv_layout=True)),
                                 load_config=lambda: dict(cfg)))
    arch = fam.build_arch(cfg_cls(TorchConfig(**_tc()), load_config=lambda: dict(cfg)))
    refuse_speculation(arch, tree=False)
    with pytest.raises(NotImplementedError, match="token-tree speculation.*sliding_window"):
        refuse_speculation(arch, tree=True)
    afam, acfg_cls = treg.get_family("afmoe")
    acfg = tiny_case("afmoe")[2]
    lora_tc = TorchConfig(**_tc(lora_config=dict(max_loras=2, max_lora_rank=4,
                                                 target_modules=["q_proj"])))
    with pytest.raises(NotImplementedError, match="LoRA serving on a segmented layer stack"):
        refuse_unported(afam, acfg_cls(lora_tc, load_config=lambda: dict(acfg)))
    refuse_unported(afam, acfg_cls(lora_tc, load_config=lambda: dict(acfg, num_dense_layers=0)))
    with pytest.raises(NotImplementedError, match="attention sinks"):
        tbase._kernel_gate("attn_kernel_enabled", True, True, tbase._sink_refused(arch), [])
    assert not tbase._kernel_gate("attn_kernel_enabled", True, False,
                                  tbase._sink_refused(arch), [])


def test_published_widths():
    """The published configurations build their archs: Qwen3-30B-A3B at G 8
    (32 over 4 heads of 128), gpt-oss-20b's 64 over 8 heads of 64 with sinks,
    window 128 on every other layer and yarn's factor, MiniMax-M2 at G 6
    with partial rotary 64 of 128 and the flat norms, DBRX at G 6 with
    LayerNorm and the clamp, Phi-3.5-MoE's biased norms; their shape trees
    hold the expert stacks the card's runs allocate."""
    from nxdi_tpu_torch.models.dbrx import modeling_dbrx as tdbrx
    from nxdi_tpu_torch.models.gpt_oss import modeling_gpt_oss as tgo
    from nxdi_tpu_torch.models.minimax_m2 import modeling_minimax_m2 as tmm
    from nxdi_tpu_torch.models.phimoe import modeling_phimoe as tpm
    from nxdi_tpu_torch.models.qwen3_moe import modeling_qwen3_moe as tqm

    def arch_of(mod, cls, widths, **kw):
        return mod.build_arch(cls(TorchConfig(seq_len=16), **dict(widths, **kw)))

    q = arch_of(tqm, tqm.Qwen3MoeInferenceConfig, tqm.QWEN3_30B_A3B, num_hidden_layers=8)
    assert (q.num_attention_heads // q.num_kv_heads, q.head_dim, q.qk_norm) == (8, 128, True)
    assert (q.moe.num_experts, q.moe.top_k, q.moe.intermediate_size) == (128, 8, 768)
    g = arch_of(tgo, tgo.GptOssInferenceConfig, tgo.GPT_OSS_20B, num_hidden_layers=8)
    assert (g.num_attention_heads, g.num_kv_heads, g.head_dim) == (64, 8, 64)
    assert g.attention_sink and g.attention_o_bias and g.sliding_window == 128
    assert g.kv_window_pattern == (True, False) * 4
    assert abs(g.rope_mscale - (0.1 * np.log(32.0) + 1)) < 1e-9
    m = arch_of(tmm, tmm.MiniMaxM2InferenceConfig, tmm.MINIMAX_M2, num_hidden_layers=4)
    assert (m.num_attention_heads // m.num_kv_heads, m.rotary_dim, m.qk_norm_flat) == (6, 64, True)
    assert tmm.build_inv_freq(tmm.MiniMaxM2InferenceConfig(
        TorchConfig(seq_len=16), **tmm.MINIMAX_M2)).shape == (32,)
    d = arch_of(tdbrx, tdbrx.DbrxInferenceConfig, tdbrx.DBRX, n_layers=2)
    assert (d.num_attention_heads // d.num_kv_heads, d.head_dim, d.layernorm, d.clip_qkv) == (
        6, 128, True, 8)
    p = arch_of(tpm, tpm.PhimoeInferenceConfig, tpm.PHI_3_5_MOE, num_hidden_layers=2)
    assert p.layernorm and p.attention_bias and p.attention_o_bias and p.moe.sparsemixer
    shapes = tdense.param_shapes(m)
    assert shapes["layers"]["moe"]["router"]["e_bias"] == (4, 256)
    assert shapes["layers"]["attn"]["q_norm"] == (4, 48 * 128)
    assert tdense.param_shapes(g)["layers"]["attn"]["sink"] == (8, 64)
    assert tdense.param_shapes(p, norm_bias=True)["norm"] == {"w": (4096,), "b": (4096,)}
