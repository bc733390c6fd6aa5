"""The port's mixture-of-experts (``nxdi_tpu_torch/ops/moe.py``, the Mixtral
family) held against the JAX package's ``nxdi_tpu/ops/moe.py`` and Mixtral
app and against HF ``MixtralForCausalLM``, on the CPU in float32.

Tolerances: router weights within 1e-6 (float32 softmax / sigmoid, a few
ulp of a value below 1, times ``routed_scaling`` up to 16); ``moe_block``
within 1e-5 of the JAX package's and sparse within 1e-5 of dense (float32
sums of 32-64 products of unit-scale terms); the tiny Mixtral's prefill
logits within 1e-5 of the JAX app's; expert ids and greedy tokens exactly
equal."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nxdi_tpu.config import OnDeviceSamplingConfig as JaxODSC
from nxdi_tpu.config import TpuConfig
from nxdi_tpu.generation.hf_adapter import HuggingFaceGenerationAdapter as JaxAdapter
from nxdi_tpu.models.mixtral import modeling_mixtral as jmx
from nxdi_tpu.ops import moe as jmoe
from nxdi_tpu.ops import quantization as jquant
from nxdi_tpu.runtime.application import TpuModelForCausalLM
from nxdi_tpu.utils.accuracy import hf_greedy_generate
from nxdi_tpu_torch.config import OnDeviceSamplingConfig, TorchConfig
from nxdi_tpu_torch.generation.hf_adapter import HuggingFaceGenerationAdapter
from nxdi_tpu_torch.models import base as tbase
from nxdi_tpu_torch.models import dense as tdense
from nxdi_tpu_torch.models.mixtral import modeling_mixtral as tmx
from nxdi_tpu_torch.ops import moe as tmoe
from nxdi_tpu_torch.ops import quantization as tquant
from nxdi_tpu_torch.runtime.application import TorchModelForCausalLM
from nxdi_tpu_torch.serving import InferenceEngine, SamplingParams, SchedulerConfig
from test_torch_slice import fresh_jax_compiles

ROUTER_TOL = 1e-6
BLOCK_TOL = 1e-5
LOGIT_TOL = 1e-5

BASE = dict(num_experts=8, top_k=2, intermediate_size=32)
# the JAX package's router variants (tests/unit/test_moe_sparse.py) and phimoe's
ROUTERS = {
    "softmax": dict(),
    "no-renorm": dict(norm_topk_prob=False),
    "gptoss": dict(topk_softmax=True, expert_bias=True, gptoss_glu=True, glu_limit=7.0,
                   router_bias=True),
    "llama4": dict(llama4_router=True),
    "deepseek-v3": dict(sigmoid_routing=True, n_group=4, topk_group=2, routed_scaling=2.5,
                        correction_bias=True, norm_topk_prob=True),
    "deepseek-v2": dict(sigmoid_routing=False, n_group=4, topk_group=2, routed_scaling=16.0,
                        norm_topk_prob=False),
    "sparsemixer": dict(sparsemixer=True),
}


@pytest.fixture(autouse=True, scope="module")
def _fresh_jax_compiles():
    with fresh_jax_compiles():
        yield


def _params(rng, H, E=8, I=32, expert_bias=False, correction_bias=False, router_bias=False,
            shared=None):
    def r(*shape):
        return (rng.standard_normal(shape) * 0.1).astype(np.float32)

    p = {
        "router": {"w": r(H, E)},
        "experts": {"gate_proj": {"w": r(E, H, I)}, "up_proj": {"w": r(E, H, I)},
                    "down_proj": {"w": r(E, I, H)}},
    }
    if expert_bias:
        for k, shape in (("gate_proj", (E, I)), ("up_proj", (E, I)), ("down_proj", (E, H))):
            p["experts"][k]["b"] = r(*shape)
    if correction_bias:
        p["router"]["e_bias"] = r(E)
    if router_bias:
        p["router"]["b"] = r(E)
    if shared:
        p["shared_expert"] = {"gate_proj": {"w": r(H, shared)}, "up_proj": {"w": r(H, shared)},
                              "down_proj": {"w": r(shared, H)}}
        p["shared_expert_gate"] = {"w": r(H, 1)}
    return p


def _to_torch(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.mark.parametrize("name", list(ROUTERS))
def test_route_topk_matches_jax(name):
    variant = ROUTERS[name]
    rng = np.random.default_rng(3)
    T, E = 33, 8
    logits = rng.standard_normal((T, E)).astype(np.float32)
    p_router = {"e_bias": (rng.standard_normal(E) * 0.3).astype(np.float32)}
    jv, ji = jmoe.route_topk(jnp.asarray(logits), jmoe.MoEArch(**BASE, **variant),
                             _to_jax(p_router))
    tv, ti = tmoe.route_topk(torch.from_numpy(logits), tmoe.MoEArch(**BASE, **variant),
                             _to_torch(p_router))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ROUTER_TOL, rtol=0)


def test_route_topk_ties_follow_jax_order():
    """Equal router scores: the lower expert id wins, as jax.lax.top_k
    orders them."""
    logits = np.zeros((3, 8), np.float32)
    logits[1, [2, 5, 6]] = 1.0
    moe = dict(**BASE)
    _, ji = jmoe.route_topk(jnp.asarray(logits), jmoe.MoEArch(**moe))
    _, ti = tmoe.route_topk(torch.from_numpy(logits), tmoe.MoEArch(**moe))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert ti[0].tolist() == [0, 1] and ti[1].tolist() == [2, 5]


@pytest.mark.parametrize("name", list(ROUTERS))
def test_sparse_matches_dense_per_router(name):
    variant = ROUTERS[name]
    rng = np.random.default_rng(0)
    H = 16
    p = _to_torch(_params(rng, H, expert_bias=variant.get("expert_bias", False),
                          correction_bias=variant.get("correction_bias", False),
                          router_bias=variant.get("router_bias", False)))
    x = torch.from_numpy(rng.standard_normal((2, 5, H)).astype(np.float32))
    out_s = tmoe.moe_block(None, tmoe.MoEArch(**BASE, dispatch="sparse", **variant), p, x)
    out_d = tmoe.moe_block(None, tmoe.MoEArch(**BASE, dispatch="dense", **variant), p, x)
    torch.testing.assert_close(out_s, out_d, atol=BLOCK_TOL, rtol=0)


BLOCK_CASES = {
    "plain": dict(),
    "shared-gated": dict(shared_expert_intermediate_size=24, shared_expert_gated=True),
    "int8-experts": dict(),
}


@pytest.mark.parametrize("dispatch", ["sparse", "dense"])
@pytest.mark.parametrize("case", list(BLOCK_CASES))
def test_moe_block_matches_jax(case, dispatch):
    extra = BLOCK_CASES[case]
    rng = np.random.default_rng(1)
    H = 32
    p = _params(rng, H, shared=extra.get("shared_expert_intermediate_size"))
    if case == "int8-experts":
        # each package quantizes the experts with its own quantizer (the same
        # numpy bits) and dequantizes them in the block (materialize_weight)
        jp = jquant.quantize_params(p, quant_dtype="int8")
        tp = tquant.quantize_params(_to_torch(p), quant_dtype="int8")
        assert "qw" in tp["experts"]["gate_proj"] and "w" in tp["router"]
        np.testing.assert_array_equal(tp["experts"]["down_proj"]["qw"].numpy(),
                                      np.asarray(jp["experts"]["down_proj"]["qw"]))
    else:
        jp, tp = p, _to_torch(p)
    x = rng.standard_normal((3, 7, H)).astype(np.float32)
    jout = jmoe.moe_block(None, jmoe.MoEArch(**BASE, dispatch=dispatch, **extra), _to_jax(jp),
                          jnp.asarray(x))
    tout = tmoe.moe_block(None, tmoe.MoEArch(**BASE, dispatch=dispatch, **extra), tp,
                          torch.from_numpy(x))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=BLOCK_TOL, rtol=0)


def test_grouped_mm_offsets_match_per_expert(monkeypatch):
    """The card's grouped product (``torch._grouped_mm`` over the sorted rows
    and the scatter-add offsets), run here by forcing the choice, equals the
    per-expert product; with 16 experts some get no rows."""
    rng = np.random.default_rng(2)
    H, E, K = 32, 16, 4
    p = _to_torch(_params(rng, H, E=E, I=24))
    x = torch.from_numpy(rng.standard_normal((1, 9, H)).astype(np.float32))
    moe = tmoe.MoEArch(num_experts=E, top_k=K, intermediate_size=24)
    want = tmoe.moe_block(None, moe, p, x)
    _, idx = tmoe.route_topk(x[0] @ p["router"]["w"], moe)
    assert len(set(idx.flatten().tolist())) < E  # an empty group
    monkeypatch.setattr(tmoe, "grouped_product", lambda *a: tmoe.GROUPED_MM)
    got = tmoe.moe_block(None, moe, p, x)
    torch.testing.assert_close(got, want, atol=BLOCK_TOL, rtol=0)


def test_grouped_product_choice():
    """The choice reads only the device, dtype and widths: the per-expert
    product on the CPU, in float32 and at widths the grouped GEMM's 16-byte
    rows do not take."""
    x = torch.zeros(4, 64, dtype=torch.bfloat16)
    assert tmoe.grouped_product(x, 64, 128) == tmoe.PER_EXPERT  # a CPU tensor
    assert tmoe.moe_strategy(tmoe.MoEArch(**BASE, dispatch="dense"), x) == "moe_dense"
    assert tmoe.moe_strategy(tmoe.MoEArch(**BASE), x) == "moe_sparse_per_expert"


# ---------------------------------------------------------------------------
# the tiny Mixtral: HF, the JAX package's app and the port's
# ---------------------------------------------------------------------------

PROMPT = np.array([[5, 9, 3, 17, 2, 8, 11, 42]], dtype=np.int64)
NEW = 12


def make_tiny_hf_mixtral(seed=0, layers=2):
    from transformers import MixtralConfig, MixtralForCausalLM

    torch.manual_seed(seed)
    cfg = MixtralConfig(hidden_size=64, intermediate_size=96, num_hidden_layers=layers,
                        num_attention_heads=4, num_key_value_heads=2, vocab_size=256,
                        max_position_embeddings=256, rms_norm_eps=1e-5, rope_theta=10000.0,
                        num_local_experts=4, num_experts_per_tok=2, sliding_window=None,
                        tie_word_embeddings=False)
    return MixtralForCausalLM(cfg).eval(), cfg


@pytest.fixture(scope="module")
def tiny_mixtral():
    model, cfg = make_tiny_hf_mixtral()
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    return model, cfg, sd


def _common(**kw):
    d = dict(tp_degree=1, seq_len=64, max_context_length=32, batch_size=1, dtype="float32",
             attn_kernel_enabled=True, attn_tkg_kernel_enabled=True, skip_warmup=True,
             output_logits=True)
    d.update(kw)
    return d


def port_mixtral(hf_cfg, sd, **kw):
    cfg = tmx.MixtralInferenceConfig(
        TorchConfig(on_device_sampling_config=OnDeviceSamplingConfig(), **_common(**kw)),
        load_config=lambda: hf_cfg.to_dict())

    class App(TorchModelForCausalLM):
        def get_state_dict(self):
            return {k: torch.from_numpy(v) for k, v in sd.items()}

    app = App("<memory>", cfg, model_family=tmx, device="cpu")
    app.load()
    return app


@pytest.fixture(scope="module")
def jax_mixtral(tiny_mixtral):
    _, hf_cfg, sd = tiny_mixtral
    cfg = jmx.MixtralInferenceConfig(
        TpuConfig(on_device_sampling_config=JaxODSC(), **_common()),
        load_config=lambda: hf_cfg.to_dict())

    class App(TpuModelForCausalLM):
        def get_state_dict(self):
            return sd

    app = App("<memory>", cfg, model_family=jmx)
    app.load()
    return app


def _prefill_logits(app):
    out = app.forward(PROMPT.astype(np.int32), np.arange(PROMPT.shape[1], dtype=np.int32)[None],
                      last_token_index=np.array([PROMPT.shape[1] - 1], np.int32))
    logits = out["logits"]
    return logits.numpy() if isinstance(logits, torch.Tensor) else np.asarray(logits)


@pytest.mark.parametrize("dispatch", ["sparse", "dense"])
def test_tiny_mixtral_generate_matches_jax_and_hf(tiny_mixtral, jax_mixtral, dispatch):
    hf_model, hf_cfg, sd = tiny_mixtral
    app = port_mixtral(hf_cfg, sd, moe_dispatch=dispatch)
    np.testing.assert_allclose(_prefill_logits(app), _prefill_logits(jax_mixtral),
                               atol=LOGIT_TOL, rtol=0)
    expected = hf_greedy_generate(hf_model, PROMPT, max_new_tokens=NEW)
    np.testing.assert_array_equal(JaxAdapter(jax_mixtral).generate(PROMPT, max_new_tokens=NEW),
                                  expected)
    np.testing.assert_array_equal(
        HuggingFaceGenerationAdapter(app).generate(PROMPT, max_new_tokens=NEW), expected)
    moe = "moe_dense" if dispatch == "dense" else "moe_sparse_per_expert"
    for tag, want in (("context_encoding_model", {"cte_flash_kernel", moe}),
                      ("token_generation_model", {"tkg_fused_kernel_stacked", moe})):
        seen = {s for ss in app.models[tag].attention_strategies.values() for s in ss}
        assert seen == want, (tag, seen)


def test_tiny_mixtral_params_and_stacked_weights(tiny_mixtral):
    """The converted params carry ``moe`` and no dense ``mlp``, with
    dense.param_shapes' shapes; stacked_proj_weights takes a model without a
    dense MLP (no stacked MLP weights); mlp_kernel_enabled, which has no
    dense MLP to run on such a model, raises naming itself."""
    _, hf_cfg, sd = tiny_mixtral
    cfg = tmx.MixtralInferenceConfig(TorchConfig(**_common(mlp_kernel_enabled=True)),
                                     load_config=lambda: hf_cfg.to_dict())
    with pytest.raises(NotImplementedError, match="mlp_kernel_enabled: this model has no dense"):
        tmx.build_arch(cfg)
    cfg = tmx.MixtralInferenceConfig(TorchConfig(**_common()),
                                     load_config=lambda: hf_cfg.to_dict())
    arch = tmx.build_arch(cfg)
    params = tmx.convert_hf_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, cfg)
    assert "mlp" not in params["layers"] and "moe" in params["layers"]

    def shapes(tree):
        return {k: shapes(v) if isinstance(v, dict) else tuple(v.shape) for k, v in tree.items()}

    assert shapes(params) == tdense.param_shapes(arch)
    assert shapes(tdense.random_params(arch, device="cpu")) == tdense.param_shapes(arch)
    assert params["layers"]["moe"]["experts"]["gate_proj"]["w"].shape == (2, 4, 64, 96)
    mlp_st, qkv_st = tbase.stacked_proj_weights(arch, params["layers"])
    assert mlp_st is None and qkv_st is None
    # expert 3's up projection of layer 1 is HF's w3, transposed
    np.testing.assert_array_equal(
        params["layers"]["moe"]["experts"]["up_proj"]["w"][1, 3].numpy(),
        sd["model.layers.1.block_sparse_moe.experts.3.w3.weight"].T)


def test_tiny_mixtral_paged_engine_matches_hf(tiny_mixtral):
    """The paged engine (block 8, chunked prefill, a shared prefix) serves
    three requests in sparse dispatch; every stream equals HF greedy."""
    hf_model, hf_cfg, sd = tiny_mixtral
    app = port_mixtral(hf_cfg, sd, batch_size=2, is_block_kv_layout=True, pa_block_size=8,
                       pa_num_blocks=32, ctx_batch_size=1, tkg_batch_size=3,
                       is_prefix_caching=True, attn_block_tkg_kernel_enabled=True)
    eng = InferenceEngine(app, SchedulerConfig(prefix_cache=True))
    shared = [5, 9, 3, 17, 2, 8, 11, 42, 7, 13]
    prompts = [shared + [21, 4], [7, 13, 21, 4, 33], shared + [33, 6, 9]]
    reqs = [eng.add_request(p, SamplingParams(max_new_tokens=8)) for p in prompts]
    got = {o.request_id: o.token_ids for o in eng.run()}
    for r, p in zip(reqs, prompts):
        want = hf_greedy_generate(hf_model, np.array([p]), 8)[0, len(p):].tolist()
        assert got[r.request_id] == want
    seen = {s for w in app.models.values() for ss in w.attention_strategies.values() for s in ss}
    assert {"tkg_paged_kernel", "moe_sparse_per_expert"} <= seen


def test_mixtral_8x7b_widths():
    """MIXTRAL_8X7B builds the published widths: 8 experts top-2, expert
    intermediate 14336, head dim 128 with 4 query heads per kv head; a
    sliding window in the config reaches the arch."""
    cfg = tmx.MixtralInferenceConfig(TorchConfig(seq_len=16),
                                     **dict(tmx.MIXTRAL_8X7B, num_hidden_layers=2))
    arch = tmx.build_arch(cfg)
    assert (arch.hidden_size, arch.head_dim, arch.num_attention_heads // arch.num_kv_heads,
            arch.vocab_size) == (4096, 128, 4, 32000)
    assert dataclasses.astuple(arch.moe)[:3] == (8, 2, 14336)
    # one device: the JAX package's expert-parallel fields are not carried
    assert arch.moe.dispatch == "sparse" and not hasattr(arch.moe, "ep")
    # a window in the HF config reaches the arch (the JAX module's rule)
    windowed = tmx.build_arch(tmx.MixtralInferenceConfig(
        TorchConfig(seq_len=16), **dict(tmx.MIXTRAL_8X7B, sliding_window=4096)))
    assert windowed.sliding_window == 4096 and arch.sliding_window is None
