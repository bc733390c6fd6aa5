"""The port's Multi-head Latent Attention (``nxdi_tpu_torch/ops/mla.py``) and
DeepSeek family (``models/deepseek``) held against the JAX package's
``nxdi_tpu/ops/mla.py``, its DeepSeek converter and app, and HF
``DeepseekV3ForCausalLM``, on the CPU in float32.

Tolerances: yarn frequencies and attention factors equal (both compute in
float64 numpy and round once to float32); ``mla_attention_block`` within
1e-5 of the JAX package's (float32 sums of 16-64 products of unit-scale
terms through five products) and its latent cache within 1e-6 (the written
rows come from one product of 64 terms, a norm and the rope: the two
packages' products and cos/sin round a few values one ulp apart); the
latent cache's writes and reads, given the same rows, bit for bit, in
float32, bfloat16 and an e4m3 store with per-tensor scales; the tiny
models' prefill logits within 1e-5 of the JAX app's; converted weights and
greedy tokens exactly equal."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nxdi_tpu.config import OnDeviceSamplingConfig as JaxODSC
from nxdi_tpu.config import TpuConfig
from nxdi_tpu.generation.hf_adapter import HuggingFaceGenerationAdapter as JaxAdapter
from nxdi_tpu.kvcache import kv_cache as jkv
from nxdi_tpu.lora import serving as jlora
from nxdi_tpu.config import LoraServingConfig as JaxLoraConfig
from nxdi_tpu.models.base import DEFAULT_POLICY
from nxdi_tpu.models.deepseek import modeling_deepseek as jds
from nxdi_tpu.ops import mla as jmla
from nxdi_tpu.ops import quantization as jquant
from nxdi_tpu.ops import rope as jrope
from nxdi_tpu.runtime.application import TpuModelForCausalLM
from nxdi_tpu.utils.accuracy import hf_greedy_generate
from nxdi_tpu_torch.config import (
    KVQuantizationConfig,
    LoraServingConfig,
    OnDeviceSamplingConfig,
    SpeculationConfig,
    TorchConfig,
)
from nxdi_tpu_torch.generation.hf_adapter import HuggingFaceGenerationAdapter
from nxdi_tpu_torch.kvcache import kv_cache as tkv
from nxdi_tpu_torch.models import base as tbase
from nxdi_tpu_torch.models import dense as tdense
from nxdi_tpu_torch.models.convert import from_jax_params
from nxdi_tpu_torch.models.deepseek import modeling_deepseek as tds
from nxdi_tpu_torch.ops import mla as tmla
from nxdi_tpu_torch.ops import rope as trope
from nxdi_tpu_torch.runtime.application import TorchModelForCausalLM
from nxdi_tpu_torch.serving import InferenceEngine, SamplingParams, SchedulerConfig
from nxdi_tpu_torch.speculation import FusedSpecCausalLM, StandardSpecCausalLM
from test_torch_slice import fresh_jax_compiles

BLOCK_TOL = 1e-5
CACHE_TOL = 1e-6
LOGIT_TOL = 1e-5
PROMPT = np.array([[5, 9, 3, 17, 2, 8, 11, 42]], dtype=np.int64)
NEW = 12


@pytest.fixture(autouse=True, scope="module")
def _fresh_jax_compiles():
    with fresh_jax_compiles():
        yield


def _yarn(factor=4.0, **kw):
    return dict(rope_type="yarn", factor=factor, original_max_position_embeddings=64,
                beta_fast=32, beta_slow=1, **kw)


# the tiny models: all-dense with q-LoRA under a yarn rope whose
# mscale_all_dim scales the softmax (attention factor 1); a dense head + MoE
# tail without q-LoRA under a yarn rope whose attention factor is not 1
MODELS = {
    "dense": dict(num_hidden_layers=2, first_k_dense_replace=2, q_lora_rank=32,
                  rope_scaling=_yarn(mscale=1.0, mscale_all_dim=1.0)),
    "segmented": dict(num_hidden_layers=3, first_k_dense_replace=1, q_lora_rank=None,
                      rope_scaling=_yarn(mscale=1.0)),
}


def make_tiny_hf_deepseek(seed=0, rope_interleave=True, **kw):
    from transformers import DeepseekV3Config, DeepseekV3ForCausalLM

    torch.manual_seed(seed)
    d = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=8,
             num_key_value_heads=8, vocab_size=256, max_position_embeddings=256,
             rms_norm_eps=1e-5, rope_theta=10000.0, q_lora_rank=32, kv_lora_rank=32,
             qk_rope_head_dim=8, qk_nope_head_dim=16, v_head_dim=16, first_k_dense_replace=1,
             n_routed_experts=8, num_experts_per_tok=2, moe_intermediate_size=32, n_group=4,
             topk_group=2, n_shared_experts=1, norm_topk_prob=True, routed_scaling_factor=2.5,
             rope_scaling=None, tie_word_embeddings=False, rope_interleave=rope_interleave,
             eos_token_id=None)
    d.update(kw)
    cfg = DeepseekV3Config(**d)
    model = DeepseekV3ForCausalLM(cfg).eval()
    with torch.no_grad():  # a correction bias that moves the selection
        for name, t in list(model.named_parameters()) + list(model.named_buffers()):
            if name.endswith("e_score_correction_bias"):
                t.normal_(0.0, 0.1)
    return model, cfg


def _sd(model):
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}


def _common(**kw):
    d = dict(tp_degree=1, seq_len=64, max_context_length=32, batch_size=1, dtype="float32",
             attn_kernel_enabled=True, attn_tkg_kernel_enabled=True, skip_warmup=True,
             output_logits=True)
    d.update(kw)
    return d


def _configs(hf_cfg, **kw):
    jcfg = jds.DeepseekInferenceConfig(TpuConfig(**_common(**kw)),
                                       load_config=lambda: hf_cfg.to_dict())
    tcfg = tds.DeepseekInferenceConfig(TorchConfig(**_common(**kw)),
                                       load_config=lambda: hf_cfg.to_dict())
    return jcfg, tcfg


@pytest.fixture(scope="module")
def tiny():
    return {name: make_tiny_hf_deepseek(**kw) for name, kw in MODELS.items()}


# ---------------------------------------------------------------------------
# yarn rope
# ---------------------------------------------------------------------------

YARN = {
    "v3": dict(type="yarn", factor=40, mscale=1.0, mscale_all_dim=1.0,
               original_max_position_embeddings=4096, beta_fast=32, beta_slow=1),
    "mscale-only": _yarn(mscale=1.0),
    "mscale-ratio": _yarn(factor=8.0, mscale=0.707, mscale_all_dim=1.0),
    "attention-factor": _yarn(attention_factor=1.25, truncate=False),
    "low-equals-high": dict(rope_type="yarn", factor=2.0, beta_fast=1, beta_slow=1),
}


@pytest.mark.parametrize("name", list(YARN))
def test_yarn_inv_freq_matches_jax(name):
    rs = YARN[name]
    for dim in (8, 64):
        jinv, jfac = jrope.yarn_inv_freq(dim, 10000.0, rs, 163840)
        tinv, tfac = trope.yarn_inv_freq(dim, 10000.0, rs, 163840)
        np.testing.assert_array_equal(tinv, jinv)
        assert tfac == jfac
        np.testing.assert_array_equal(trope.inv_freq_from_hf_config(dim, 10000.0, rs, 163840),
                                      jrope.inv_freq_from_hf_config(dim, 10000.0, rs, 163840))
    with pytest.raises(ValueError, match="longrope"):
        trope.inv_freq_from_hf_config(8, 10000.0, dict(rope_type="longrope"))


# ---------------------------------------------------------------------------
# mla_attention_block: prefill, then one decode step on the latent cache
# ---------------------------------------------------------------------------

BLOCK_CASES = {
    "q-lora, interleaved": dict(q_lora_rank=32, rope_interleave=True),
    "q-lora, rotate-half": dict(q_lora_rank=32, rope_interleave=False),
    "q_proj, interleaved": dict(q_lora_rank=None, rope_interleave=True),
    "q_proj, rotate-half": dict(q_lora_rank=None, rope_interleave=False),
}


def _layer0(tree):
    seg = tree[0] if isinstance(tree, list) else tree
    return {k: _layer0(v) if isinstance(v, dict) else v[0] for k, v in seg.items()}


@pytest.mark.parametrize("case", list(BLOCK_CASES))
def test_mla_attention_block_matches_jax(case):
    model, hf_cfg = make_tiny_hf_deepseek(
        seed=1, num_hidden_layers=1, first_k_dense_replace=1,
        rope_scaling=_yarn(mscale=1.0, mscale_all_dim=1.0), **BLOCK_CASES[case])
    jcfg, tcfg = _configs(hf_cfg)
    sd = _sd(model)
    jarch, tarch = jds.build_arch(jcfg), tds.build_arch(tcfg)
    jp = jax.tree_util.tree_map(jnp.asarray, _layer0(jds.convert_hf_state_dict(sd, jcfg)["layers"])["attn"])
    tp = _layer0(tds.convert_hf_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                                           tcfg)["layers"])["attn"]
    B, S, W, H = 2, 5, 16, 64
    rng = np.random.default_rng(3)
    jlay, tlay = jkv.ContiguousKVLayout(), tkv.ContiguousKVLayout()
    spec = dict(num_layers=1, batch_size=B, num_kv_heads=1, max_len=W, head_dim=8,
                v_head_dim=32, dtype="float32")
    jspec, tspec = jkv.KVCacheSpec(**spec), tkv.KVCacheSpec(**spec)
    tcache = tkv.init_kv_cache(tspec, device="cpu")
    jk, jv = jnp.asarray(tcache["k"][0].numpy()), jnp.asarray(tcache["v"][0].numpy())
    tk, tv = tcache["k"][0], tcache["v"][0]
    inv = tds.build_inv_freq(tcfg)
    np.testing.assert_array_equal(inv, jds.build_inv_freq(jcfg))
    assert tarch.rope_mscale == jarch.rope_mscale
    assert tarch.mla.softmax_scale == jarch.mla.softmax_scale

    for step, (pos, attend) in enumerate(((np.tile(np.arange(S), (B, 1)), False),
                                          (np.full((B, 1), S), True))):
        x = rng.standard_normal((B, pos.shape[1], H)).astype(np.float32)
        jpos, tpos = jnp.asarray(pos, jnp.int32), torch.from_numpy(pos.astype(np.int32))
        jcos, jsin = jrope.rope_cos_sin(jpos, inv)
        tcos, tsin = trope.rope_cos_sin(tpos, inv)
        jout, (jk, jv) = jmla.mla_attention_block(
            jarch, jp, jnp.asarray(x), jcos * jarch.rope_mscale, jsin * jarch.rope_mscale,
            jk, jv, jpos, jspec, attend, DEFAULT_POLICY, jlay)
        tout, _ = tmla.mla_attention_block(
            tarch, tp, torch.from_numpy(x), tcos * tarch.rope_mscale, tsin * tarch.rope_mscale,
            tk, tv, tpos, tspec, attend, tlay)
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=BLOCK_TOL, rtol=0,
                                   err_msg=f"step {step}")
        for j, t in ((jk, tk), (jv, tv)):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=CACHE_TOL, rtol=0,
                                       err_msg=f"step {step}")
    # the written positions hold rows; the rest stays zero
    assert tk[:, :, : S + 1].abs().sum() > 0 and not tk[:, :, S + 1:].abs().sum()


WRITE_CASES = {
    "float32": dict(dtype="float32"),
    "bfloat16": dict(dtype="bfloat16"),
    "e4m3 per-tensor": dict(dtype="float32", quant_dtype="float8_e4m3",
                            scales=dict(k_scale=0.5, v_scale=0.25)),
    "float32, routed lines": dict(dtype="float32", routed=True),
}


@pytest.mark.parametrize("case", list(WRITE_CASES))
def test_latent_cache_write_and_read_match_jax(case):
    """The latent cache (one head, K 8 wide, V 32 wide) written by a prefill
    (its slice write, or under routed lines the commit path) and a decode
    row, then read: the same bits as the JAX package's layout given the same
    rows."""
    c = dict(WRITE_CASES[case])
    scales, routed = c.pop("scales", {}), c.pop("routed", False)
    B, S, W = 2, 5, 16
    spec = dict(num_layers=1, batch_size=B, num_kv_heads=1, max_len=W, head_dim=8,
                v_head_dim=32, **c)
    jspec, tspec = jkv.KVCacheSpec(**spec), tkv.KVCacheSpec(**spec)
    jlay = jkv.ContiguousKVLayout(route_by_seq_id=routed, **scales)
    tlay = tkv.ContiguousKVLayout(route_by_seq_id=routed, **scales)
    tcache = tkv.init_kv_cache(tspec, device="cpu")
    tk, tv = tcache["k"][0], tcache["v"][0]
    assert tcache["v"].shape == (1, B, 1, W, 32) and tk.dtype == tspec.store_dtype
    jk = jnp.zeros(jspec.shape[1:], jspec.store_dtype)
    jv = jnp.zeros(jspec.shape_v[1:], jspec.store_dtype)
    rng = np.random.default_rng(5)
    compute = tspec.torch_dtype
    seq = np.array([1, 0], np.int32)

    def raw(x):
        x = np.asarray(x)
        return x.view(np.uint8) if x.dtype.itemsize == 1 else x.view(np.uint16) \
            if x.dtype.itemsize == 2 else x

    for pos in (np.tile(np.arange(S), (B, 1)), np.array([[S], [S + 2]])):
        rows_k = torch.from_numpy(rng.standard_normal((B, 1, pos.shape[1], 8)).astype(np.float32))
        rows_v = torch.from_numpy(rng.standard_normal((B, 1, pos.shape[1], 32)).astype(np.float32))
        rows_k, rows_v = rows_k.to(compute), rows_v.to(compute)
        ci = {"position_ids": torch.from_numpy(pos.astype(np.int32))}
        jci = {"position_ids": jnp.asarray(pos, jnp.int32)}
        if routed:
            ci["seq_ids"], jci["seq_ids"] = torch.from_numpy(seq), jnp.asarray(seq)
        if pos.shape[1] > 1:
            ci["prefill_from_zero"] = jci["prefill_from_zero"] = True

        def to_j(t):
            return jnp.asarray(t.float().numpy()).astype(jspec.compute_dtype)

        tlay.update(tk, tv, rows_k, rows_v, ci, tspec)
        jk, jv = jlay.update(jk, jv, to_j(rows_k), to_j(rows_v), jci, jspec)
        for t, j in ((tk, jk), (tv, jv)):
            np.testing.assert_array_equal(raw(t.view(torch.uint8) if t.element_size() == 1
                                              else t.view(torch.int16) if t.element_size() == 2
                                              else t), raw(j))
        tr = tlay.read(tk, tv, ci, tspec)
        jr = jlay.read(jk, jv, jci, jspec)
        for t, j in zip(tr, jr):
            np.testing.assert_array_equal(t.float().numpy(), np.asarray(j).astype(np.float32))


# ---------------------------------------------------------------------------
# conversion
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["dense", "segmented", "all-moe"])
def test_convert_hf_state_dict_matches_jax(tiny, name, monkeypatch):
    """The port's converter equals the JAX package's leaf for leaf (the
    segment list included), from_jax_params carries the JAX params across to
    the same tree, and param_shapes / random_params give its shapes (for
    "all-moe" with every weight drawn in pieces, as DeepSeek-V3's experts
    are)."""
    if name == "all-moe":
        model, hf_cfg = make_tiny_hf_deepseek(first_k_dense_replace=0)
    else:
        model, hf_cfg = tiny[name]
    jcfg, tcfg = _configs(hf_cfg)
    sd = _sd(model)
    jp = jds.convert_hf_state_dict(sd, jcfg)
    tp = tds.convert_hf_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, tcfg)
    carried = from_jax_params(jp)
    segmented = isinstance(jp["layers"], list)
    assert segmented == (name == "segmented") == tds.segmented(tcfg)
    assert isinstance(tp["layers"], list) == segmented

    def walk(a, b, c, path=()):
        assert type(a) is type(c) or isinstance(a, np.ndarray)
        if isinstance(a, dict):
            assert set(a) == set(b) == set(c), path
            for k in a:
                walk(a[k], b[k], c[k], path + (k,))
        elif isinstance(a, list):
            assert len(a) == len(b) == len(c)
            for i, (x, y, z) in enumerate(zip(a, b, c)):
                walk(x, y, z, path + (i,))
        else:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=str(path))
            np.testing.assert_array_equal(c.numpy(), np.asarray(a), err_msg=str(path))
            assert b.dtype == c.dtype, path

    walk(jp, tp, carried)

    def shapes(tree):
        if isinstance(tree, list):
            return [shapes(v) for v in tree]
        return {k: shapes(v) if isinstance(v, (dict, list)) else tuple(v.shape)
                for k, v in tree.items()}

    assert shapes(tp) == tds.param_shapes(tcfg)
    if name == "all-moe":
        monkeypatch.setattr(tdense, "_DRAW_WHOLE_BYTES", 1024)
        monkeypatch.setattr(tdense, "_DRAW_PIECE", 1000)
    rand = tds.random_params(tcfg, device="cpu")
    assert shapes(rand) == tds.param_shapes(tcfg)
    w = rand["layers"]["moe"]["experts"]["up_proj"]["w"] if name == "all-moe" else None
    if w is not None:  # 2 x 8 x 64 x 32 values in 33 pieces: one N(0, 0.02) draw
        assert w.dtype == torch.float32 and abs(w.std().item() - 0.02) < 1e-3
        flat = w.reshape(-1)
        assert not torch.equal(flat[:1000], flat[1000:2000])  # each piece a fresh draw
    if name != "dense":
        moe = rand["layers"][-1] if segmented else rand["layers"]
        assert moe["moe"]["router"]["e_bias"].dtype == torch.float32


# ---------------------------------------------------------------------------
# the tiny models: HF, the JAX package's app and the port's
# ---------------------------------------------------------------------------


def _jax_app(hf_cfg, sd, **kw):
    jcfg = jds.DeepseekInferenceConfig(
        TpuConfig(on_device_sampling_config=JaxODSC(), **_common(**kw)),
        load_config=lambda: hf_cfg.to_dict())

    class App(TpuModelForCausalLM):
        def get_state_dict(self):
            return sd

    app = App("<memory>", jcfg, model_family=jds)
    app.load()
    return app


def _port_app(hf_cfg, sd, **kw):
    tcfg = tds.DeepseekInferenceConfig(
        TorchConfig(on_device_sampling_config=OnDeviceSamplingConfig(), **_common(**kw)),
        load_config=lambda: hf_cfg.to_dict())

    class App(TorchModelForCausalLM):
        def get_state_dict(self):
            return {k: torch.from_numpy(v) for k, v in sd.items()}

    app = App("<memory>", tcfg, model_family=tds, device="cpu")
    app.load()
    return app


def _prefill_logits(app):
    out = app.forward(PROMPT.astype(np.int32), np.arange(PROMPT.shape[1], dtype=np.int32)[None],
                      last_token_index=np.array([PROMPT.shape[1] - 1], np.int32))
    logits = out["logits"]
    return logits.numpy() if isinstance(logits, torch.Tensor) else np.asarray(logits)


def _strategies(app):
    return {s for w in app.models.values() for ss in w.attention_strategies.values() for s in ss}


@pytest.mark.parametrize("name", list(MODELS))
def test_tiny_deepseek_generate_matches_jax_and_hf(tiny, name):
    """Greedy generate() equals the JAX app's and HF's; prefill logits
    within LOGIT_TOL of the JAX app's. The attention kernel flags are on in
    both packages and ignored on the CPU (the JAX rule for MLA)."""
    hf_model, hf_cfg = tiny[name]
    sd = _sd(hf_model)
    japp, app = _jax_app(hf_cfg, sd), _port_app(hf_cfg, sd)
    assert app.kv_cache["k"].shape == (hf_cfg.num_hidden_layers, 1, 1, 64, 8)
    assert app.kv_cache["v"].shape == (hf_cfg.num_hidden_layers, 1, 1, 64, 32)
    np.testing.assert_allclose(_prefill_logits(app), _prefill_logits(japp), atol=LOGIT_TOL,
                               rtol=0)
    expected = hf_greedy_generate(hf_model, PROMPT, max_new_tokens=NEW)
    np.testing.assert_array_equal(JaxAdapter(japp).generate(PROMPT, max_new_tokens=NEW),
                                  expected)
    np.testing.assert_array_equal(
        HuggingFaceGenerationAdapter(app).generate(PROMPT, max_new_tokens=NEW), expected)
    want = {"mla_xla"} | ({"moe_sparse_per_expert"} if name == "segmented" else set())
    assert _strategies(app) == want


def test_tiny_deepseek_mlp_kernel_on_dense_segment(tiny):
    """mlp_kernel_enabled runs the fused MLP (its plain version on the CPU)
    on the dense head's layers, indexed within the segment, and leaves the
    MoE tail to moe_block: tokens equal HF's; an all-MoE stack, which has
    no dense MLP, refuses the flag."""
    hf_model, hf_cfg = tiny["segmented"]
    app = _port_app(hf_cfg, _sd(hf_model), mlp_kernel_enabled=True)
    np.testing.assert_array_equal(
        HuggingFaceGenerationAdapter(app).generate(PROMPT, max_new_tokens=NEW),
        hf_greedy_generate(hf_model, PROMPT, max_new_tokens=NEW))
    assert {"mlp_fused_kernel", "moe_sparse_per_expert", "mla_xla"} == _strategies(app)
    dense_seg, moe_seg = app.params["layers"]
    mlp_st, _ = tbase.stacked_proj_weights(app.models["token_generation_model"].arch, dense_seg)
    assert mlp_st is not None and mlp_st[0].shape[0] == 1
    assert tbase.stacked_proj_weights(app.models["token_generation_model"].arch,
                                      moe_seg) == (None, None)
    _, cfg0 = make_tiny_hf_deepseek(first_k_dense_replace=0)
    with pytest.raises(NotImplementedError, match="mlp_kernel_enabled: this model has no dense"):
        tds.build_arch(_configs(cfg0, mlp_kernel_enabled=True)[1])


@pytest.mark.parametrize("name", list(MODELS))
def test_tiny_deepseek_contiguous_engine_matches_hf(tiny, name):
    """The contiguous continuous-batching engine (cache lines routed by
    seq_ids: routed prefill writes and per-layer decode writes through the
    commit path, reads gathering lines) over three requests in two slots,
    one arriving late: every stream equals HF greedy."""
    hf_model, hf_cfg = tiny[name]
    app = _port_app(hf_cfg, _sd(hf_model), batch_size=2, is_continuous_batching=True,
                    ctx_batch_size=2, tkg_batch_size=2, kv_cache_batch_size=2,
                    enable_bucketing=True)
    eng = InferenceEngine(app, SchedulerConfig())
    prompts = [[5, 9, 3, 17, 2, 8], [7, 13, 21, 4, 33], [9, 9, 2, 40, 17, 3, 11]]
    reqs = [eng.add_request(p, SamplingParams(max_new_tokens=8)) for p in prompts[:2]]
    outs = eng.step()
    reqs.append(eng.add_request(prompts[2], SamplingParams(max_new_tokens=8)))
    outs += eng.run()
    got = {o.request_id: o.token_ids for o in outs}
    for r, p in zip(reqs, prompts):
        want = hf_greedy_generate(hf_model, np.array([p]), 8)[0, len(p):].tolist()
        assert got[r.request_id] == want


# ---------------------------------------------------------------------------
# refusals and the kernel-flag gate
# ---------------------------------------------------------------------------


def test_paged_layout_refused(tiny):
    _, hf_cfg = tiny["dense"]
    _, tcfg = _configs(hf_cfg, is_block_kv_layout=True, pa_block_size=8, pa_num_blocks=16)
    with pytest.raises(ValueError, match="MLA does not support the block KV layout"):
        tds.build_arch(tcfg)


@pytest.mark.parametrize("kind", ["fused", "standard"])
def test_speculation_on_mla(tiny, kind):
    """Speculation on an MLA target with an MLA draft (the target's own
    weights: every window accepted whole, so every verify row's token is
    emitted): the fused window (its draft steps ordinary decode forwards,
    each layer committing its latent row) and the draft-model pair; tokens
    equal HF greedy and the JAX app's, count for count."""
    from nxdi_tpu.config import SpeculationConfig as JaxSpecConfig
    from nxdi_tpu.speculation import FusedSpecCausalLM as JaxFused
    from nxdi_tpu.speculation import StandardSpecCausalLM as JaxStandard

    hf_model, hf_cfg = tiny["dense"]
    sd = _sd(hf_model)
    tsd = {k: torch.from_numpy(v) for k, v in sd.items()}
    spec_len = 2
    outs, logs = [], []
    for jax_side in (True, False):
        Tc, Spec, Odsc, fam = ((TpuConfig, JaxSpecConfig, JaxODSC, jds) if jax_side
                               else (TorchConfig, SpeculationConfig, OnDeviceSamplingConfig, tds))
        spec = (dict(speculation_config=Spec(speculation_length=spec_len,
                                             enable_fused_speculation=True))
                if kind == "fused" else dict(speculation_length=spec_len))
        cfg = fam.DeepseekInferenceConfig(Tc(**_common(on_device_sampling_config=Odsc(), **spec)),
                                          load_config=lambda: hf_cfg.to_dict())
        dcfg = fam.DeepseekInferenceConfig(Tc(**_common(on_device_sampling_config=Odsc())),
                                           load_config=lambda: hf_cfg.to_dict())
        state = sd if jax_side else tsd
        extra = {} if jax_side else dict(device="cpu")
        if kind == "fused":
            class App(JaxFused if jax_side else FusedSpecCausalLM):
                def get_state_dict(self):
                    return state

                get_draft_state_dict = get_state_dict

            app = App("<t>", cfg, "<d>", dcfg, model_family=fam, **extra)
        else:
            app = (JaxStandard if jax_side else StandardSpecCausalLM)(
                "<t>", cfg, "<d>", dcfg, model_family=fam, **extra)
            app.target.get_state_dict = app.draft.get_state_dict = lambda state=state: state
        app.load()
        log, inner = [], app.forward

        def fwd(input_ids, position_ids, inner=inner, log=log, **kw):
            out = inner(input_ids, position_ids, **kw)
            if np.asarray(input_ids).shape[1] == 1:
                log.append(int(np.asarray(out["counts"])[0]))
            return out

        app.forward = fwd
        Adapter = JaxAdapter if jax_side else HuggingFaceGenerationAdapter
        outs.append(np.asarray(Adapter(app).generate(PROMPT, max_new_tokens=NEW)))
        logs.append(log)
    want = hf_greedy_generate(hf_model, PROMPT, max_new_tokens=NEW)
    np.testing.assert_array_equal(outs[1], want)
    np.testing.assert_array_equal(outs[0], want)
    assert logs[1] == logs[0] and logs[1][0] == spec_len + 1


def _lora_cfg(**kw):
    return dict(max_loras=1, max_lora_rank=4, target_modules=["o_proj", "gate_proj", "down_proj"],
                lora_dtype="float32", **kw)


def test_lora_on_segmented_stack(tiny):
    """The JAX package attaches no adapter buffer to a segmented stack
    (``params["layers"]`` is a list there, and ``attach_lora_buffers``
    looks its groups up in it), so its adapters would change nothing: the
    port raises at app build instead, and so does weight quantization,
    whose JAX walk passes the list through."""
    hf_model, hf_cfg = tiny["segmented"]
    jcfg, _ = _configs(hf_cfg)
    jp = jds.convert_hf_state_dict(_sd(hf_model), jcfg)
    jlora.attach_lora_buffers(jp, jds.build_arch(jcfg), JaxLoraConfig(**_lora_cfg()))

    def has_lora(tree):
        if isinstance(tree, list):
            return any(has_lora(v) for v in tree)
        return isinstance(tree, dict) and ("lora_A" in tree or any(
            has_lora(v) for v in tree.values()))

    assert isinstance(jp["layers"], list) and not has_lora(jp)
    jq = jquant.quantize_params(jp, quant_dtype="int8")
    assert all("w" in seg["attn"]["o_proj"] and "qw" not in seg["attn"]["o_proj"]
               for seg in jq["layers"])
    for extra in (dict(lora_config=LoraServingConfig(**_lora_cfg())), dict(quantized=True)):
        with pytest.raises(NotImplementedError, match="segmented layer stack"):
            _port_app(hf_cfg, _sd(hf_model), **extra)


def test_lora_on_dense_deepseek_skips_mla(tiny):
    """On an all-dense stack LoRA follows the JAX package: the MLP targets
    get slot buffers and MLA attention (o_proj here) none; the base slot
    generates HF's tokens."""
    hf_model, hf_cfg = tiny["dense"]
    app = _port_app(hf_cfg, _sd(hf_model), lora_config=LoraServingConfig(**_lora_cfg()))
    layers = app.params["layers"]
    assert "lora_A" in layers["mlp"]["gate_proj"] and "lora_A" in layers["mlp"]["down_proj"]
    assert "lora_A" not in layers["attn"]["o_proj"]
    np.testing.assert_array_equal(
        HuggingFaceGenerationAdapter(app).generate(PROMPT, max_new_tokens=NEW),
        hf_greedy_generate(hf_model, PROMPT, max_new_tokens=NEW))


def test_kernel_flag_gate_and_latent_scales(tiny):
    """The kernel flags on an MLA model: ignored on the CPU (the JAX rule),
    raising on the card, naming MLA attention (checked through the gate
    with ``on_cuda``); per-key and per-channel KV scales, whose JAX tables
    are sized for per-head K/V of one width, are refused on the latent
    cache."""
    _, hf_cfg = tiny["dense"]
    arch = tds.build_arch(_configs(hf_cfg, qkv_kernel_enabled=True, fused_qkv=True)[1])
    assert arch.attn_kernel_enabled and arch.qkv_kernel_enabled
    tmla.mla_kernel_gate(arch, on_cuda=False)
    for flag in tmla.MLA_KERNEL_FLAGS:
        one = dataclasses.replace(arch, **{f: f == flag for f in tmla.MLA_KERNEL_FLAGS})
        with pytest.raises(NotImplementedError, match=f"{flag} is set .*MLA attention"):
            tmla.mla_kernel_gate(one, on_cuda=True)
    off = dataclasses.replace(arch, **dict.fromkeys(tmla.MLA_KERNEL_FLAGS, False))
    tmla.mla_kernel_gate(off, on_cuda=True)
    from nxdi_tpu_torch.runtime.model_wrapper import kv_layout_from_config

    scales = np.ones((2, 1), np.float32)
    tc = TorchConfig(**_common(kv_quant_config=KVQuantizationConfig(
        dtype="float8_e4m3", scale_mode="per_key", k_scales=scales, v_scales=scales)))
    with pytest.raises(NotImplementedError, match="MLA latent cache"):
        kv_layout_from_config(tc, arch)


def test_deepseek_v3_widths():
    """DEEPSEEK_V3 at 4 layers (the 3 dense of first_k_dense_replace + 1 MoE
    layer): two segments, the latent cache's widths (rope key 64, latent
    512, one head), the softmax scale times mscale**2, attention factor 1,
    and ~30 GB of bf16 weights."""
    cfg = tds.DeepseekInferenceConfig(TorchConfig(seq_len=16, dtype="bfloat16"),
                                      **dict(tds.DEEPSEEK_V3, num_hidden_layers=4))
    arch = tds.build_arch(cfg)
    head, tail = tds._segment_archs(cfg, arch)
    assert (head.num_layers, head.moe, tail.num_layers) == (3, None, 1)
    spec = arch.kv_cache_spec(8, 16)
    assert spec.shape == (4, 8, 1, 16, 64) and spec.shape_v == (4, 8, 1, 16, 512)
    m = 0.1 * np.log(40) + 1.0
    assert arch.mla.softmax_scale == pytest.approx(192 ** -0.5 * m * m, rel=1e-12)
    assert arch.rope_mscale == 1.0 and arch.mla.q_lora_rank == 1536
    assert (arch.moe.num_experts, arch.moe.top_k, arch.moe.n_group, arch.moe.topk_group,
            arch.moe.shared_expert_intermediate_size) == (256, 8, 8, 4, 2048)

    def nbytes(tree):
        if isinstance(tree, list):
            return sum(nbytes(v) for v in tree)
        if isinstance(tree, dict):
            return sum(nbytes(v) for v in tree.values())
        return int(np.prod(tree)) * 2

    assert 29e9 < nbytes(tds.param_shapes(cfg)) < 31e9
    assert tds.build_inv_freq(cfg).shape == (32,)
