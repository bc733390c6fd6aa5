"""Llama 4's text decoder in the port (``llama4`` / ``llama4_text``), held
against the JAX package's family and HF's ``Llama4ForCausalLM`` on a tiny
random config: the L2 q / k norm and the chunk mask against the JAX
functions, one attention layer of each kind (a rope layer: chunk and L2 norm;
a NoPE layer: the query temperature) against the JAX ``attention_block``,
float32 prefill logits within 1e-5 of the JAX app's and greedy tokens equal
to the JAX app's and HF's, the converters (a composite checkpoint too), each
switch dropped, and the refusals.

The switches bite at these widths: the 64-token prompts cross eight chunks
of 8, the temperature's ``floor_scale`` (8) is passed at position 7 and every
eighth after, its ``attn_scale`` (0.5) is five times Scout's, layer 1 of 2 is
NoPE (``no_rope_layers`` [1, 0]) and the norm weights are drawn away from
one. The attention kernel flags are on in both
packages; the per-layer rope flags keep every attention kernel off on the CPU
(the JAX rule), where the card's kernels take each layer's chunk."""

import dataclasses
import functools
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nxdi_tpu.config import TpuConfig
from nxdi_tpu.generation.hf_adapter import HuggingFaceGenerationAdapter as JaxAdapter
from nxdi_tpu.kvcache.kv_cache import KVCacheSpec as JaxKVCacheSpec
from nxdi_tpu.models import base as jbase
from nxdi_tpu.models import registry as jreg
from nxdi_tpu.ops import attention as jattn
from nxdi_tpu.ops import rope as jrope
from nxdi_tpu.utils.accuracy import hf_greedy_generate
from nxdi_tpu_torch.config import OnDeviceSamplingConfig, TorchConfig
from nxdi_tpu_torch.generation.hf_adapter import HuggingFaceGenerationAdapter
from nxdi_tpu_torch.kvcache.kv_cache import KVCacheSpec
from nxdi_tpu_torch.models import base as tbase
from nxdi_tpu_torch.models import registry as treg
from nxdi_tpu_torch.models.convert import from_jax_params
from nxdi_tpu_torch.ops import attention as tattn
from nxdi_tpu_torch.ops import rope as trope
from nxdi_tpu_torch.ops.kernels import flash_attention as fa
from nxdi_tpu_torch.runtime.application import (
    TorchModelForCausalLM,
    refuse_speculation,
    refuse_unported,
)

from test_torch_families import LOGIT_TOL, _tc, jax_family_app, port_family_app, strategies
from test_torch_slice import fresh_jax_compiles

CHUNK = 8
NEW = 10
PROMPT = np.random.default_rng(19).integers(1, 256, size=(1, 64)).astype(np.int64)
TINY = dict(hidden_size=64, intermediate_size=128, intermediate_size_mlp=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, head_dim=16, vocab_size=256,
            max_position_embeddings=256, rms_norm_eps=1e-5, rope_theta=10000.0,
            tie_word_embeddings=False, num_local_experts=4, num_experts_per_tok=1,
            interleave_moe_layer_step=1, attention_chunk_size=CHUNK, no_rope_layers=[1, 0],
            use_qk_norm=True, attn_temperature_tuning=True, floor_scale=8, attn_scale=0.5,
            attn_implementation="eager")
APP = dict(seq_len=128, max_context_length=64)


@pytest.fixture(autouse=True, scope="module")
def _fresh_jax_compiles():
    with fresh_jax_compiles():
        yield


@functools.lru_cache(maxsize=None)
def tiny_case():
    """(HF model, its config dict, the state dict as numpy): norm weights
    N(1, 0.3)."""
    import transformers

    torch.manual_seed(0)
    cfg = transformers.Llama4TextConfig(**TINY)
    model = transformers.Llama4ForCausalLM(cfg).eval()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "norm" in name:
                p.normal_(1.0, 0.3)
    return model, cfg.to_dict(), {k: v.detach().numpy() for k, v in model.state_dict().items()}


@functools.lru_cache(maxsize=None)
def apps():
    """(JAX app, port app on the JAX app's params)."""
    _, cfg, sd = tiny_case()
    japp = jax_family_app("llama4_text", cfg, sd, **APP)
    tapp = port_family_app("llama4_text", cfg, params=from_jax_params(jax.device_get(japp.params)),
                           **APP)
    return japp, tapp


def logits_of(app, prompt=PROMPT):
    S = prompt.shape[1]
    out = app.forward(prompt.astype(np.int32), np.arange(S, dtype=np.int32)[None],
                      last_token_index=np.array([S - 1], np.int32))
    logits = out["logits"]
    return logits.numpy() if isinstance(logits, torch.Tensor) else np.asarray(
        jax.device_get(logits))


def configs(cfg=None, **tc):
    """(JAX family config, port family config) of the tiny model."""
    cfg = cfg or tiny_case()[1]
    jfam, jcls = jreg.get_family("llama4_text")
    tfam, tcls = treg.get_family("llama4_text")
    return (jcls(TpuConfig(**_tc(**APP, **tc)), load_config=lambda: dict(cfg)),
            tcls(TorchConfig(**_tc(**APP, **tc)), load_config=lambda: dict(cfg)))


@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_l2_norm_matches_jax(eps):
    """The unweighted L2 norm in float32 (f32 and bf16 inputs) against the
    JAX function: within 2e-6 in f32, equal after the cast to bf16 up to one
    bf16 ulp."""
    x = np.random.default_rng(3).standard_normal((2, 4, 5, 16)).astype(np.float32) * 3
    got = trope.l2_norm(torch.from_numpy(x), eps).numpy()
    np.testing.assert_allclose(got, np.asarray(jrope.l2_norm(jnp.asarray(x), eps)), atol=2e-6,
                               rtol=0)
    np.testing.assert_allclose(np.sqrt((got ** 2).mean(-1)), 1.0, atol=1e-5)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    gb = trope.l2_norm(xb, eps)
    assert gb.dtype == torch.bfloat16
    np.testing.assert_allclose(gb.float().numpy(), got, atol=2 ** -7 * 4, rtol=2 ** -7)


def _mask_inputs(seed=5):
    rng = np.random.default_rng(seed)
    B, H, KV, S, W, D = 2, 4, 2, 3, 20, 8
    arrs = dict(q=rng.standard_normal((B, H, S, D)) * 3, k=rng.standard_normal((B, KV, W, D)) * 3,
                v=rng.standard_normal((B, KV, W, D)), k2=rng.standard_normal((B, KV, S, D)) * 3,
                v2=rng.standard_normal((B, KV, S, D)))
    arrs = {n: a.astype(np.float32) for n, a in arrs.items()}
    arrs["qpos"] = np.tile(np.arange(W, W + S, dtype=np.int32), (B, 1))
    arrs["kvpos"] = np.tile(np.arange(W, dtype=np.int32), (B, 1))
    return arrs


@pytest.mark.parametrize("fn", ["positions", "two_part"])
@pytest.mark.parametrize("enabled", [None, True, False])
def test_chunk_mask_matches_jax(fn, enabled):
    """The chunk mask under a per-layer ``chunk_enabled`` flag (None: always
    on) in the positional and two-part attention, against the JAX functions
    (f32, within 2e-6); the chunk (8, queries at 20-22) bites where it is on
    and the flag off gives plain causal attention."""
    a = _mask_inputs()
    t = {n: torch.from_numpy(x) for n, x in a.items()}
    j = {n: jnp.asarray(x) for n, x in a.items()}

    def run(mod, x, chunk, flag):
        if flag is not None:
            flag = torch.tensor(flag) if mod is tattn else jnp.asarray(flag)
        if fn == "positions":
            return mod.attention_with_positions(x["q"], x["k"], x["v"], x["qpos"], x["kvpos"],
                                                scale=0.5, chunk_size=chunk, chunk_enabled=flag)
        return mod.attention_two_part(x["q"], x["k"], x["v"], x["k2"], x["v2"], x["qpos"],
                                      x["kvpos"], x["qpos"], scale=0.5, chunk_size=chunk,
                                      chunk_enabled=flag)

    got = run(tattn, t, CHUNK, enabled).numpy()
    np.testing.assert_allclose(got, np.asarray(run(jattn, j, CHUNK, enabled)), atol=2e-6, rtol=0)
    causal = run(tattn, t, None, None).numpy()
    if enabled is False:
        np.testing.assert_array_equal(got, causal)
    else:
        assert np.abs(got - causal).max() > 1e-2


@pytest.mark.parametrize("layer", [0, 1])
@pytest.mark.parametrize("decode", [False, True])
def test_attention_block_matches_jax(layer, decode):
    """One attention layer of the tiny model against the JAX
    ``attention_block`` on the same params and inputs (f32, within 2e-6):
    layer 0 ropes, takes the L2 norm and attends its chunk; layer 1 is NoPE
    and its queries take the temperature (positions 0-63 pass the
    floor_scale 8 seven times). The prefill attends 64 fresh rows; the
    deferred decode one row at position 70 over a 70-position cache."""
    japp, tapp = apps()
    jcfg, tcfg = configs()
    jarch = jreg.get_family("llama4_text")[0].build_arch(jcfg)
    tarch = tapp.family.build_arch(tcfg)
    jp = jax.tree_util.tree_map(lambda x: x[layer], jax.device_get(japp.params)["layers"])
    tp = tbase.layer_params(tapp.params["layers"], layer)
    rng = np.random.default_rng(11 + layer)
    B, S_cache = 2, 128
    S = 1 if decode else 64
    hidden = rng.standard_normal((B, S, 64)).astype(np.float32)
    pos = (np.full((B, 1), 70) if decode else np.tile(np.arange(S), (B, 1))).astype(np.int32)
    inv = tapp.family.build_inv_freq(tcfg)
    cos, sin = trope.rope_cos_sin(torch.from_numpy(pos), inv)
    kc = rng.standard_normal((B, 2, S_cache, 16)).astype(np.float32)
    vc = rng.standard_normal((B, 2, S_cache, 16)).astype(np.float32)
    cache_inputs = {}
    spec_kw = dict(num_layers=2, batch_size=B, num_kv_heads=2, max_len=S_cache, head_dim=16,
                   dtype="float32")
    want, _ = jbase.attention_block(
        jarch, jp["attn"], jnp.asarray(hidden), jnp.asarray(cos.numpy()),
        jnp.asarray(sin.numpy()), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(pos),
        JaxKVCacheSpec(**spec_kw), decode, cache_inputs=cache_inputs,
        use_rope=jnp.asarray(jp["use_rope"]), defer_write=decode)
    got, _ = tbase.attention_block(
        tarch, tp["attn"], torch.from_numpy(hidden), cos, sin, torch.from_numpy(kc.copy()),
        torch.from_numpy(vc.copy()), torch.from_numpy(pos), KVCacheSpec(**spec_kw), decode,
        defer_write=decode,
        lf=tbase.LayerFlags(None, tp["use_rope"], None, tarch.layer_chunk(layer)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6, rtol=0)
    assert tarch.layer_chunk(layer) == (CHUNK if layer == 0 else None)


def test_llama4_matches_jax_and_hf():
    """The port on the JAX app's params: prefill logits of a 64-token prompt
    within 1e-5 of the JAX app's, greedy tokens equal to the JAX app's and
    HF's; plain attention on both strategies (the rope flags: the JAX
    rule), the MoE's per-expert product (the CPU's float32)."""
    hf_model, _, _ = tiny_case()
    japp, tapp = apps()
    np.testing.assert_allclose(logits_of(tapp), logits_of(japp), atol=LOGIT_TOL, rtol=0)
    want = JaxAdapter(japp).generate(PROMPT, max_new_tokens=NEW)
    got = HuggingFaceGenerationAdapter(tapp).generate(PROMPT, max_new_tokens=NEW)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, hf_greedy_generate(hf_model, PROMPT, NEW))
    assert len(set(got[0, PROMPT.shape[1]:].tolist())) > 2  # the tokens move
    seen = strategies(tapp)
    assert seen["context_encoding_model"] == {"cte_xla", "moe_sparse_per_expert"}
    assert seen["token_generation_model"] == {"tkg_two_part_xla", "moe_sparse_per_expert"}


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _same_leaves(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=str(k))
    return got


def test_converter_matches_jax():
    """The port's converter of the HF checkpoint gives the JAX converter's
    params leaf for leaf (the router, the split gate_up experts, the shared
    expert, the rope flags), and random_params has the same tree."""
    _, cfg, sd = tiny_case()
    jcfg, tcfg = configs()
    jfam, tfam = jreg.get_family("llama4_text")[0], treg.get_family("llama4_text")[0]
    want = from_jax_params(jfam.convert_hf_state_dict(sd, jcfg))
    got = _same_leaves(tfam.convert_hf_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                                                  tcfg), want)
    assert got[("layers", "use_rope")].tolist() == [True, False]
    assert got[("layers", "moe", "experts", "gate_proj", "w")].shape == (2, 4, 64, 128)
    rand = dict(_leaves(tfam.random_params(tcfg, device="cpu")))
    assert rand.keys() == got.keys()
    for k in got:
        assert (rand[k].shape, rand[k].dtype) == (got[k].shape, got[k].dtype), k


def test_composite_checkpoint_conversion():
    """A composite (vision + text) checkpoint: ``text_config`` promoted (the
    same arch as the text-only config) and the ``language_model.`` prefixes
    stripped, the vision tower dropped: the same params as the text-only
    checkpoint's, which the JAX converter gives too."""
    _, cfg, sd = tiny_case()
    composite = {("language_model." + k): v for k, v in sd.items()}
    composite["vision_model.patch_embedding.linear.weight"] = np.zeros((4, 4), np.float32)
    comp_cfg = dict(model_type="llama4", tie_word_embeddings=True, text_config=dict(cfg))
    jc, tc = configs(comp_cfg)
    jt, tt = configs()
    tfam = treg.get_family("llama4")[0]
    assert tfam.build_arch(tc) == tfam.build_arch(tt)
    text = tfam.convert_hf_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, tt)
    _same_leaves(tfam.convert_hf_state_dict(
        {k: torch.from_numpy(v) for k, v in composite.items()}, tc), text)
    jfam = jreg.get_family("llama4")[0]
    _same_leaves(text, from_jax_params(jfam.convert_hf_state_dict(composite, jc)))


def _dropped(arch_over):
    """The port app on the JAX app's params with ``arch_over`` set in its arch."""
    _, cfg, _ = tiny_case()
    japp, _ = apps()
    family, cfg_cls = treg.get_family("llama4_text")
    shim = types.SimpleNamespace(
        build_arch=lambda c, **kw: family.build_arch(c, **{**arch_over, **kw}),
        build_inv_freq=family.build_inv_freq)
    params = from_jax_params(jax.device_get(japp.params))

    class App(TorchModelForCausalLM):
        def build_params(self):
            return params

    config = cfg_cls(TorchConfig(on_device_sampling_config=OnDeviceSamplingConfig(),
                                 **_tc(**APP)), load_config=lambda: dict(cfg))
    app = App("<memory>", config, model_family=shim, device="cpu")
    app.load()
    return app


@pytest.mark.parametrize("switch", ["chunk_size", "qk_l2norm", "attn_temperature_tuning"])
def test_dropped_switch_leaves_jax(switch):
    """Each switch bites: the port with it dropped is far from the JAX app's
    logits."""
    japp, _ = apps()
    over = {switch: None if switch == "chunk_size" else False}
    assert np.abs(logits_of(_dropped(over)) - logits_of(japp)).max() > 1e-3


def test_decode_visible_range_takes_the_chunk():
    """The decode kernel's scan of a row starts at its chunk's start (a
    block whose slots lie before it exits at once): every position the
    chunk mask shows lies in [lo, hi), both with and without a kv offset,
    and lo is the chunk's start past the first chunk."""
    qp = np.array([5, 8, 70, 127, 64])
    ks = np.array([0, 0, 3, 10, 0])
    for fresh in (False, True):
        lo, hi = fa.decode_visible_range(qp, ks, 128, fresh=fresh, chunk=CHUNK)
        for b in range(len(qp)):
            pos = ks[b] + np.arange(128)
            vis = (pos <= qp[b] - fresh) & (pos // CHUNK == qp[b] // CHUNK)
            slots = np.nonzero(vis)[0]
            assert slots.size == 0 or (lo[b] <= slots.min() and slots.max() < hi[b])
            assert lo[b] == max(0, min(hi[b], qp[b] // CHUNK * CHUNK - ks[b]))
    lo_ring, _ = fa.decode_visible_range(qp, None, 8, fresh=True, chunk=CHUNK, ring=8)
    assert (lo_ring == 0).all()


def test_registry_and_refusals():
    """The registry serves ``llama4`` and ``llama4_text``. The mixed step,
    chain speculation, LoRA and a quantized KV store carry the switches
    (``test_torch_family_mixed.py``, ``test_torch_family_spec*.py``); a
    token tree on the chunked target is refused, naming the chunk. The
    128-expert interleaved stack raises. The paged and ragged kernels take no
    chunk (the JAX rule): the CPU attends plainly, an enabled flag on the
    card raises naming the chunk. A stack with rope flags but no host rope
    pattern raises."""
    for t in ("llama4", "llama4_text"):
        assert treg.get_family(t)[0].__name__ == "nxdi_tpu_torch.models.llama4.modeling_llama4"
    fam, cfg_cls = treg.get_family("llama4_text")
    cfg = tiny_case()[1]

    def config(**kw):
        return cfg_cls(TorchConfig(**_tc(**kw)), load_config=lambda: dict(cfg))

    refuse_unported(fam, config(mixed_dispatch=True, is_block_kv_layout=True))
    refuse_unported(fam, config(lora_config=dict(max_loras=2, max_lora_rank=4,
                                                 target_modules=["q_proj"])))
    refuse_unported(fam, config(kv_cache_quant=True))
    arch = fam.build_arch(config())
    refuse_speculation(arch, tree=False)
    with pytest.raises(NotImplementedError, match="token-tree speculation.*chunk_size"):
        refuse_speculation(arch, tree=True)
    with pytest.raises(NotImplementedError, match="interleave_moe_layer_step > 1"):
        fam.build_arch(cfg_cls(TorchConfig(**_tc()),
                               load_config=lambda: dict(cfg, interleave_moe_layer_step=2)))
    refused = tbase._chunk_refused(arch)
    assert refused == ["chunk_size 8 (the paged and ragged kernels take no chunk)"]
    assert not tbase._kernel_gate("attn_kernel_enabled", True, False, refused, [])
    with pytest.raises(NotImplementedError, match="chunk_size 8"):
        tbase._kernel_gate("attn_kernel_enabled", True, True, refused, [])
    assert tbase._chunk_refused(dataclasses.replace(arch, chunk_size=None)) == []
    bare = fam.build_arch(config(), rope_pattern=None)
    with pytest.raises(ValueError, match="rope_pattern is unset"):
        tbase.run_decoder_layers(bare, {"use_rope": torch.ones(2, dtype=torch.bool)}, None, None,
                                 None, {"k": None}, torch.zeros((1, 1), dtype=torch.int32), None,
                                 False)


def test_published_widths():
    """Llama-4-Scout builds its arch at the published widths: 40 query heads
    over 8 kv heads of 128 (G 5), 48 layers, every fourth NoPE and unchunked,
    chunks of 8192 on the rest, 16 experts top 1 with a shared expert of
    8192, the temperature's 8192 and 0.1, the llama3-scaled rope table equal
    to the JAX family's."""
    from nxdi_tpu_torch.models.llama4 import modeling_llama4 as tl4

    cfg = tl4.Llama4InferenceConfig(TorchConfig(**_tc(dtype="bfloat16")), **tl4.LLAMA_4_SCOUT)
    a = tl4.build_arch(cfg)
    assert (a.num_layers, a.num_attention_heads, a.num_kv_heads, a.head_dim) == (48, 40, 8, 128)
    assert a.num_attention_heads // a.num_kv_heads == 5 and a.vocab_size == 202048
    assert [a.layer_chunk(i) for i in range(8)] == [8192, 8192, 8192, None] * 2
    assert sum(a.rope_pattern) == 36
    assert (a.moe.num_experts, a.moe.top_k, a.moe.intermediate_size,
            a.moe.shared_expert_intermediate_size) == (16, 1, 8192, 8192)
    assert a.moe.llama4_router and a.rope_interleaved and a.qk_l2norm
    assert (a.floor_scale, a.attn_scale) == (8192.0, 0.1) and a.attn_temperature_tuning
    jfam, jcls = jreg.get_family("llama4_text")
    jcfg = jcls(TpuConfig(**_tc(dtype="bfloat16")), **tl4.LLAMA_4_SCOUT)
    np.testing.assert_array_equal(tl4.build_inv_freq(cfg), jfam.build_inv_freq(jcfg))
