"""The window-sized ring KV cache of the port (``window_sized_kv``): the ring
layout against the JAX package's ``WindowKVLayout`` (bit for bit in f32),
the decode kernels' ring mode (their plain versions) against plain
attention over the ring, ``generate()`` 3x past the window (8) for an
interleaved model (``gemma3_text``: one global layer of three; ``gpt_oss``:
alternating) and a homogeneous one (``mistral``) against HF and the JAX
package's ring app, the contiguous engine on the ring, and every
``window_sized_kv`` refusal.

The prompts (12 tokens) are longer than the window, so the ring keeps only
their last 8 rows, and the two rows of a batch have different lengths (the
keep mask per row). The JAX package's homogeneous ring under
``attn_tkg_kernel_enabled`` hands its window-decode kernel the ring's
wrapped positions as if they were affine and leaves HF greedy once the ring
has wrapped (ROADMAP Queue 3); the port's kernel takes the ring operand and
is pinned to HF there."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nxdi_tpu.generation.hf_adapter import HuggingFaceGenerationAdapter as JaxAdapter
from nxdi_tpu.kvcache import kv_cache as jkv
from nxdi_tpu.utils.accuracy import hf_greedy_generate
from nxdi_tpu_torch.config import KVQuantizationConfig, TorchConfig
from nxdi_tpu_torch.generation.hf_adapter import HuggingFaceGenerationAdapter
from nxdi_tpu_torch.kvcache import kv_cache as tkv
from nxdi_tpu_torch.models import registry as treg
from nxdi_tpu_torch.ops import attention as tattn
from nxdi_tpu_torch.ops.kernels import flash_attention as fa
from nxdi_tpu_torch.runtime.application import refuse_speculation
from nxdi_tpu_torch.runtime.model_wrapper import kv_layout_from_config
from nxdi_tpu_torch.serving import InferenceEngine, SamplingParams, SchedulerConfig

from test_torch_families import _tc, jax_family_app, port_family_app, strategies
from test_torch_slice import fresh_jax_compiles

W = 8
NEW = 3 * W
PROMPTS = np.array([[5, 9, 3, 17, 2, 8, 11, 42, 7, 13, 21, 4],
                    [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8]], dtype=np.int64)
TINY = dict(hidden_size=64, intermediate_size=128, num_attention_heads=4, num_key_value_heads=2,
            head_dim=16, vocab_size=256, max_position_embeddings=256, rms_norm_eps=1e-5,
            rope_theta=10000.0, sliding_window=W, attn_implementation="eager")
# model_type -> (transformers class, config overrides)
CASES = {
    "gemma3_text": ("Gemma3TextForCausalLM", dict(num_hidden_layers=3, sliding_window_pattern=3,
                                              rope_local_base_freq=1000.0)),
    "gpt_oss": ("GptOssForCausalLM", dict(num_hidden_layers=2, intermediate_size=32,
                                          num_local_experts=4, num_experts_per_tok=2,
                                          rope_theta=150000.0)),
    "mistral": ("MistralForCausalLM", dict(num_hidden_layers=2)),
}
RING = dict(window_sized_kv=True, sliding_window=W, batch_size=2)


@pytest.fixture(autouse=True, scope="module")
def _fresh_jax_compiles():
    with fresh_jax_compiles():
        yield


@functools.lru_cache(maxsize=None)
def tiny_case(model_type):
    """(HF model, its config dict, the state dict as numpy)."""
    import transformers

    cls_name, over = CASES[model_type]
    torch.manual_seed(0)
    cfg_obj = getattr(transformers, cls_name.replace("ForCausalLM", "Config"))(**{**TINY, **over})
    model = getattr(transformers, cls_name.replace("TextFor", "For"))(cfg_obj).eval()
    return model, cfg_obj.to_dict(), {k: v.detach().numpy() for k, v in model.state_dict().items()}


@functools.lru_cache(maxsize=None)
def hf_tokens(model_type, rows=2):
    return hf_greedy_generate(tiny_case(model_type)[0], PROMPTS[:rows], NEW)


def _ring_inputs(seed=0, B_cache=3, KV=2, D=4, S=12, routed=False):
    rng = np.random.default_rng(seed)
    k_cache = rng.standard_normal((B_cache, KV, W, D)).astype(np.float32)
    v_cache = rng.standard_normal((B_cache, KV, W, D)).astype(np.float32)
    k_new = rng.standard_normal((2, KV, S, D)).astype(np.float32)
    v_new = rng.standard_normal((2, KV, S, D)).astype(np.float32)
    ci = {"position_ids": np.tile(np.arange(S, dtype=np.int32), (2, 1)),
          "last_token_index": np.array([S - 1, 5], np.int32)}
    if routed:
        ci["seq_ids"] = np.array([2, 0], np.int32)
    return k_cache, v_cache, k_new, v_new, ci


@pytest.mark.parametrize("routed", [False, True])
def test_ring_layout_matches_jax(routed):
    """update (a 12-token prefill over an 8-slot ring: only each row's last
    8 real tokens land, row 1's padding lanes past its last token drop),
    read (the ring positions at a wrapped and an early decode position) and
    commit_rows (two layers; a -1 write position drops), bit for bit against
    the JAX package's WindowKVLayout in f32, lines routed by seq_ids or not."""
    kc, vc, kn, vn, ci = _ring_inputs(routed=routed)
    spec_t = tkv.KVCacheSpec(1, 3, 2, W, 4, dtype="float32")
    spec_j = jkv.KVCacheSpec(1, 3, 2, W, 4, dtype="float32")
    tl = tkv.WindowKVLayout(window=W, route_by_seq_id=routed)
    jl = jkv.WindowKVLayout(window=W, route_by_seq_id=routed)
    tci = {k: torch.from_numpy(v) for k, v in ci.items()}
    jci = {k: jnp.asarray(v) for k, v in ci.items()}
    kt, vt = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    tl.update(kt, vt, torch.from_numpy(kn), torch.from_numpy(vn), tci, spec_t)
    kj, vj = jl.update(jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(kn), jnp.asarray(vn), jci,
                       spec_j)
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    line0 = 2 if routed else 0
    np.testing.assert_array_equal(kt[line0, :, 11 % W].numpy(), kn[0, :, 11])  # the last row
    np.testing.assert_array_equal(kt[line0, :, 0].numpy(), kn[0, :, 8])  # 8 % W
    for pos in ([[19], [6]], [[8], [0]]):
        rci = {"position_ids": np.array(pos, np.int32), **(
            {"seq_ids": ci["seq_ids"]} if routed else {})}
        got = tl.read(kt, vt, {k: torch.from_numpy(v) for k, v in rci.items()}, spec_t)
        want = jl.read(kj, vj, {k: jnp.asarray(v) for k, v in rci.items()}, spec_j)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    rng = np.random.default_rng(1)
    kr = rng.standard_normal((2, 2, 2, 1, 4)).astype(np.float32)
    vr = rng.standard_normal((2, 2, 2, 1, 4)).astype(np.float32)
    cc = {"position_ids": np.array([[19], [6]], np.int32),
          "write_positions": np.array([[19], [-1]], np.int32), **(
              {"seq_ids": ci["seq_ids"]} if routed else {})}
    stack_k = np.stack([kt.numpy(), kt.numpy() + 1])
    stack_v = np.stack([vt.numpy(), vt.numpy() - 1])
    tcache = {"k": torch.from_numpy(stack_k.copy()), "v": torch.from_numpy(stack_v.copy())}
    tl.commit_rows(tcache, torch.from_numpy(kr), torch.from_numpy(vr),
                   {k: torch.from_numpy(v) for k, v in cc.items()}, spec_t)
    jcache = jl.commit_rows({"k": jnp.asarray(stack_k), "v": jnp.asarray(stack_v)},
                            jnp.asarray(kr), jnp.asarray(vr),
                            {k: jnp.asarray(v) for k, v in cc.items()}, spec_j)
    for side in ("k", "v"):
        np.testing.assert_array_equal(tcache[side].numpy(), np.asarray(jcache[side]))
    np.testing.assert_array_equal(tcache["k"][:, line0, :, 19 % W].numpy(), kr[:, 0, :, 0])


@pytest.mark.parametrize("q_pos", [5, 8, 21])
@pytest.mark.parametrize("window", [None, 6])
def test_ring_decode_kernels_match_plain_attention(q_pos, window):
    """The fused (deferred write) and window decode kernels' plain versions
    in ring mode against plain attention over the ring's positions
    (``WindowKVLayout.read``; the fused one's stale slot q % W poisoned as
    the deferred plain path poisons it), before the ring fills and after it
    wraps, with and without a window inside the ring; within 2e-6 in f32.
    ``decode_visible_range`` gives a ring row the scan the kernel does."""
    rng = np.random.default_rng(q_pos)
    B, H, KV, D = 2, 4, 2, 8
    q, kn, vn = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 for s in ((B, H, 1, D), (B, KV, 1, D), (B, KV, 1, D)))
    kc, vc = (torch.from_numpy(rng.standard_normal((B, KV, W, D)).astype(np.float32))
              for _ in range(2))
    pos = torch.tensor([[q_pos], [max(q_pos - 3, 0)]], dtype=torch.int32)
    spec = tkv.KVCacheSpec(1, B, KV, W, D, dtype="float32")
    kk, vv, kv_pos = tkv.WindowKVLayout(window=W).read(kc, vc, {"position_ids": pos}, spec)
    stale = torch.where(kv_pos == pos, torch.full_like(kv_pos, 2 ** 30), kv_pos)
    want = tattn.attention_two_part(q, kk, vv, kn, vn, pos, stale, pos, scale=0.3,
                                    sliding_window=window)
    got = fa.flash_attention_decode_fused(q, kc, vc, kn, vn, pos, kv_pos, scale=0.3,
                                          sliding_window=window, ring=W)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-6, rtol=0)
    got_s = fa.flash_attention_decode_fused_stacked(q, kc[None], vc[None], kn, vn, pos, 0,
                                                    scale=0.3, sliding_window=window, ring=W)
    np.testing.assert_array_equal(got_s.numpy(), got.numpy())
    want_w = tattn.attention_with_positions(q, kk, vv, pos, kv_pos, scale=0.3,
                                            sliding_window=window)
    got_w = fa.flash_attention_decode(q, kc, vc, pos, kv_pos, scale=0.3, sliding_window=window,
                                      ring=W)
    np.testing.assert_allclose(got_w.numpy(), want_w.numpy(), atol=2e-6, rtol=0)
    lo, hi = fa.decode_visible_range(pos[:, 0], None, W, fresh=True, window=window, ring=W)
    assert lo.tolist() == [0, 0] and hi.tolist() == [min(W, p) for p in pos[:, 0].tolist()]
    with pytest.raises(ValueError, match="a ring of 4 slots over a cache of 8"):
        fa.flash_attention_decode(q, kc, vc, pos, kv_pos, ring=4)


@pytest.mark.parametrize("model_type", sorted(CASES))
def test_ring_generate_matches_hf_and_jax(model_type):
    """generate() 3x past the window on the ring, the attention kernel flags
    on: equal to HF greedy and to the JAX package's ring app, the cache
    window-sized (an interleaved model: full-length k / v for its global
    layers only, a ring stack for the rest). The homogeneous ring runs the
    window-decode kernel's ring mode (its plain version here): equal to HF,
    where the JAX app under the same flag leaves HF (its kernel takes the
    wrapped positions as affine) and equals HF with the flag off."""
    _, cfg, sd = tiny_case(model_type)
    tapp = port_family_app(model_type, cfg, sd=sd, **RING)
    got = HuggingFaceGenerationAdapter(tapp).generate(PROMPTS, max_new_tokens=NEW)
    np.testing.assert_array_equal(got, hf_tokens(model_type))
    shapes = {k: tuple(v.shape) for k, v in tapp.kv_cache.items()}
    seen = strategies(tapp)["token_generation_model"]
    if model_type == "mistral":
        assert shapes == {"k": (2, 2, 2, W, 16), "v": (2, 2, 2, W, 16)}
        assert seen == {"tkg_kernel"}
        jflag = jax_family_app(model_type, cfg, sd, **RING)
        assert not np.array_equal(JaxAdapter(jflag).generate(PROMPTS, max_new_tokens=NEW),
                                  hf_tokens(model_type))
        japp = jax_family_app(model_type, cfg, sd, **RING, attn_tkg_kernel_enabled=False)
    else:
        n_full = 1
        n_win = cfg["num_hidden_layers"] - n_full
        assert shapes["k"] == (n_full, 2, 2, 64, 16) and shapes["k_win"] == (n_win, 2, 2, W, 16)
        assert seen <= {"tkg_two_part_xla", "moe_sparse_per_expert"}
        japp = jax_family_app(model_type, cfg, sd, **RING)
    np.testing.assert_array_equal(JaxAdapter(japp).generate(PROMPTS, max_new_tokens=NEW), got)


def _drive(engine, prompts, budgets, arrivals):
    reqs, outs, step = [None] * len(prompts), [], 0
    while engine.has_work() or any(r is None for r in reqs):
        for i, a in enumerate(arrivals):
            if reqs[i] is None and a <= step:
                reqs[i] = engine.add_request(prompts[i], SamplingParams(max_new_tokens=budgets[i]))
        outs += engine.step()
        step += 1
        assert step < 300, "engine failed to drain"
    got = {o.request_id: o.token_ids for o in outs}
    return [got[r.request_id] for r in reqs]


@pytest.mark.parametrize("model_type,mode", [("gemma3_text", {}),
                                             ("mistral", dict(device_loop=True))])
def test_ring_contiguous_engine_matches_hf(model_type, mode):
    """The contiguous continuous-batching engine on the ring (each request's
    ring line routed by seq_ids; a third request arriving mid-stream takes a
    freed line): every stream equals HF greedy past the window, 1-step on
    the interleaved model, through the device loop on the homogeneous one."""
    hf, cfg, sd = tiny_case(model_type)
    prompts = [PROMPTS[0].tolist(), PROMPTS[1, :10].tolist(), PROMPTS[0, 2:].tolist()]
    budgets = [2 * W + 3, 2 * W, W + 5]
    app = port_family_app(model_type, cfg, sd=sd, **RING, is_continuous_batching=True,
                          ctx_batch_size=2, tkg_batch_size=2, kv_cache_batch_size=2, **mode)
    engine = InferenceEngine(app, SchedulerConfig(num_slots=2, max_prefills_per_step=2))
    streams = _drive(engine, prompts, budgets, [0, 0, 3])
    for p, s, n in zip(prompts, streams, budgets):
        assert s == hf_greedy_generate(hf, np.array([p]), n)[0, len(p):].tolist()


@pytest.mark.parametrize("kw,match", [
    (dict(window_sized_kv=True), "needs tpu_config.sliding_window"),
    (dict(window_sized_kv=True, sliding_window=128, seq_len=64), "cannot exceed seq_len"),
    (dict(window_sized_kv=True, sliding_window=8, is_block_kv_layout=True, pa_num_blocks=8,
          pa_block_size=8), "paged/medusa/prefix modes"),
    (dict(window_sized_kv=True, sliding_window=8, is_medusa=True, num_medusa_heads=2,
          medusa_speculation_length=4), "paged/medusa/prefix modes"),
    (dict(window_sized_kv=True, sliding_window=8, is_block_kv_layout=True, pa_num_blocks=8,
          pa_block_size=8, is_prefix_caching=True), "paged/medusa/prefix modes"),
    (dict(window_sized_kv=True, sliding_window=8, is_block_kv_layout=True, pa_num_blocks=8,
          pa_block_size=8, chunked_prefill_config=dict(chunk_size=8)),
     "paged/medusa/prefix modes"),
    (dict(window_sized_kv=True, sliding_window=8, speculation_length=3, seq_len=10),
     "ring slots, which exceeds seq_len"),
    (dict(window_sized_kv=True, sliding_window=8, mlp_kernel_enabled=True),
     "not supported with window_sized_kv"),
    (dict(window_sized_kv=True, sliding_window=8, fused_qkv=True, qkv_kernel_enabled=True),
     "not supported with window_sized_kv"),
])
def test_window_sized_kv_config_refusals(kw, match):
    """Each of the JAX package's window_sized_kv refusals raises in the port,
    in its words; linear speculation's over-provisioned ring counts its
    slots."""
    with pytest.raises(ValueError, match=match):
        TorchConfig(**kw)
    assert TorchConfig(window_sized_kv=True, sliding_window=8, speculation_length=3,
                       seq_len=64).window_ring_slots == 12


def test_ring_layout_refusals():
    """The layout refuses a scaled fp8 store on the ring (the JAX message),
    a ring on a model with no sliding-window layer and a ring shorter than
    the model's window; a windowed model speculates in a chain and refuses
    a token tree at app build, naming its window."""
    _, cfg, _ = tiny_case("mistral")
    fam, cfg_cls = treg.get_family("mistral")

    def layout(model_cfg, **kw):
        c = cfg_cls(TorchConfig(**_tc(**{**RING, **kw})), load_config=lambda: dict(model_cfg))
        return kv_layout_from_config(c.tpu_config, fam.build_arch(c))

    assert isinstance(layout(cfg), tkv.WindowKVLayout)
    with pytest.raises(NotImplementedError, match="scaled fp8 KV is not wired into the window"):
        layout(cfg, kv_quant_config=KVQuantizationConfig(scale_mode="per_tensor", k_scale=2.0,
                                                         v_scale=2.0))
    with pytest.raises(ValueError, match="no layer of this model uses sliding-window"):
        layout({**cfg, "sliding_window": None})
    with pytest.raises(ValueError, match="shorter than the model's sliding window"):
        layout({**cfg, "sliding_window": 16})
    arch = fam.build_arch(cfg_cls(TorchConfig(**_tc(**RING)), load_config=lambda: dict(cfg)))
    refuse_speculation(arch, tree=False)
    with pytest.raises(NotImplementedError, match="token-tree speculation.*sliding_window"):
        refuse_speculation(arch, tree=True)
