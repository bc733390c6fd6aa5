"""MiMo-V2 in the port (``nxdi_tpu_torch/models/mimo_v2/``) held against the
JAX package's family on the CPU, at the JAX package's test config (hidden
64, four layers: full, window, full, window; the first dense, the rest MoE;
q / k 16 against v 8 on the full layers; a window of 4) in float32: prefill
logits within 1e-5, 16 greedy tokens equal to the JAX app's and to a plain
torch statement of the architecture; the converter leaf for leaf; the
window stack on its ring against the full cache; continuous batching on
shuffled cache lines; standard speculation at spec_len 3; the refusals of
both packages; and the attention kernels' gate on a value width apart from
q / k's."""

import numpy as np
import pytest
import torch

import jax

from nxdi_tpu.config import LoraServingConfig as JaxLora
from nxdi_tpu.config import OnDeviceSamplingConfig as JaxODSC
from nxdi_tpu.config import TpuConfig
from nxdi_tpu.generation.hf_adapter import HuggingFaceGenerationAdapter as JaxAdapter
from nxdi_tpu.models.mimo_v2 import modeling_mimo_v2 as jmv
from nxdi_tpu.speculation import StandardSpecCausalLM as JaxStandard
from nxdi_tpu_torch.config import LoraServingConfig, OnDeviceSamplingConfig, TorchConfig
from nxdi_tpu_torch.generation.hf_adapter import HuggingFaceGenerationAdapter
from nxdi_tpu_torch.models import base as tbase
from nxdi_tpu_torch.models.convert import from_jax_params
from nxdi_tpu_torch.models.mimo_v2 import modeling_mimo_v2 as tmv
from nxdi_tpu_torch.runtime.model_wrapper import TAG_SPECULATION
from nxdi_tpu_torch.speculation import StandardSpecCausalLM

from test_torch_slice import fresh_jax_compiles

LOGIT_TOL = 1e-5
NEW = 16
PROMPT = np.array([[5, 9, 3, 17, 2, 8, 11, 42], [7, 13, 21, 4, 33, 6, 19, 2]], dtype=np.int64)
P0, P1 = [5, 9, 3, 17, 2, 8, 11, 42], [7, 13, 21, 4, 33]
# the JAX package's test config (tests/integration/test_mimo_v2.py)
CFG = dict(
    model_type="mimo_v2", hidden_size=64, num_hidden_layers=4,
    hybrid_layer_pattern=[0, 1, 0, 1], moe_layer_freq=[0, 1, 1, 1],
    num_attention_heads=4, num_key_value_heads=2, head_dim=16, v_head_dim=8,
    swa_num_attention_heads=8, swa_num_key_value_heads=4, swa_head_dim=8, swa_v_head_dim=8,
    sliding_window=4, swa_rope_theta=5000.0, rope_theta=10000.0, partial_rotary_factor=0.5,
    n_routed_experts=4, num_experts_per_tok=2, moe_intermediate_size=32, intermediate_size=48,
    scoring_func="sigmoid", norm_topk_prob=True, vocab_size=256, max_position_embeddings=128,
    layernorm_epsilon=1e-6, rms_norm_eps=1e-6, hidden_act="silu", tie_word_embeddings=False,
)
FLAGS = dict(attn_kernel_enabled=True, attn_tkg_kernel_enabled=True)
CB = dict(is_continuous_batching=True, ctx_batch_size=1, tkg_batch_size=2, kv_cache_batch_size=2)


@pytest.fixture(autouse=True, scope="module")
def _fresh_jax_compiles():
    with fresh_jax_compiles():
        yield


def random_sd(seed):
    """A random HF-layout checkpoint of ``CFG`` (numpy float32)."""
    rng = np.random.default_rng(seed)
    H, V = CFG["hidden_size"], CFG["vocab_size"]
    E, Im, Id = CFG["n_routed_experts"], CFG["moe_intermediate_size"], CFG["intermediate_size"]

    def w(*shape, scale=0.05):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    sd = {"model.embed_tokens.weight": w(V, H), "model.norm.weight": 1.0 + w(H, scale=0.02),
          "lm_head.weight": w(V, H)}
    for i in range(CFG["num_hidden_layers"]):
        swa = CFG["hybrid_layer_pattern"][i] == 1
        pre = "swa_" if swa else ""
        NH, NKV = CFG[pre + "num_attention_heads"], CFG[pre + "num_key_value_heads"]
        D, Dv = CFG[pre + "head_dim"], CFG[pre + "v_head_dim"]
        p = f"model.layers.{i}."
        sd[p + "input_layernorm.weight"] = 1.0 + w(H, scale=0.02)
        sd[p + "post_attention_layernorm.weight"] = 1.0 + w(H, scale=0.02)
        sd[p + "self_attn.q_proj.weight"] = w(NH * D, H)
        sd[p + "self_attn.k_proj.weight"] = w(NKV * D, H)
        sd[p + "self_attn.v_proj.weight"] = w(NKV * Dv, H)
        sd[p + "self_attn.o_proj.weight"] = w(H, NH * Dv)
        if CFG["moe_layer_freq"][i]:
            sd[p + "mlp.gate.weight"] = w(E, H)
            for j in range(E):
                q = f"{p}mlp.experts.{j}."
                sd[q + "gate_proj.weight"], sd[q + "up_proj.weight"] = w(Im, H), w(Im, H)
                sd[q + "down_proj.weight"] = w(H, Im)
        else:
            for name, shape in (("gate_proj", (Id, H)), ("up_proj", (Id, H)),
                                ("down_proj", (H, Id))):
                sd[p + f"mlp.{name}.weight"] = w(*shape)
    return sd


def golden_greedy(sd, prompt, n_new):
    """Greedy tokens of a plain torch statement of the architecture, no
    cache: the full prefix re-run for every token."""
    t = {k: torch.tensor(v) for k, v in sd.items()}
    eps, prf = CFG["rms_norm_eps"], CFG["partial_rotary_factor"]

    def rms(x, w):
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w

    def logits(ids):
        B, S = ids.shape
        x = t["model.embed_tokens.weight"][torch.tensor(ids)]
        qp, kp = torch.arange(S)[:, None], torch.arange(S)[None, :]
        for i in range(CFG["num_hidden_layers"]):
            swa = CFG["hybrid_layer_pattern"][i] == 1
            pre = "swa_" if swa else ""
            NH, NKV = CFG[pre + "num_attention_heads"], CFG[pre + "num_key_value_heads"]
            D, Dv, theta = CFG[pre + "head_dim"], CFG[pre + "v_head_dim"], CFG[pre + "rope_theta"]
            rd = int(D * prf) - int(D * prf) % 2
            inv = 1.0 / (theta ** (torch.arange(0, rd, 2, dtype=torch.float32) / rd))
            fr = torch.arange(S, dtype=torch.float32)[:, None] * inv[None]
            cos, sin = torch.cat([fr, fr], -1).cos(), torch.cat([fr, fr], -1).sin()
            mask = kp <= qp
            if swa:
                mask = mask & (kp > qp - CFG["sliding_window"])
            p = f"model.layers.{i}."
            y = rms(x, t[p + "input_layernorm.weight"])
            q = (y @ t[p + "self_attn.q_proj.weight"].T).view(B, S, NH, D).transpose(1, 2)
            k = (y @ t[p + "self_attn.k_proj.weight"].T).view(B, S, NKV, D).transpose(1, 2)
            v = (y @ t[p + "self_attn.v_proj.weight"].T).view(B, S, NKV, Dv).transpose(1, 2)

            def rot(z):
                zr, r1, r2 = z[..., :rd], z[..., :rd // 2], z[..., rd // 2:rd]
                return torch.cat([zr * cos + torch.cat([-r2, r1], -1) * sin, z[..., rd:]], -1)

            q, k = rot(q), rot(k).repeat_interleave(NH // NKV, 1)
            s = (q @ k.transpose(-1, -2)) * D ** -0.5
            ctx = torch.softmax(s.masked_fill(~mask, float("-inf")), -1) @ v.repeat_interleave(
                NH // NKV, 1)
            x = x + ctx.transpose(1, 2).reshape(B, S, NH * Dv) @ t[p + "self_attn.o_proj.weight"].T
            y = rms(x, t[p + "post_attention_layernorm.weight"])
            if CFG["moe_layer_freq"][i]:
                flat = y.reshape(-1, y.shape[-1])
                scores = torch.sigmoid(flat @ t[p + "mlp.gate.weight"].T)
                wts, idx = torch.topk(scores, CFG["num_experts_per_tok"], dim=-1)
                wts = wts / wts.sum(-1, keepdim=True)
                out = torch.zeros_like(flat)
                for j in range(CFG["n_routed_experts"]):
                    e = f"{p}mlp.experts.{j}."
                    h = torch.nn.functional.silu(flat @ t[e + "gate_proj.weight"].T) * (
                        flat @ t[e + "up_proj.weight"].T)
                    out += (h @ t[e + "down_proj.weight"].T) * (wts * (idx == j)).sum(-1)[:, None]
                x = x + out.reshape(x.shape)
            else:
                ff = torch.nn.functional.silu(y @ t[p + "mlp.gate_proj.weight"].T) * (
                    y @ t[p + "mlp.up_proj.weight"].T)
                x = x + ff @ t[p + "mlp.down_proj.weight"].T
        return rms(x, t["model.norm.weight"]) @ t["lm_head.weight"].T

    ids = np.asarray(prompt)
    for _ in range(n_new):
        nxt = logits(ids)[:, -1].argmax(-1).numpy()[:, None]
        ids = np.concatenate([ids, nxt], axis=1)
    return ids[:, np.asarray(prompt).shape[1]:]


def _tc(**kw):
    d = dict(tp_degree=1, seq_len=64, max_context_length=32, batch_size=2, dtype="float32",
             skip_warmup=True, output_logits=True)
    d.update(kw)
    return d


def jax_app(sd, **kw):
    cfg = jmv.MiMoV2InferenceConfig(TpuConfig(on_device_sampling_config=JaxODSC(), **_tc(**kw)),
                                    load_config=lambda: dict(CFG))
    app = jmv.MiMoV2ForCausalLM("<memory>", cfg)
    app.get_state_dict = lambda: sd
    app.load()
    return app


def port_app(sd=None, params=None, **kw):
    cfg = tmv.MiMoV2InferenceConfig(
        TorchConfig(on_device_sampling_config=OnDeviceSamplingConfig(), **_tc(**kw)),
        load_config=lambda: dict(CFG))
    app = tmv.MiMoV2ForCausalLM("<memory>", cfg, device="cpu")
    app.get_state_dict = lambda: sd
    if params is not None:
        app.build_params = lambda: params
    app.load()
    return app


def _np(lg):
    return lg.numpy() if isinstance(lg, torch.Tensor) else np.asarray(jax.device_get(lg))


def _logits(app, prompt):
    B, S = prompt.shape
    out = app.forward(prompt.astype(np.int32), np.tile(np.arange(S, dtype=np.int32), (B, 1)),
                      last_token_index=np.full((B,), S - 1, np.int32))
    return _np(out["logits"])


def logged(app, drive):
    """``drive()``'s result and the logits of every dispatch it sent through
    ``app.forward``."""
    logs, inner = [], app.forward

    def fwd(*a, **k):
        out = inner(*a, **k)
        logs.append(_np(out["logits"]))
        return out

    app.forward = fwd
    try:
        return drive(), logs
    finally:
        del app.forward


def assert_logits_close(got, want):
    """Dispatch for dispatch, the same shapes and logits within LOGIT_TOL."""
    assert len(got) == len(want) > 0
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (i, g.shape, w.shape)
        np.testing.assert_allclose(g, w, atol=LOGIT_TOL, rtol=0, err_msg=f"dispatch {i}")


@pytest.fixture(scope="module")
def sd():
    return random_sd(0)


@pytest.fixture(scope="module")
def golden(sd):
    return golden_greedy(sd, PROMPT, NEW)


@pytest.fixture(scope="module")
def jax_static(sd):
    app = jax_app(sd)
    out, logs = logged(app, lambda: JaxAdapter(app).generate(PROMPT, max_new_tokens=NEW))
    return app, _logits(app, PROMPT), out, logs


def test_mimo_v2_matches_jax(sd, golden, jax_static):
    """The port's app (the attention kernel flags on: the window layers run
    the kernels' plain versions, the full layers, whose values are narrower,
    plain attention, the JAX rule) against the JAX app on the converter's
    params: every dispatch's logits within 1e-5, tokens equal to the JAX
    app's and the golden."""
    japp, jlogits, jout, jlogs = jax_static
    tapp = port_app(sd, **FLAGS)
    np.testing.assert_allclose(_logits(tapp, PROMPT), jlogits, atol=LOGIT_TOL, rtol=0)
    got, logs = logged(tapp, lambda: HuggingFaceGenerationAdapter(tapp).generate(
        PROMPT, max_new_tokens=NEW))
    assert_logits_close(logs, jlogs)
    np.testing.assert_array_equal(got, jout)
    np.testing.assert_array_equal(got[:, PROMPT.shape[1]:], golden)
    seen = {tag: {s for ss in w.attention_strategies.values() for s in ss}
            for tag, w in tapp.models.items()}
    assert seen["context_encoding_model"] >= {"cte_xla", "cte_flash_kernel"}
    assert "tkg_two_part_xla" in seen["token_generation_model"]


def test_mimo_v2_converter_matches_jax(sd, jax_static):
    """The port's converter gives the JAX app's params leaf for leaf: the
    segments in depth order, the V and O projections at the value width."""
    got = tmv.convert_hf_state_dict(
        {k: torch.from_numpy(v) for k, v in sd.items()},
        tmv.MiMoV2InferenceConfig(TorchConfig(**_tc()), load_config=lambda: dict(CFG)))
    want = from_jax_params(jax.device_get(jax_static[0].params))

    def leaves(tree, path=()):
        if isinstance(tree, (list, dict)):
            items = tree.items() if isinstance(tree, dict) else enumerate(tree)
            for k, v in items:
                yield from leaves(v, path + (k,))
        else:
            yield path, tree

    want, got = dict(leaves(want)), dict(leaves(got))
    assert got.keys() == want.keys()
    assert len(got) > 20
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=str(k))
    assert tuple(got[("segments", 0, "attn", "v_proj", "w")].shape) == (1, 64, 2 * 8)
    assert tuple(got[("segments", 0, "attn", "o_proj", "w")].shape) == (1, 4 * 8, 64)


def test_mimo_v2_ring_against_full_cache(sd, golden):
    """``window_sized_kv`` shrinks only the window stack, to a ring of the
    window's slots; every dispatch's logits within 1e-5 of the JAX ring
    app's, tokens equal to its, the full cache's and the golden."""
    ring = dict(window_sized_kv=True, sliding_window=CFG["sliding_window"])
    japp = jax_app(sd, **ring)
    tapp = port_app(sd, **ring)
    assert tuple(tapp.kv_cache["k_swa"].shape) == (2, 2, 4, 4, 8)
    assert tuple(tapp.kv_cache["k"].shape) == (2, 2, 2, 64, 16)
    assert tuple(tapp.kv_cache["v"].shape) == (2, 2, 2, 64, 8)
    want, jlogs = logged(japp, lambda: JaxAdapter(japp).generate(PROMPT, max_new_tokens=NEW))
    got, logs = logged(tapp, lambda: HuggingFaceGenerationAdapter(tapp).generate(
        PROMPT, max_new_tokens=NEW))
    assert_logits_close(logs, jlogs)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, PROMPT.shape[1]:], golden)


def interleaved(app, n_new=NEW, sid0=1, sid1=0):
    """The JAX package's continuous-batching drive: prefill A into line
    ``sid0``, decode it alone, prefill B into line ``sid1``, then decode both
    (row 0 -> line 1: rows and lines shuffled) until B too has ``n_new``
    tokens. Returns both token lists and every dispatch's logits."""
    logs = []

    def forward(*a, **k):
        out = app.forward(*a, **k)
        logs.append(_np(out["logits"]))
        return out

    def prefill(prompt, sid):
        S = len(prompt)
        out = forward(np.asarray([prompt], np.int32), np.arange(S, dtype=np.int32)[None],
                      last_token_index=np.array([S - 1], np.int32),
                      seq_ids=np.array([sid], np.int32))
        return int(np.asarray(out["tokens"])[0, 0])

    got0, pos0 = [prefill(P0, sid0)], len(P0)
    for _ in range(3):
        out = forward(np.array([[got0[-1]]], np.int32), np.array([[pos0]], np.int32),
                      seq_ids=np.array([sid0], np.int32))
        got0.append(int(np.asarray(out["tokens"])[0, 0]))
        pos0 += 1
    got1, pos1 = [prefill(P1, sid1)], len(P1)
    while len(got1) < n_new:
        out = forward(np.array([[got0[-1]], [got1[-1]]], np.int32),
                      np.array([[pos0], [pos1]], np.int32),
                      seq_ids=np.array([sid0, sid1], np.int32))
        toks = np.asarray(out["tokens"])[:, 0]
        got0.append(int(toks[0]))
        got1.append(int(toks[1]))
        pos0, pos1 = pos0 + 1, pos1 + 1
    return got0, got1, logs


def test_mimo_v2_continuous_batching_shuffled(sd):
    """Interleaved prefills into shuffled cache lines: every dispatch's logits
    within 1e-5 of the JAX app's run, both streams (16 tokens and more)
    equal to its and to the golden of each prompt alone."""
    *want, jlogs = interleaved(jax_app(sd, **CB))
    *got, logs = interleaved(port_app(sd, **CB))
    assert_logits_close(logs, jlogs)
    assert got == want
    for prompt, toks in zip((P0, P1), got):
        assert len(toks) >= NEW
        np.testing.assert_array_equal(toks, golden_greedy(sd, np.array([prompt]), len(toks))[0])


def test_mimo_v2_standard_speculation(sd):
    """Standard speculation at spec_len 3 over two MiMo apps (a draft of other
    weights: partial accepts): the family's app grafted under the verify,
    which runs the segment walk; tokens and every window's accepted count
    equal the JAX package's, tokens the golden's."""
    d_sd = random_sd(7)
    kw = dict(batch_size=1, output_logits=False)
    japp = JaxStandard("<t>", jmv.MiMoV2InferenceConfig(
        TpuConfig(on_device_sampling_config=JaxODSC(), speculation_length=3, **_tc(**kw)),
        load_config=lambda: dict(CFG)), "<d>", jmv.MiMoV2InferenceConfig(
        TpuConfig(on_device_sampling_config=JaxODSC(), **_tc(**kw)),
        load_config=lambda: dict(CFG)), model_family=jmv)
    japp.target.get_state_dict, japp.draft.get_state_dict = (lambda: sd), (lambda: d_sd)
    japp.load()
    tapp = StandardSpecCausalLM("<t>", tmv.MiMoV2InferenceConfig(
        TorchConfig(on_device_sampling_config=OnDeviceSamplingConfig(), speculation_length=3,
                    **_tc(**kw)), load_config=lambda: dict(CFG)), "<d>", tmv.MiMoV2InferenceConfig(
        TorchConfig(on_device_sampling_config=OnDeviceSamplingConfig(), **_tc(**kw)),
        load_config=lambda: dict(CFG)), model_family=tmv, device="cpu")
    tapp.target.get_state_dict, tapp.draft.get_state_dict = (lambda: sd), (lambda: d_sd)
    tapp.load()
    logs = []
    for app in (japp, tapp):
        log, inner = [], app.forward

        def fwd(ids, pos, inner=inner, log=log, **k):
            out = inner(ids, pos, **k)
            if np.asarray(ids).shape[1] == 1:
                log.append(int(np.asarray(out["counts"])[0]))
            return out

        app.forward = fwd
        logs.append(log)
    prompt = PROMPT[:1]
    want = JaxAdapter(japp).generate(prompt, max_new_tokens=NEW)
    got = HuggingFaceGenerationAdapter(tapp).generate(prompt, max_new_tokens=NEW)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, prompt.shape[1]:], golden_greedy(sd, prompt, NEW))
    assert logs[1] == logs[0] and len(logs[1]) > 1
    assert any(c < 4 for c in logs[1])  # the draft's other weights reject some tokens
    assert tapp.target.models[TAG_SPECULATION].forward_fn is tmv.causal_lm_forward


# (flag, expected message fragment) for both packages; the port's own last
REFUSALS = {
    "async": (dict(async_mode=True), "async"),
    "paged": (dict(is_block_kv_layout=True, pa_num_blocks=16, pa_block_size=16), "paged"),
    "fused_spec": (dict(speculation_length=2, enable_fused_speculation=True), "fused/medusa"),
    "medusa": (dict(is_medusa=True, num_medusa_heads=2), "fused/medusa"),
    "prefix": (dict(is_block_kv_layout=True, pa_num_blocks=16, pa_block_size=16,
                    is_prefix_caching=True), "paged"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS) + ["lora", "multistep", "device_loop"])
def test_mimo_v2_refusals(sd, case):
    """Each refusal of the JAX app raises in the port too, naming the path;
    the port also refuses the K-step and loop decode (the JAX app would run
    its one-step forward there)."""
    if case == "lora":
        kw, msg = {}, "LoRA"
        with pytest.raises(NotImplementedError, match=msg):
            jmv.MiMoV2ForCausalLM("<m>", jmv.MiMoV2InferenceConfig(
                TpuConfig(lora_config=JaxLora(max_loras=1), **_tc()),
                load_config=lambda: dict(CFG)))
        kw = dict(lora_config=LoraServingConfig(max_loras=1))
    elif case in REFUSALS:
        kw, msg = REFUSALS[case]
        with pytest.raises(NotImplementedError, match=msg):
            jmv.MiMoV2ForCausalLM("<m>", jmv.MiMoV2InferenceConfig(
                TpuConfig(**_tc(**kw)), load_config=lambda: dict(CFG)))
    else:
        kw = (dict(decode_steps_per_dispatch=4) if case == "multistep"
              else dict(device_loop=True))
        msg = "multi-step or device-loop"
    with pytest.raises(NotImplementedError, match=msg):
        tmv.MiMoV2ForCausalLM("<m>", tmv.MiMoV2InferenceConfig(
            TorchConfig(on_device_sampling_config=OnDeviceSamplingConfig(), **_tc(**kw)),
            load_config=lambda: dict(CFG)), device="cpu")


def test_v_head_dim_gate():
    """On the card an enabled attention-kernel flag on a value width apart
    from q / k's raises, naming ``v_head_dim``; the window arch (equal
    widths) passes; the commit kernel's shapes take the two widths."""
    arch = tmv.build_arch(tmv.MiMoV2InferenceConfig(TorchConfig(**_tc(**FLAGS)),
                                                    load_config=lambda: dict(CFG)))
    assert arch.full.v_head_dim == 8 and arch.swa.v_head_dim is None
    with pytest.raises(NotImplementedError, match="v_head_dim 8 apart from head_dim 16"):
        tbase._kernel_gate("attn_kernel_enabled", True, True,
                           tbase._kernel_refusals(arch.full), [])
    assert not tbase._kernel_gate("attn_kernel_enabled", True, False,
                                  tbase._kernel_refusals(arch.full), [])
    assert tbase._kernel_gate("attn_kernel_enabled", True, True,
                              tbase._kernel_refusals(arch.swa), [])
    spec = arch.full.kv_cache_spec(2, 64)
    assert spec.shape[-1] == 16 and spec.shape_v[-1] == 8
