"""Speculation on the family switches, the window-sized rings and MLA, part
2 (part 1, ``test_torch_family_spec.py``, holds the helpers): EAGLE and
EAGLE3 chains on family targets (an interleaved ring's among them, whose
EAGLE3 features come through the interleaved stack's layer outputs),
Medusa chains and a tree on family targets, MLA targets with a dense draft
and with an MLA draft on a segmented stack, the refusals kept (each raised
by both packages where the JAX package raises it), and a coverage test:
every switch ``family_switches`` can name builds and runs every
speculation app at least once.

EAGLE drafts are synthetic 1-layer checkpoints at the target's width (the
JAX package's test drafts: no input norm on the layer, no final norm, the
target's embedding and lm_head borrowed); a random draft is seldom
accepted, so these windows mostly check the features and the draft's own
path, and the verify rows past the first are held by part 1's perfect
drafts. Medusa's heads read the family's own final norm in the port and a
plain RMSNorm in the JAX package (ROADMAP Queue 3): on a Gemma-norm family
the proposals differ, the emitted tokens are the target's greedy tokens in
both."""

import functools

import numpy as np
import pytest
import torch

from nxdi_tpu.config import OnDeviceSamplingConfig as JaxODSC
from nxdi_tpu.config import SpeculationConfig as JaxSpecConfig
from nxdi_tpu.config import TpuConfig
from nxdi_tpu.models import llama_eagle as jle
from nxdi_tpu.speculation import EagleSpecCausalLM as JaxEagle
from nxdi_tpu.speculation import MedusaCausalLM as JaxMedusa
from nxdi_tpu_torch.config import OnDeviceSamplingConfig, SpeculationConfig, TorchConfig
from nxdi_tpu_torch.models import llama_eagle as tle
from nxdi_tpu_torch.runtime.application import family_switches, local_rope
from nxdi_tpu_torch.runtime.model_wrapper import TAG_MEDUSA_SPECULATION
from nxdi_tpu_torch.speculation import EagleSpecCausalLM, MedusaCausalLM

from test_torch_family_paths import ALL_CASES
from test_torch_family_spec import (
    CASE_KW,
    _torch_sd,
    case_kw,
    common,
    config,
    generate,
    hf_tokens,
    port_greedy,
    spec_pair,
    target_app,
    tiny_hf,
)
from test_torch_slice import fresh_jax_compiles

PROMPT = np.array([[5, 9, 3, 17, 2, 8, 11, 42, 7, 13, 21, 4]], dtype=np.int64)
NEW = 12
DRAFT_VOCAB = 128
MC_TREE = [[0], [1], [0, 0], [0, 1], [1, 0]]


@pytest.fixture(autouse=True, scope="module")
def _fresh_jax_compiles():
    with fresh_jax_compiles():
        yield


def _dims(case):
    arch = target_app(case).models["token_generation_model"].arch
    return arch.hidden_size, arch.vocab_size, arch.num_layers


@functools.lru_cache(maxsize=None)
def eagle_draft(case, eagle3=False, seed=3):
    """(HF config dict, state dict) of a synthetic 1-layer EAGLE draft at
    ``case``'s width: a Llama layer without its input norm, ``fc`` over
    [embedding | feature], no final norm; its embedding (and, at the
    target's vocabulary, its lm_head) the target's, borrowed by the app
    unless the target's checkpoint names them otherwise (then the draft
    carries the target's own). EAGLE3 adds ``fc_features`` over the
    target's aux layers, a reduced-vocabulary lm_head and ``d2t``."""
    H, V, L = _dims(case)
    rng = np.random.default_rng(seed)
    cfg = dict(hidden_size=H, intermediate_size=128, num_hidden_layers=1, num_attention_heads=4,
               num_key_value_heads=2, vocab_size=DRAFT_VOCAB if eagle3 else V,
               max_position_embeddings=256, rms_norm_eps=1e-5, rope_theta=10000.0,
               tie_word_embeddings=False, model_type="llama")
    D = H // 4

    def w(*shape, s=0.05):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    p = "model.layers.0."
    sd = {p + "self_attn.q_proj.weight": w(4 * D, H), p + "self_attn.k_proj.weight": w(2 * D, H),
          p + "self_attn.v_proj.weight": w(2 * D, H), p + "self_attn.o_proj.weight": w(H, 4 * D),
          p + "mlp.gate_proj.weight": w(128, H), p + "mlp.up_proj.weight": w(128, H),
          p + "mlp.down_proj.weight": w(H, 128),
          p + "post_attention_layernorm.weight": np.ones((H,), np.float32),
          "fc.weight": w(H, 2 * H), "fc.bias": w(H, s=0.01)}
    t_sd = tiny_hf(case)[3]
    if "model.embed_tokens.weight" not in t_sd and "embed_tokens.weight" not in t_sd:
        emb = target_app(case).params["embed_tokens"].numpy()[:V]
        sd["embed_tokens.weight"] = emb
        if not eagle3:
            sd["lm_head.weight"] = w(V, H)
    if eagle3:
        aux = len(tle.eagle3_aux_indices_default(L))
        sd["fc_features.weight"] = w(H, aux * H)
        sd["lm_head.weight"] = w(DRAFT_VOCAB, H)
        sd["d2t"] = rng.choice(V, size=DRAFT_VOCAB, replace=False).astype(np.int32)
    return cfg, sd


def eagle_pair(case, eagle3=False, jax_side=True, spec_len=3, tree=None, **kw):
    """The JAX package's EAGLE app and the port's on ``case``'s target (the
    port's alone with ``jax_side=False``; ``tree``: a token tree's config)."""
    model_type, _, cfg, sd = tiny_hf(case)
    dcfg, dsd = eagle_draft(case, eagle3)
    apps = []
    for side in ((True, False) if jax_side else (False,)):
        Spec, Tc, Odsc, le, App = ((JaxSpecConfig, TpuConfig, JaxODSC, jle, JaxEagle) if side
                                   else (SpeculationConfig, TorchConfig, OnDeviceSamplingConfig,
                                         tle, EagleSpecCausalLM))
        spec = Spec(speculation_length=spec_len, enable_eagle_speculation=True, is_eagle3=eagle3)
        fam, tcfg = config(side, model_type, cfg, speculation_config=spec,
                           token_tree_config=tree, **case_kw(case, **kw))
        d_cfg = le.LlamaEagleInferenceConfig(
            Tc(on_device_sampling_config=Odsc(), is_eagle3=eagle3, **common(**kw)),
            load_config=lambda: dict(dcfg))
        t_sd, d_sd = (sd, dsd) if side else (_torch_sd(sd), _torch_sd(dsd))

        class A(App):
            def get_state_dict(self):
                return t_sd

            def get_draft_state_dict(self):
                return d_sd

        app = A("<t>", tcfg, "<d>", d_cfg, model_family=fam,
                **({} if side else dict(device="cpu")))
        app.load()
        apps.append(app)
    return tuple(apps) if jax_side else (None, apps[0])


def with_medusa_heads(case, num_heads, seed=11, scale=0.05):
    """``case``'s state dict with ``num_heads`` random Medusa heads."""
    H, V, _ = _dims(case)
    rng = np.random.default_rng(seed)
    sd = dict(tiny_hf(case)[3])
    for i in range(num_heads):
        sd[f"medusa_head.{i}.0.linear.weight"] = (rng.standard_normal((H, H)) * scale).astype(
            np.float32)
        sd[f"medusa_head.{i}.0.linear.bias"] = (rng.standard_normal((H,)) * scale).astype(
            np.float32)
        sd[f"medusa_head.{i}.1.weight"] = (rng.standard_normal((V, H)) * scale).astype(np.float32)
    return sd


def medusa_pair(case, num_heads=3, tree=None, jax_side=True):
    model_type, _, cfg, _ = tiny_hf(case)
    sd = with_medusa_heads(case, num_heads)
    kw = dict(is_medusa=True, num_medusa_heads=num_heads, medusa_speculation_length=num_heads + 1,
              medusa_tree=tree, **CASE_KW.get(case, {}))
    apps = []
    for side in ((True, False) if jax_side else (False,)):
        fam, tcfg = config(side, model_type, cfg, **kw)
        state = sd if side else _torch_sd(sd)

        class A(JaxMedusa if side else MedusaCausalLM):
            def get_state_dict(self):
                return state

        app = A("<t>", tcfg, model_family=fam, **({} if side else dict(device="cpu")))
        app.load()
        apps.append(app)
    return tuple(apps) if jax_side else (None, apps[0])


def _want(case, n=NEW):
    return hf_tokens(case, n=n) if tiny_hf(case)[1] is not None else port_greedy(case, n=n)


# ---------------------------------------------------------------------------
# EAGLE and EAGLE3 chains
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case,eagle3", [("gpt_oss_ring", True), ("gpt_oss_ring", False),
                                         ("gemma2", False), ("llama4_text", True),
                                         ("phi", False)])
def test_eagle_chain_on_a_family(case, eagle3):
    """EAGLE and EAGLE3 chain windows on a family target: tokens equal HF
    greedy and the JAX app's, count for count; on gpt-oss's interleaved
    ring EAGLE3's features come from the interleaved stack's layer
    outputs."""
    japp, tapp = eagle_pair(case, eagle3)
    got, tlog = generate(tapp, n=NEW)
    jout, jlog = generate(japp, n=NEW)
    np.testing.assert_array_equal(got, _want(case))
    np.testing.assert_array_equal(jout, got)
    assert tlog == jlog and len(tlog) > 1
    if case == "gpt_oss_ring":
        assert "k_win" in tapp.kv_cache["target"] and "k_win" not in tapp.kv_cache["draft"]


@pytest.mark.parametrize("case,tree", [
    ("olmo2", {"choices": MC_TREE}),
    ("granite", {"dynamic": {"steps": 2, "branching_factor": 2, "num_inputs": 2}})])
def test_eagle_tree_on_a_family(case, tree):
    """EAGLE's static and dynamic token trees on families without a window
    or chunk (OLMo-2's flat q/k norms and post-block norms, Granite's
    multipliers): tokens equal HF greedy and the JAX app's, count for
    count."""
    japp, tapp = eagle_pair(case, spec_len=2, tree=tree)
    got, tlog = generate(tapp, n=NEW)
    jout, jlog = generate(japp, n=NEW)
    np.testing.assert_array_equal(got, _want(case))
    np.testing.assert_array_equal(jout, got)
    assert tlog == jlog and len(tlog) > 1


# ---------------------------------------------------------------------------
# Medusa
# ---------------------------------------------------------------------------


def _proposals(app, log):
    inner = app.forward

    def fwd(input_ids, position_ids, **kw):
        out = inner(input_ids, position_ids, **kw)
        buf = app.kv_cache["medusa_tokens"]
        log.append(np.asarray(buf.clone() if isinstance(buf, torch.Tensor) else buf))
        return out

    app.forward = fwd


@pytest.mark.parametrize("case,tree", [("gemma2", None), ("granite", None), ("olmo2", MC_TREE)])
def test_medusa_on_a_family(case, tree):
    """Medusa chain windows (Gemma-2's (1 + w) norm, softcaps and window;
    Granite's multipliers) and a token tree (OLMo-2's flat q/k norms and
    post-block norms, no window): tokens equal HF greedy and the JAX app's.
    Where the family's final norm is a plain RMSNorm the proposals and
    counts equal the JAX app's after every window; on Gemma-2 the port's
    heads read the (1 + w) norm and their proposals differ. (On a biased
    LayerNorm family, Phi's, the JAX package's heads cannot run: its RMS
    takes the norm's weight alone; the port's run in the coverage test.)"""
    japp, tapp = medusa_pair(case, tree=tree)
    jprop, tprop = [], []
    _proposals(japp, jprop)
    _proposals(tapp, tprop)
    got, tlog = generate(tapp, n=NEW)
    jout, jlog = generate(japp, n=NEW)
    np.testing.assert_array_equal(got, _want(case))
    np.testing.assert_array_equal(jout, got)
    same = all(np.array_equal(a, b) for a, b in zip(tprop, jprop))
    if case == "gemma2":
        assert not same
    else:
        assert same and tlog == jlog
    want = "attn_mask_override_xla" if tree else "tkg_two_part_xla"
    strategies = tapp.models[TAG_MEDUSA_SPECULATION].attention_strategies
    assert want in strategies[max(strategies)]


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------


def _deepseek(name):
    from test_torch_mla import MODELS, make_tiny_hf_deepseek

    return make_tiny_hf_deepseek(**MODELS[name])


@pytest.mark.parametrize("name,draft", [("dense", "weak"), ("segmented", "perfect")])
def test_fused_window_on_mla(name, draft):
    """The fused window on an MLA target: a dense Llama draft beside it, and
    the segmented stack (a dense layer before MoE layers) as its own draft,
    every window accepted whole; tokens equal HF greedy and the JAX app's,
    count for count."""
    from test_torch_family_spec import weak_draft
    from nxdi_tpu.speculation import FusedSpecCausalLM as JaxFused
    from nxdi_tpu_torch.speculation import FusedSpecCausalLM

    model, hf_cfg = _deepseek(name)
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    if draft == "weak":
        dcfg, dsd, d_type = *weak_draft(hf_cfg.hidden_size, hf_cfg.vocab_size), "llama"
    else:
        dcfg, dsd, d_type = hf_cfg.to_dict(), sd, "deepseek_v3"
    outs, logs = [], []
    for side in (True, False):
        spec = (JaxSpecConfig if side else SpeculationConfig)(speculation_length=2,
                                                              enable_fused_speculation=True)
        fam, tcfg = config(side, "deepseek_v3", hf_cfg.to_dict(), speculation_config=spec)
        dfam, d_cfg = config(side, d_type, dcfg)
        t_sd, d_sd = (sd, dsd) if side else (_torch_sd(sd), _torch_sd(dsd))

        class A(JaxFused if side else FusedSpecCausalLM):
            def get_state_dict(self):
                return t_sd

            def get_draft_state_dict(self):
                return d_sd

        app = A("<t>", tcfg, "<d>", d_cfg, model_family=fam, draft_family=dfam,
                **({} if side else dict(device="cpu")))
        app.load()
        out, log = generate(app, n=NEW)
        outs.append(out)
        logs.append(log)
    from nxdi_tpu.utils.accuracy import hf_greedy_generate

    want = hf_greedy_generate(model, PROMPT, max_new_tokens=NEW)
    np.testing.assert_array_equal(outs[1], want)
    np.testing.assert_array_equal(outs[0], want)
    assert logs[1] == logs[0]
    if draft == "perfect":
        assert all(c == [3] for c in logs[1][:-1]), logs[1]


# ---------------------------------------------------------------------------
# the refusals kept
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case,kind", [("gemma2", "medusa"), ("llama4_text", "medusa"),
                                       ("gemma2", "eagle"), ("llama4_text", "eagle_dynamic")])
def test_trees_on_a_windowed_target_refused(case, kind):
    """A token tree on a target with a sliding window or an attention chunk
    raises at app build, naming it: the tree verify's ancestor mask carries
    no position window. The JAX package's Medusa raises too; its EAGLE tree
    runs and drops the window (ROADMAP Queue 3)."""
    what = "chunk_size" if case == "llama4_text" else "sliding_window"
    if kind == "medusa":
        model_type, _, cfg, _ = tiny_hf(case)
        kw = dict(is_medusa=True, num_medusa_heads=3, medusa_speculation_length=4,
                  medusa_tree=MC_TREE, **CASE_KW.get(case, {}))
        fam, tcfg = config(False, model_type, cfg, **kw)
        with pytest.raises(NotImplementedError, match=f"token-tree speculation.*{what}"):
            MedusaCausalLM("<t>", tcfg, model_family=fam, device="cpu")
        jfam, jcfg = config(True, model_type, cfg, **kw)
        with pytest.raises(ValueError, match="medusa tree decoding does not support "
                                             "sliding-window or chunked"):
            JaxMedusa("<t>", jcfg, model_family=jfam)
        return
    tree = ({"choices": MC_TREE} if kind == "eagle" else
            {"dynamic": {"steps": 3, "branching_factor": 2, "num_inputs": 1}})
    model_type, _, cfg, _ = tiny_hf(case)
    dcfg, _ = eagle_draft(case)
    spec = SpeculationConfig(speculation_length=2 if kind == "eagle" else 3,
                             enable_eagle_speculation=True)
    fam, tcfg = config(False, model_type, cfg, speculation_config=spec,
                       token_tree_config=tree, **CASE_KW.get(case, {}))
    d_cfg = tle.LlamaEagleInferenceConfig(
        TorchConfig(on_device_sampling_config=OnDeviceSamplingConfig(), **common()),
        load_config=lambda: dict(dcfg))
    with pytest.raises(NotImplementedError, match=f"token-tree speculation.*{what}"):
        EagleSpecCausalLM("<t>", tcfg, "<d>", d_cfg, model_family=fam, device="cpu")


def test_ring_modes_refused_in_both_packages():
    """What ``config.py`` keeps refusing in both packages: a ring under
    Medusa (its trees and chains assume position-addressed slots)."""
    kw = dict(window_sized_kv=True, sliding_window=8, is_medusa=True, num_medusa_heads=2,
              medusa_speculation_length=3, seq_len=64)
    for Tc in (TpuConfig, TorchConfig):
        with pytest.raises(ValueError, match="paged/medusa/prefix modes"):
            Tc(**kw)


# ---------------------------------------------------------------------------
# coverage: every switch, every speculation app
# ---------------------------------------------------------------------------


def test_every_switch_runs_every_speculation_app():
    """Each case of the one-family-per-switch map (which together turn on
    every switch ``family_switches`` can name and Gemma-3's local rope pair)
    builds the fused window and the standard pair (each over the target as
    its own draft), an EAGLE chain and a Medusa chain, and each emits the
    port's target-only greedy tokens (held to HF and the JAX package by the
    family test files)."""
    import inspect
    import re

    seen = set()
    for case in sorted(ALL_CASES):
        model_type, _, cfg, _ = tiny_hf(case)
        fam, c = config(False, model_type, cfg, **CASE_KW.get(case, {}))
        seen |= {s.split("=")[0] for s in family_switches(fam.build_arch(c))}
        if local_rope(fam, c):
            seen.add("use_local_rope")
        want = port_greedy(case, n=8)
        for app in (spec_pair("fused", case, "perfect", 2, jax_side=False)[1],
                    spec_pair("standard", case, "perfect", 2, jax_side=False)[1],
                    eagle_pair(case, jax_side=False, spec_len=2)[1],
                    medusa_pair(case, num_heads=2, jax_side=False)[1]):
            got, log = generate(app, n=8)
            np.testing.assert_array_equal(got, want, err_msg=f"{case}: {type(app).__name__}")
            assert log
    names = set(re.findall(r'^\s*\(f?"([a-z_0-9]+)', inspect.getsource(family_switches), re.M))
    assert names | {"use_local_rope"} <= seen, sorted(names - seen)
