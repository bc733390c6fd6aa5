"""The port's speculative decoding (``nxdi_tpu_torch/speculation/``) held
against the JAX package's on the CPU: the fused draft + target app, the
standard draft-model pair, Medusa chain and token-tree windows, the tree
functions, the fused window's draft body against the JAX package's slim
scan, and the refusals. EAGLE is held against the JAX package in
``test_torch_eagle.py``.

Both packages run the same weights: the tiny random HF llamas of the JAX
package's speculation tests (hidden 64, vocab 256, float32; a 4-layer
target, a 2-layer draft from another seed), carried across with
``from_jax_params``. The JAX references run with their attention kernels on
(Pallas in interpret mode) and compile under ``fresh_jax_compiles()``.
Greedy tokens must equal the JAX package's and HF's, and the accepted count
of every window must equal the JAX package's window for window."""

import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nxdi_tpu.config import OnDeviceSamplingConfig as JaxODSC
from nxdi_tpu.config import SpeculationConfig as JaxSpecConfig
from nxdi_tpu.config import TpuConfig
from nxdi_tpu.generation.hf_adapter import HuggingFaceGenerationAdapter as JaxAdapter
from nxdi_tpu.models.llama import modeling_llama as jml
from nxdi_tpu.speculation import FusedSpecCausalLM as JaxFused
from nxdi_tpu.speculation import MedusaCausalLM as JaxMedusa
from nxdi_tpu.speculation import StandardSpecCausalLM as JaxStandard
from nxdi_tpu.speculation import token_tree as jtt
from nxdi_tpu.utils.accuracy import hf_greedy_generate as hf_greedy
from nxdi_tpu_torch.config import OnDeviceSamplingConfig, SpeculationConfig, TorchConfig
from nxdi_tpu_torch.generation.hf_adapter import HuggingFaceGenerationAdapter
from nxdi_tpu_torch.models.convert import from_jax_params
from nxdi_tpu_torch.models.llama import modeling_llama as tml
from nxdi_tpu_torch.runtime.model_wrapper import (
    TAG_FUSED_SPECULATION,
    TAG_MEDUSA_SPECULATION,
    TAG_SPECULATION,
)
from nxdi_tpu_torch.speculation import (
    FusedSpecCausalLM,
    MedusaCausalLM,
    StandardSpecCausalLM,
)
from nxdi_tpu_torch.speculation import token_tree as ttt
from test_torch_slice import fresh_jax_compiles

PROMPT = np.array([[5, 9, 3, 17, 2, 8, 11, 42]], dtype=np.int64)
MC_TREE = [[0], [1], [0, 0], [0, 1], [1, 0], [0, 0, 0]]
DEEP_TREE = [[0], [1], [2], [0, 0], [0, 1], [0, 0, 0], [1, 0], [0, 0, 0, 0]]
H, VOCAB = 64, 256
CACHE_TOL = 1e-5  # float32 draft-cache rows, the port's against the JAX package's


@pytest.fixture(autouse=True, scope="module")
def _fresh_jax_compiles():
    with fresh_jax_compiles():
        yield


def _tiny_hf_llama(seed, layers):
    from transformers import LlamaConfig, LlamaForCausalLM

    torch.manual_seed(seed)
    cfg = LlamaConfig(hidden_size=H, intermediate_size=128, num_hidden_layers=layers,
                      num_attention_heads=4, num_key_value_heads=2, vocab_size=VOCAB,
                      max_position_embeddings=256, rms_norm_eps=1e-5, rope_theta=10000.0,
                      tie_word_embeddings=False)
    return LlamaForCausalLM(cfg).eval(), cfg


@pytest.fixture(scope="module")
def models():
    """The target (seed 0, 4 layers) and the drafts: weak (seed 1, 2
    layers), another (seed 2, 2 layers), and perfect (the target itself)."""
    target = _tiny_hf_llama(0, 4)
    return {"target": target, "weak": _tiny_hf_llama(1, 2), "other": _tiny_hf_llama(2, 2),
            "perfect": target}


def _sd(hf):
    return {k: v.detach().numpy() for k, v in hf.state_dict().items()}


def _common(**kw):
    d = dict(tp_degree=1, seq_len=64, max_context_length=32, batch_size=1, dtype="float32",
             attn_kernel_enabled=True, attn_tkg_kernel_enabled=True, skip_warmup=True)
    d.update(kw)
    return d


def _configs(jax_side, hf_cfg, **kw):
    if jax_side:
        return jml.LlamaInferenceConfig(TpuConfig(on_device_sampling_config=JaxODSC(),
                                                  **_common(**kw)),
                                        load_config=lambda: hf_cfg.to_dict())
    return tml.LlamaInferenceConfig(TorchConfig(on_device_sampling_config=OnDeviceSamplingConfig(),
                                                **_common(**kw)),
                                    load_config=lambda: hf_cfg.to_dict())


def _windows(app):
    """Record the accepted counts of every window dispatch of ``app``."""
    log = []
    inner = app.forward

    def fwd(input_ids, position_ids, **kw):
        out = inner(input_ids, position_ids, **kw)
        if np.asarray(input_ids).shape[1] == 1:
            c = out["counts"]
            log.append((c.cpu().numpy() if isinstance(c, torch.Tensor)
                        else np.asarray(jax.device_get(c))).tolist())
        return out

    app.forward = fwd
    return log


# ---------------------------------------------------------------------------
# the fused app
# ---------------------------------------------------------------------------


def _fused_pair(models, draft, spec_len, **kw):
    """The JAX package's fused app and the port's, on the JAX app's params."""
    (target, tcfg), (dmodel, dcfg) = models["target"], models[draft]
    t_sd, d_sd = _sd(target), _sd(dmodel)
    spec = dict(speculation_length=spec_len, enable_fused_speculation=True)

    class JApp(JaxFused):
        def get_state_dict(self):
            return t_sd

        def get_draft_state_dict(self):
            return d_sd

    japp = JApp("<t>", _configs(True, tcfg, speculation_config=JaxSpecConfig(**spec), **kw),
                "<d>", _configs(True, dcfg, **kw), model_family=jml, draft_family=jml)
    japp.load()
    params = from_jax_params(jax.device_get(japp.params))

    class TApp(FusedSpecCausalLM):
        def build_params(self):
            return params

    tapp = TApp("<t>", _configs(False, tcfg, speculation_config=SpeculationConfig(**spec), **kw),
                "<d>", _configs(False, dcfg, **kw), model_family=tml, draft_family=tml,
                device="cpu")
    tapp.load()
    return japp, tapp


_PAIRS = {}


def _shared_pair(make, models, *args):
    """``make(models, *args)``'s (JAX app, port app), built once in this
    module for the tests that only generate() on it: a later test gets the
    pair back with its forward wrappers dropped and its window counters at
    0. A second generate() needs no fresh cache: every row it reads is
    written first at its exact position, in both packages."""
    key = (make.__name__, repr(args))
    if key not in _PAIRS:
        _PAIRS[key] = make(models, *args)
    for app in _PAIRS[key]:
        app.__dict__.pop("forward", None)
        for attr in ("spec_windows", "spec_accepted_tokens"):
            if hasattr(app, attr):
                setattr(app, attr, 0)
    return _PAIRS[key]


def _generate_both(japp, tapp, prompt, **gen):
    jlog, tlog = _windows(japp), _windows(tapp)
    jout = JaxAdapter(japp).generate(prompt, **gen)
    tout = HuggingFaceGenerationAdapter(tapp).generate(prompt, **gen)
    return jout, tout, jlog, tlog


@pytest.mark.parametrize("draft", ["weak", "perfect"])
@pytest.mark.parametrize("spec_len", [2, 4])
def test_fused_matches_jax(models, spec_len, draft):
    """Tokens equal the JAX package's and HF greedy; every window's accepted
    count equals the JAX package's; a perfect draft accepts whole windows.
    The params came across with ``from_jax_params`` ({"draft", "target"})."""
    japp, tapp = _shared_pair(_fused_pair, models, draft, spec_len)
    expected = hf_greedy(models["target"][0], PROMPT, max_new_tokens=20)
    jout, tout, jlog, tlog = _generate_both(japp, tapp, PROMPT, max_new_tokens=20)
    np.testing.assert_array_equal(jout, expected)
    np.testing.assert_array_equal(tout, expected)
    assert tlog == jlog and len(tlog) > 0
    assert tapp.spec_windows == len(tlog)
    assert tapp.spec_accepted_tokens == sum(c[0] for c in tlog)
    if draft == "perfect":
        assert all(c[0] == spec_len + 1 for c in tlog[:-1]), tlog
    w = tapp.models[TAG_FUSED_SPECULATION]
    assert set(w.attention_strategies[64]) == {"tkg_fused_kernel_stacked", "tkg_two_part_xla"}


@pytest.mark.parametrize("case", ["fill", "small_bucket"])
def test_fused_window_edge(models, case):
    """Filling the cache to its last slot (writes past the window drop,
    their tokens are discarded), and a TKG bucket smaller than seq_len
    (retirement stops at the compiled window's edge)."""
    if case == "fill":
        japp, tapp = _shared_pair(_fused_pair, models, "weak", 4)
        n = 56
    else:
        japp, tapp = _fused_pair(models, "weak", 4, token_generation_buckets=[32])
        n = 24
    expected = hf_greedy(models["target"][0], PROMPT, max_new_tokens=n)
    jout, tout, jlog, tlog = _generate_both(japp, tapp, PROMPT, max_new_tokens=n)
    np.testing.assert_array_equal(tout, jout)
    np.testing.assert_array_equal(tout, expected[:, :tout.shape[1]])
    assert tout.shape[1] >= PROMPT.shape[1] + 24
    assert tlog == jlog


def test_fused_batch_and_eos(models):
    """Rows retiring at different rates, and an EOS mid-window."""
    japp, tapp = _fused_pair(models, "other", 3, batch_size=2)
    p0, p1 = [5, 9, 3, 17, 2, 8, 11, 42], [7, 13, 21, 4]
    prompt = np.zeros((2, 8), dtype=np.int64)
    prompt[0], prompt[1, :4] = p0, p1
    mask = (prompt != 0).astype(np.int32)
    jout, tout, jlog, tlog = _generate_both(japp, tapp, prompt, attention_mask=mask,
                                            max_new_tokens=12)
    np.testing.assert_array_equal(tout, jout)
    e0 = hf_greedy(models["target"][0], np.array([p0]), 12)
    np.testing.assert_array_equal(tout[0, :e0.shape[1]], e0[0])
    assert tlog == jlog
    eos = int(e0[0, len(p0) + 3])
    jout, tout, jlog, tlog = _generate_both(japp, tapp, np.array([p0]), max_new_tokens=12,
                                            eos_token_id=eos, pad_token_id=0)
    np.testing.assert_array_equal(tout, jout)
    idx = int(np.where(tout[0] == eos)[0][0])
    assert (tout[0, idx + 1:] == 0).all()
    assert tlog == jlog


def test_fused_device_resident_chain(models):
    """``async_mode``: each window emits the next window's inputs on the
    device; chaining windows through ``forward_device`` equals the JAX
    package's chain and HF greedy."""
    japp, tapp = _fused_pair(models, "weak", 3, async_mode=True)
    assert not tapp.async_supported
    S = PROMPT.shape[1]
    expected = hf_greedy(models["target"][0], PROMPT, max_new_tokens=17)[0, S:]
    pos = np.arange(S, dtype=np.int32)[None]
    lti = np.array([S - 1], np.int32)
    got = {}
    for name, app in (("jax", japp), ("port", tapp)):
        out = app.forward(PROMPT.astype(np.int32), pos, last_token_index=lti)
        first = int(np.asarray(out["tokens"])[0, 0])
        if name == "jax":
            nxt = {"input_ids": jnp.asarray([[first]], jnp.int32),
                   "position_ids": jnp.asarray([[S]], jnp.int32),
                   "last_token_index": jnp.zeros((1,), jnp.int32),
                   "sampling_params": jnp.ones((1, 3), jnp.float32)}
        else:
            nxt = {"input_ids": torch.tensor([[first]], dtype=torch.int32),
                   "position_ids": torch.tensor([[S]], dtype=torch.int32),
                   "last_token_index": torch.zeros((1,), dtype=torch.int32),
                   "sampling_params": torch.ones((1, 3))}
        w = app.models[TAG_FUSED_SPECULATION]
        toks, counts = [first], []
        for _ in range(12):
            out, app.kv_cache = w.forward_device(app.params, app.kv_cache, nxt, 64)
            t, c = np.asarray(out["tokens"]), np.asarray(out["counts"])
            toks.extend(int(x) for x in t[0, :c[0]])
            counts.append(int(c[0]))
            nxt = out["next_inputs"]
        got[name] = (toks, counts)
    assert got["port"] == got["jax"]
    n = min(len(got["port"][0]), 16)
    assert n >= 12
    np.testing.assert_array_equal(np.array(got["port"][0][:n]), expected[:n])


# ---------------------------------------------------------------------------
# the standard pair
# ---------------------------------------------------------------------------


def _standard_pair(models, spec_len, draft="weak", **kw):
    (target, tcfg), (dmodel, dcfg) = models["target"], models[draft]
    t_sd, d_sd = _sd(target), _sd(dmodel)
    japp = JaxStandard("<t>", _configs(True, tcfg, speculation_length=spec_len, **kw), "<d>",
                       _configs(True, dcfg, **kw), model_family=jml)
    japp.target.get_state_dict = lambda: t_sd
    japp.draft.get_state_dict = lambda: d_sd
    japp.load()
    tapp = StandardSpecCausalLM("<t>", _configs(False, tcfg, speculation_length=spec_len, **kw),
                                "<d>", _configs(False, dcfg, **kw), model_family=tml,
                                device="cpu")
    for side in ("target", "draft"):
        params = from_jax_params(jax.device_get(getattr(japp, side).params))
        getattr(tapp, side).build_params = lambda params=params: params
    tapp.load()
    return japp, tapp


@pytest.mark.parametrize("spec_len,n,draft", [(2, 20, "weak"), (4, 20, "weak"), (4, 56, "weak"),
                                              (2, 20, "perfect"), (4, 20, "perfect")])
def test_standard_matches_jax(models, spec_len, n, draft):
    """Tokens and per-window counts equal the JAX package's; 56 new tokens
    fill the cache through the window-edge fallback (one plain step a
    window there). A perfect draft accepts less than whole windows, as in
    the JAX package: its spec_len steps leave the last draft token's row
    unwritten after a whole window."""
    japp, tapp = _shared_pair(_standard_pair, models, spec_len, draft)
    expected = hf_greedy(models["target"][0], PROMPT, max_new_tokens=n)
    jout, tout, jlog, tlog = _generate_both(japp, tapp, PROMPT, max_new_tokens=n)
    np.testing.assert_array_equal(jout, expected)
    np.testing.assert_array_equal(tout, expected)
    assert tlog == jlog
    verify = tapp.target.models[TAG_SPECULATION]
    assert verify.attention_strategies[64] == ("tkg_two_part_xla",)
    if n == 56:  # the last windows fell back to one token each
        assert tlog[-1] == [1]


# ---------------------------------------------------------------------------
# Medusa
# ---------------------------------------------------------------------------


def _with_medusa_heads(sd, num_heads, seed=11, scale=0.05):
    rng = np.random.default_rng(seed)
    out = dict(sd)
    for i in range(num_heads):
        out[f"medusa_head.{i}.0.linear.weight"] = (
            rng.standard_normal((H, H)) * scale).astype(np.float32)
        out[f"medusa_head.{i}.0.linear.bias"] = (
            rng.standard_normal((H,)) * scale).astype(np.float32)
        out[f"medusa_head.{i}.1.weight"] = (
            rng.standard_normal((VOCAB, H)) * scale).astype(np.float32)
    return out


def _medusa_pair(models, num_heads, tree):
    target, tcfg = models["target"]
    sd = _with_medusa_heads(_sd(target), num_heads)
    kw = dict(is_medusa=True, num_medusa_heads=num_heads, medusa_speculation_length=num_heads + 1,
              medusa_tree=tree)

    class JApp(JaxMedusa):
        def get_state_dict(self):
            return sd

    japp = JApp("<t>", _configs(True, tcfg, **kw), model_family=jml)
    japp.load()

    class TApp(MedusaCausalLM):
        def get_state_dict(self):
            return sd

    tapp = TApp("<t>", _configs(False, tcfg, **kw), model_family=tml, device="cpu")
    tapp.load()
    carried = from_jax_params(jax.device_get(japp.params))
    for k in ("res_w", "res_b", "head"):
        assert torch.equal(carried["medusa_heads"][k], tapp.params["medusa_heads"][k])
    return japp, tapp


def _proposals(app):
    """The proposal buffer after every window dispatch of ``app``."""
    log = []
    inner = app.forward

    def fwd(input_ids, position_ids, **kw):
        out = inner(input_ids, position_ids, **kw)
        buf = app.kv_cache["medusa_tokens"]
        log.append(buf.clone().numpy() if isinstance(buf, torch.Tensor)
                   else np.asarray(jax.device_get(buf)))
        return out

    app.forward = fwd
    return log


@pytest.mark.parametrize("kind,n", [("chain", 20), ("chain", 56), ("tree", 20), ("tree", 48)])
def test_medusa_matches_jax(models, kind, n):
    """Chain (4 heads) and MC_TREE (3 heads) windows: tokens equal the JAX
    package's and HF greedy, the counts equal window for window, and the
    proposal buffer equals the JAX package's after every dispatch."""
    tree = MC_TREE if kind == "tree" else None
    japp, tapp = _shared_pair(_medusa_pair, models, 3 if tree else 4, tree)
    jprop, tprop = _proposals(japp), _proposals(tapp)
    expected = hf_greedy(models["target"][0], PROMPT, max_new_tokens=n)
    jout, tout, jlog, tlog = _generate_both(japp, tapp, PROMPT, max_new_tokens=n)
    np.testing.assert_array_equal(jout, expected)
    np.testing.assert_array_equal(tout, expected)
    assert tlog == jlog
    assert len(tprop) == len(jprop) > 1
    for a, b in zip(tprop, jprop):
        np.testing.assert_array_equal(a, b)
    want = "attn_mask_override_xla" if tree else "tkg_two_part_xla"
    assert tapp.models[TAG_MEDUSA_SPECULATION].attention_strategies[64] == (want,)


# ---------------------------------------------------------------------------
# the tree functions
# ---------------------------------------------------------------------------


def _tree_inputs(tree, seed, B=4, W=48):
    rng = np.random.default_rng(seed)
    N = tree.num_nodes
    pos0 = rng.integers(0, W, size=(B,)).astype(np.int32)
    pos0[0] = W - 1 - N // 2  # a tree that runs past the window
    proposals = rng.integers(0, 8, size=(B, tree.max_depth + 1, tree.max_branch)).astype(np.int32)
    candidates = rng.integers(0, 4, size=(B, 1 + N)).astype(np.int32)
    # targets equal to each node's token at its parent row with odds 3/4
    target = rng.integers(0, 4, size=(B, 1 + N)).astype(np.int32)
    for i, p in enumerate(tree.node_parent):
        hit = rng.random(B) < 0.75
        target[hit, p + 1] = candidates[hit, i + 1]
    return pos0, proposals, candidates, target, W


@pytest.mark.parametrize("fn", ["from_choices", "tree_verify_mask", "gather_tree_candidates",
                                "best_path_acceptance"])
@pytest.mark.parametrize("choices", [MC_TREE, DEEP_TREE], ids=["mc", "deep"])
@pytest.mark.parametrize("seed", [0, 1])
def test_tree_functions_match_jax(fn, choices, seed):
    jtree, ttree = jtt.TokenTree.from_choices(choices), ttt.TokenTree.from_choices(choices)
    pos0, proposals, candidates, target, W = _tree_inputs(ttree, seed)
    if fn == "from_choices":
        assert ttree.__dict__ == jtree.__dict__
        return
    if fn == "tree_verify_mask":
        want = [jtt.tree_verify_mask(jtree, jnp.asarray(pos0), W)]
        got = [ttt.tree_verify_mask(ttree, torch.from_numpy(pos0), W)]
    elif fn == "gather_tree_candidates":
        tok0 = candidates[:, :1]
        want = [jtt.gather_tree_candidates(jtree, jnp.asarray(tok0), jnp.asarray(proposals))]
        got = [ttt.gather_tree_candidates(ttree, torch.from_numpy(tok0),
                                          torch.from_numpy(proposals))]
    else:
        want = jtt.best_path_acceptance(jtree, jnp.asarray(candidates), jnp.asarray(target))
        got = ttt.best_path_acceptance(ttree, torch.from_numpy(candidates),
                                       torch.from_numpy(target))
        assert (np.asarray(want[0]) > 1).any()  # some node accepted
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(jax.device_get(w)))


# ---------------------------------------------------------------------------
# the fused window's draft body against the JAX package's slim scan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batch,draft", [(1, "weak"), (2, "weak"), (2, "perfect")])
def test_draft_window_matches_jax_slim(models, batch, draft):
    """The port's draft body (a deferred decode step per draft token, then
    the commit: the stacked fused-decode and commit kernels on the card,
    their plain versions here) against the JAX package's default, the slim
    scratch scan committed once: after the same context encoding and one
    window, the window's tokens and counts are equal and the draft caches
    agree, the window's committed rows included."""
    japp, tapp = _fused_pair(models, draft, 4, batch_size=batch)
    prompt = np.tile(PROMPT, (batch, 1)).astype(np.int32)
    prompt[-1, 3] = 77
    S = prompt.shape[1]
    pos = np.tile(np.arange(S, dtype=np.int32), (batch, 1))
    lti = np.full((batch,), S - 1, np.int32)
    jctx = japp.forward(prompt, pos, last_token_index=lti)
    tctx = tapp.forward(prompt, pos, last_token_index=lti)
    tok = tctx["tokens"].numpy().astype(np.int32)
    np.testing.assert_array_equal(np.asarray(jax.device_get(jctx["tokens"])), tok)
    before = {k: v.clone() for k, v in tapp.kv_cache["draft"].items()}
    wpos = np.full((batch, 1), S, np.int32)
    zero = np.zeros((batch,), np.int32)
    jw = japp.forward(tok, wpos, last_token_index=zero)
    tw = tapp.forward(tok, wpos, last_token_index=zero)
    for key in ("tokens", "counts"):
        np.testing.assert_array_equal(tw[key].numpy(), np.asarray(jax.device_get(jw[key])))
    if draft == "perfect":
        assert (tw["counts"].numpy() == 5).all()
    for side in ("k", "v"):
        t = tapp.kv_cache["draft"][side]
        j = np.asarray(jax.device_get(japp.kv_cache["draft"][side]))
        np.testing.assert_allclose(t.numpy(), j, atol=CACHE_TOL, rtol=0)
        assert not torch.equal(t[:, :, :, S:S + 5], before[side][:, :, :, S:S + 5])
    assert set(tapp.models[TAG_FUSED_SPECULATION].attention_strategies[64]) == {
        "tkg_fused_kernel_stacked", "tkg_two_part_xla"}


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


RULES = {
    "negative speculation_length": (dict(speculation_length=-1), "speculation_length must be"),
    "medusa without heads": (dict(is_medusa=True), "is_medusa requires num_medusa_heads"),
    "K-step with speculation": (dict(speculation_length=2, decode_steps_per_dispatch=2),
                                "both own the token-generation stride"),
    "fused with the device loop": (dict(enable_fused_speculation=True, device_loop=True),
                                   "both own the token-generation stride"),
    "medusa with the device loop": (dict(is_medusa=True, num_medusa_heads=2, device_loop=True),
                                    "both own the token-generation stride"),
}


@pytest.mark.parametrize("rule", sorted(RULES))
def test_config_rules_match_jax(rule):
    kw, match = RULES[rule]
    base = dict(on_device_sampling_config={}, seq_len=64)
    with pytest.raises(ValueError, match=match):
        TpuConfig(**base, **kw)
    with pytest.raises(ValueError, match=match):
        TorchConfig(**base, **kw)


def test_app_refusals(models, caplog):
    """A logits processor with speculation raises; do_sample is warned about
    and decoded greedily; the block layout, speculation_length 0 and Medusa
    without heads raise, as in the JAX package."""
    (target, tcfg), (dmodel, dcfg) = models["target"], models["weak"]
    japp, tapp = _fused_pair(models, "weak", 2, output_logits=True)
    for app, adapter in ((japp, JaxAdapter), (tapp, HuggingFaceGenerationAdapter)):
        with pytest.raises(ValueError, match="incompatible with fused speculation"):
            adapter(app).generate(PROMPT, max_new_tokens=4, logits_processor=[lambda i, s: s])
    with caplog.at_level(logging.WARNING, logger="nxdi_tpu_torch"):
        out = HuggingFaceGenerationAdapter(tapp).generate(PROMPT, max_new_tokens=6,
                                                          do_sample=True)
    assert "decodes greedily" in caplog.text
    np.testing.assert_array_equal(out, hf_greedy(target, PROMPT, max_new_tokens=6))
    spec = SpeculationConfig(speculation_length=2, enable_fused_speculation=True)
    block = dict(is_block_kv_layout=True, pa_block_size=8, pa_num_blocks=16)
    with pytest.raises(ValueError, match="block KV layout"):
        FusedSpecCausalLM("<t>", _configs(False, tcfg, speculation_config=spec, **block), "<d>",
                          _configs(False, dcfg, **block), model_family=tml, device="cpu")
    with pytest.raises(ValueError, match="speculation_length >= 1"):
        FusedSpecCausalLM("<t>", _configs(False, tcfg), "<d>", _configs(False, dcfg),
                          model_family=tml, device="cpu")
    with pytest.raises(ValueError, match="is_medusa"):
        MedusaCausalLM("<t>", _configs(False, tcfg), model_family=tml, device="cpu")
    with pytest.raises(ValueError, match="block KV layout"):
        MedusaCausalLM("<t>", _configs(False, tcfg, is_medusa=True, num_medusa_heads=2, **block),
                       model_family=tml, device="cpu")
    with pytest.raises(ValueError, match="exceeds num_medusa_heads"):
        MedusaCausalLM("<t>", _configs(False, tcfg, is_medusa=True, num_medusa_heads=2,
                                       medusa_tree=MC_TREE), model_family=tml, device="cpu")
