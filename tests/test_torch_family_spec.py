"""Speculation on the family switches, the window-sized rings and MLA, held
to HF greedy and the JAX package, part 1 (the fused window and the standard
pair), with the helpers part 2 (``test_torch_family_spec_b.py``: EAGLE,
EAGLE3, Medusa, MLA, the refusals kept and the coverage of every switch)
shares.

Each case is a tiny 2-layer family of the one-family-per-switch map
(``test_torch_family_paths.ALL_CASES``), or the window-sized rings of the
JAX package's own tests: Mistral's homogeneous ring (window 8, ring
8 + spec_len + 1 slots, a full-cache draft beside it) and gpt-oss's
interleaved ring (``k_win`` / ``v_win`` in the target's cache). Both
packages build from the same HF state dicts, float32. A "perfect" draft is
the target's own weights in a full-cache draft: it is accepted whole, so
every verify row's token is emitted and a wrong mask past the first row
shows. The emitted tokens are the target's greedy tokens, so every run
equals HF greedy; the JAX app's tokens and per-window counts are compared
where the JAX package computes the same windows.

The JAX package's homogeneous ring verify writes its rows before it reads
the ring, whose positions it infers from the first query: the later rows
read as positions a whole ring back, outside the window, so with an
accepted draft its tokens leave HF (ROADMAP Queue 3; pinned below). The
port defers the ring's multi-token rows (attends the old ring beside them,
then commits) and stays on HF."""

import functools
import importlib

import numpy as np
import pytest
import torch

import jax

from nxdi_tpu.config import OnDeviceSamplingConfig as JaxODSC
from nxdi_tpu.config import SpeculationConfig as JaxSpecConfig
from nxdi_tpu.config import TpuConfig
from nxdi_tpu.generation.hf_adapter import HuggingFaceGenerationAdapter as JaxAdapter
from nxdi_tpu.models import registry as jreg
from nxdi_tpu.speculation import FusedSpecCausalLM as JaxFused
from nxdi_tpu.speculation import StandardSpecCausalLM as JaxStandard
from nxdi_tpu.utils.accuracy import hf_greedy_generate as hf_greedy
from nxdi_tpu_torch.config import OnDeviceSamplingConfig, SpeculationConfig, TorchConfig
from nxdi_tpu_torch.generation.hf_adapter import HuggingFaceGenerationAdapter
from nxdi_tpu_torch.models import registry as treg
from nxdi_tpu_torch.runtime.model_wrapper import TAG_FUSED_SPECULATION, TAG_SPECULATION
from nxdi_tpu_torch.speculation import FusedSpecCausalLM, StandardSpecCausalLM

from test_torch_family_paths import ALL_CASES
from test_torch_slice import fresh_jax_compiles

PROMPT = np.array([[5, 9, 3, 17, 2, 8, 11, 42, 7, 13, 21, 4]], dtype=np.int64)
NEW = 16
W = 8  # the rings' window
# the window-sized rings of the JAX package's tests, beside that map
RINGS = {
    "mistral_ring": ("test_torch_window_kv", "mistral"),
    "gpt_oss_ring": ("test_torch_window_kv", "gpt_oss"),
}
RING = dict(window_sized_kv=True, sliding_window=W)
# a case's own app settings (Llama 4's chunk of 8 wants a longer budget)
CASE_KW = {"llama4_text": dict(seq_len=128, max_context_length=64)}
# a weak draft: a tiny Llama of another seed at the target's width and vocabulary
WEAK = dict(intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=256, rms_norm_eps=1e-5,
            rope_theta=10000.0, tie_word_embeddings=False)


@pytest.fixture(autouse=True, scope="module")
def _fresh_jax_compiles():
    with fresh_jax_compiles():
        yield


@functools.lru_cache(maxsize=None)
def tiny_hf(case):
    """(model type, HF model or None, HF config dict, state dict as numpy)
    of ``case``, from its family test module."""
    module, key = {**ALL_CASES, **RINGS}[case]
    mod = importlib.import_module(module)
    if module == "test_torch_moe_families":
        return mod.tiny_case(key)
    if module == "test_torch_llama4":
        return ("llama4_text",) + tuple(mod.tiny_case())
    if module == "test_torch_families":
        return (key,) + tuple(mod.tiny_family(key))
    model, cfg, sd = mod.tiny_case(key)
    model_type = mod.CASES[key][0] if module == "test_torch_dense_tier3" else key
    return model_type, model, cfg, sd


@functools.lru_cache(maxsize=None)
def weak_draft(hidden: int, vocab: int, seed: int = 5):
    """A tiny random Llama (HF config dict, state dict) at the target's
    hidden width and vocabulary."""
    import transformers

    torch.manual_seed(seed)
    cfg = transformers.LlamaConfig(hidden_size=hidden, vocab_size=vocab, **WEAK)
    model = transformers.LlamaForCausalLM(cfg).eval()
    return cfg.to_dict(), {k: v.detach().numpy() for k, v in model.state_dict().items()}


def case_kw(case, **kw):
    return {**(RING if case in RINGS else {}), **CASE_KW.get(case, {}), **kw}


def common(**kw):
    d = dict(tp_degree=1, seq_len=64, max_context_length=32, batch_size=1, dtype="float32",
             attn_kernel_enabled=True, attn_tkg_kernel_enabled=True, skip_warmup=True)
    d.update(kw)
    return d


def config(jax_side, model_type, cfg, **kw):
    """The family's inference config of one package, on-device sampling on."""
    if jax_side:
        family, cfg_cls = jreg.get_family(model_type)
        tc = TpuConfig(on_device_sampling_config=JaxODSC(), **common(**kw))
    else:
        family, cfg_cls = treg.get_family(model_type)
        tc = TorchConfig(on_device_sampling_config=OnDeviceSamplingConfig(), **common(**kw))
    return family, cfg_cls(tc, load_config=lambda: dict(cfg))


def _torch_sd(sd):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}


def draft_of(case, draft):
    """(model type, HF config dict, state dict) of the draft: ``perfect``
    the target itself, ``weak`` a tiny Llama at its width."""
    model_type, _, cfg, sd = tiny_hf(case)
    if draft == "perfect":
        return model_type, cfg, sd
    dcfg, dsd = weak_draft(cfg.get("hidden_size", cfg.get("n_embd")), cfg["vocab_size"])
    return "llama", dcfg, dsd


def spec_pair(kind, case, draft, spec_len, jax_side=True, **kw):
    """The JAX package's ``kind`` ("fused" or "standard") app and the port's
    on ``case``'s target and the draft, built from the same state dicts
    (``jax_side=False``: the port's alone, None in its place)."""
    model_type, _, cfg, sd = tiny_hf(case)
    d_type, dcfg, dsd = draft_of(case, draft)
    tkw = case_kw(case, **kw)
    dkw = CASE_KW.get(case, {}) if d_type == model_type else {}
    dkw = {**dkw, **{k: v for k, v in kw.items() if k == "batch_size"}}
    apps = []
    for side in ((True, False) if jax_side else (False,)):
        if kind == "fused":
            spec = dict(speculation_config=(JaxSpecConfig if side else SpeculationConfig)(
                speculation_length=spec_len, enable_fused_speculation=True))
        else:
            spec = dict(speculation_length=spec_len)
        fam, tcfg = config(side, model_type, cfg, **spec, **tkw)
        dfam, d_cfg = config(side, d_type, dcfg, **dkw)
        t_sd, d_sd = (sd, dsd) if side else (_torch_sd(sd), _torch_sd(dsd))
        extra = {} if side else dict(device="cpu")
        if kind == "fused":
            base = JaxFused if side else FusedSpecCausalLM

            class App(base):
                def get_state_dict(self):
                    return t_sd

                def get_draft_state_dict(self):
                    return d_sd

            app = App("<t>", tcfg, "<d>", d_cfg, model_family=fam, draft_family=dfam, **extra)
        else:
            app = (JaxStandard if side else StandardSpecCausalLM)(
                "<t>", tcfg, "<d>", d_cfg, model_family=fam, draft_family=dfam, **extra)
            app.target.get_state_dict = lambda t_sd=t_sd: t_sd
            app.draft.get_state_dict = lambda d_sd=d_sd: d_sd
        app.load()
        apps.append(app)
    return tuple(apps) if jax_side else (None, apps[0])


def target_app(case, **kw):
    """The port's target-only app of ``case`` (its greedy tokens are held
    to HF and the JAX package by the family test files)."""
    from nxdi_tpu_torch.runtime.application import TorchModelForCausalLM

    model_type, _, cfg, sd = tiny_hf(case)
    fam, tcfg = config(False, model_type, cfg, **case_kw(case, **kw))

    class App(TorchModelForCausalLM):
        def get_state_dict(self):
            return _torch_sd(sd)

    app = App("<t>", tcfg, model_family=fam, device="cpu")
    app.load()
    return app


def windows(app):
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


def generate(app, prompt=PROMPT, n=NEW, **gen):
    """(tokens, per-window counts) of ``generate()`` on either package's app."""
    log = windows(app)
    Adapter = HuggingFaceGenerationAdapter if isinstance(
        app, (FusedSpecCausalLM, StandardSpecCausalLM)) else JaxAdapter
    out = np.asarray(Adapter(app).generate(prompt, max_new_tokens=n, **gen))
    app.__dict__.pop("forward", None)
    return out, log


@functools.lru_cache(maxsize=None)
def hf_tokens(case, prompt=tuple(PROMPT[0]), n=NEW):
    model = tiny_hf(case)[1]
    return hf_greedy(model, np.array([prompt]), max_new_tokens=n)


def port_greedy(case, prompt=PROMPT, n=NEW):
    return np.asarray(HuggingFaceGenerationAdapter(target_app(case)).generate(
        prompt, max_new_tokens=n))


# ---------------------------------------------------------------------------
# the fused window on the rings
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(RINGS))
@pytest.mark.parametrize("draft", ["weak", "perfect"])
def test_fused_window_on_a_ring(case, draft):
    """The JAX package's ring speculation tests (``test_window_kv.py``'s
    homogeneous Mistral ring, ``test_interleaved_window_kv.py``'s gpt-oss
    ring): the same cache shapes (a ring of W + spec_len + 1 slots, a
    full-cache draft), 3x past the window; tokens equal HF greedy. A weak
    draft's windows equal the JAX app's, count for count; a perfect draft
    is accepted whole. On the homogeneous ring the JAX app leaves HF under
    a perfect draft (its verify rows past the first read the ring wrong)."""
    spec_len = 3
    japp, tapp = spec_pair("fused", case, draft, spec_len)
    target = tapp.kv_cache["target"]
    ring_key = "k" if case == "mistral_ring" else "k_win"
    assert target[ring_key].shape[3] == W + spec_len + 1
    if case == "gpt_oss_ring":
        assert target["k"].shape[3] == 64  # the full layers keep seq_len
    assert "k_win" not in tapp.kv_cache["draft"]
    assert tapp.kv_cache["draft"]["k"].shape[3] == 64
    want = hf_tokens(case, n=3 * W)
    got, tlog = generate(tapp, n=3 * W)
    np.testing.assert_array_equal(got, want)
    jout, jlog = generate(japp, n=3 * W)
    if draft == "weak" or case == "gpt_oss_ring":
        np.testing.assert_array_equal(jout, want)
        assert tlog == jlog
    else:
        assert not np.array_equal(jout, want)  # the JAX homogeneous ring's verify fault
    if draft == "perfect":
        assert all(c == [spec_len + 1] for c in tlog[:-1]), tlog
    strategies = set(tapp.models[TAG_FUSED_SPECULATION].attention_strategies[64])
    assert "tkg_two_part_xla" in strategies


def test_fused_device_resident_chain_on_a_ring():
    """``async_mode`` on the homogeneous ring: each window emits the next
    window's inputs on the device; chained through ``forward_device`` the
    windows emit HF greedy, a perfect draft accepted whole."""
    _, tapp = spec_pair("fused", "mistral_ring", "perfect", 3, jax_side=False, async_mode=True)
    S = PROMPT.shape[1]
    want = hf_tokens("mistral_ring", n=3 * W)[0, S:]
    out = tapp.forward(PROMPT.astype(np.int32), np.arange(S, dtype=np.int32)[None],
                       last_token_index=np.array([S - 1], np.int32))
    first = int(out["tokens"][0, 0])
    nxt = {"input_ids": torch.tensor([[first]], dtype=torch.int32),
           "position_ids": torch.tensor([[S]], dtype=torch.int32),
           "last_token_index": torch.zeros((1,), dtype=torch.int32),
           "sampling_params": torch.ones((1, 3))}
    w = tapp.models[TAG_FUSED_SPECULATION]
    toks, counts = [first], []
    for _ in range(5):
        out, tapp.kv_cache = w.forward_device(tapp.params, tapp.kv_cache, nxt, 64)
        c = int(out["counts"][0])
        toks.extend(int(x) for x in out["tokens"][0, :c])
        counts.append(c)
        nxt = out["next_inputs"]
    assert counts == [4] * 5
    np.testing.assert_array_equal(np.array(toks[:len(want)]), want[:len(toks)])
    assert len(toks) == 21


# ---------------------------------------------------------------------------
# the fused window and the standard pair on the family switches
# ---------------------------------------------------------------------------

# one family per switch group: Gemma-2's softcaps and window, Phi's LayerNorm
# and partial rotary, OPT's learned positions, Llama 4's chunk and NoPE
# layers, gpt-oss's sinks (a full cache), Granite's multipliers
FUSED_CASES = ["gemma2", "phi", "opt", "llama4_text", "gpt_oss", "granite"]


@pytest.mark.parametrize("case", FUSED_CASES)
def test_fused_window_on_a_family(case):
    """A perfect draft (the target's weights, a full cache) at spec_len 3:
    every window is accepted whole, so every verify row's token is emitted;
    tokens equal HF greedy (the port's target-only greedy where transformers
    has no class) and the JAX app's, count for count."""
    japp, tapp = spec_pair("fused", case, "perfect", 3)
    got, tlog = generate(tapp)
    jout, jlog = generate(japp)
    np.testing.assert_array_equal(got, jout)
    assert tlog == jlog
    assert all(c == [4] for c in tlog[:-1]), tlog
    want = hf_tokens(case) if tiny_hf(case)[1] is not None else port_greedy(case)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case,draft", [("gemma2", "weak"), ("phi", "perfect"),
                                        ("llama4_text", "perfect"), ("mistral_ring", "perfect")])
def test_standard_pair_on_a_family(case, draft):
    """The draft-model pair (a separate draft app, the target's
    ``speculation_model`` verify): tokens equal HF greedy and the JAX
    pair's, count for count (but on the homogeneous ring, whose JAX verify
    reads the ring wrong past its first row)."""
    japp, tapp = spec_pair("standard", case, draft, 3)
    got, tlog = generate(tapp)
    want = hf_tokens(case)
    np.testing.assert_array_equal(got, want)
    if case != "mistral_ring":
        jout, jlog = generate(japp)
        np.testing.assert_array_equal(jout, want)
        assert tlog == jlog
    verify = tapp.target.models[TAG_SPECULATION]
    assert "tkg_two_part_xla" in verify.attention_strategies[max(verify.buckets)]
