"""The one-dispatch mixed engine (``mixed_dispatch``) on the family
switches, held to the JAX package and HF greedy.

Each case is a tiny 2-layer family of the one-family-per-switch map
(``test_torch_family_paths.ALL_CASES``) or Mistral's window, on a paged
pool of 8-slot blocks with three rows a step; the same traffic (three
prompts, a late arrival packed beside a decode row) goes through every
engine. On the switches the JAX package's mixed step computes right
(LayerNorm, clip_qkv, partial rotary, the attention output gate, sandwich
norms, LongRoPE, learned positions without rope, the head bias, xIELU) the
port's mixed engine matches the JAX mixed engine: streams equal and every
mixed dispatch's float32 logits within 1e-4. The JAX mixed step rebuilds
the causal mask alone and drops the window, the chunk, the sink and the
softcap (ROADMAP Queue 3), so on those (Mistral's window, Llama 4's chunk,
gpt-oss's sinks, Gemma-2's softcaps, AFMoE's window) the port's mixed
engine is held, past the window or chunk, to the JAX split engine, the
port's split engine and HF greedy; the JAX mixed stream is pinned off HF
there. Attention runs plainly in both packages (the ragged kernel takes
none of the four, the JAX rule)."""

import numpy as np
import pytest

from nxdi_tpu.serving import InferenceEngine as JaxEngine
from nxdi_tpu.serving import SamplingParams as JaxSP
from nxdi_tpu.serving import SchedulerConfig as JaxSC
from nxdi_tpu_torch.runtime.application import family_switches, local_rope
from nxdi_tpu_torch.runtime.model_wrapper import TAG_MIXED
from nxdi_tpu_torch.serving import InferenceEngine, SamplingParams, SchedulerConfig

from test_torch_families import jax_family_app, port_family_app
from test_torch_family_paths import ALL_CASES
from test_torch_family_spec import hf_greedy, tiny_hf
from test_torch_slice import fresh_jax_compiles

LOGIT_TOL = 1e-4
PAGED = dict(is_block_kv_layout=True, pa_block_size=8, pa_num_blocks=32, batch_size=3,
             ctx_batch_size=1, tkg_batch_size=3, attn_kernel_enabled=False,
             attn_tkg_kernel_enabled=False)
MIXED = dict(PAGED, mixed_dispatch=True)
# past the window (8) and Llama 4's chunk (8): 12-token prompts, 12 new tokens
LONG = [[5, 9, 3, 17, 2, 8, 11, 42, 7, 13, 21, 4], [7, 13, 21, 4, 33, 3, 1, 4, 1, 5],
        [9, 9, 2, 40, 17, 3, 6, 5, 3, 5, 8]]
# inside the window: what the JAX mixed step computes right on a windowed family
SHORT = [[5, 9, 3, 17], [7, 13, 21], [9, 9, 2, 40]]
CASE_KW = {"llama4_text": dict(seq_len=128, max_context_length=64)}
WINDOW_CASES = {"mistral": ("test_torch_families", "mistral")}
# the cases held to the JAX mixed engine, with their prompts and new tokens
JAX_MIXED = {"phi": (LONG, 12), "dbrx": (LONG, 12), "phi3_longrope": (LONG, 12),
             "opt": (LONG, 12), "apertus": (LONG, 12), "afmoe": (SHORT, 4)}
# the cases held to the split engines
SPLIT = ["mistral", "llama4_text", "gpt_oss", "gemma2", "afmoe"]


@pytest.fixture(autouse=True, scope="module")
def _fresh_jax_compiles():
    with fresh_jax_compiles():
        yield


def _case(case):
    if case in WINDOW_CASES:
        import test_torch_families as tf

        model, cfg, sd = tf.tiny_family("mistral")
        return "mistral", model, cfg, sd
    return tiny_hf(case)


def _mixed_logits(app, log):
    """Wrap ``app.forward``: every mixed dispatch's float32 logits go to ``log``."""
    inner = app.forward

    def fwd(*args, submodel=None, **kw):
        out = inner(*args, submodel=submodel, **kw)
        if submodel == TAG_MIXED:
            log.append(np.asarray(out["logits"], dtype=np.float32).copy())
        return out

    app.forward = fwd


def serve(engine_cls, sp_cls, sc_cls, app, prompts, n):
    """Three requests, the third arriving after two steps (its prefill packs
    beside the others' decode rows); returns the streams in request order."""
    eng = engine_cls(app, sc_cls(num_slots=3))
    reqs = [eng.add_request(p, sp_cls(max_new_tokens=n)) for p in prompts[:2]]
    outs = eng.step() + eng.step()
    reqs.append(eng.add_request(prompts[2], sp_cls(max_new_tokens=n)))
    outs += eng.run()
    got = {o.request_id: list(o.token_ids) for o in outs}
    return [got[r.request_id] for r in reqs], eng


def port_streams(case, prompts, n, **kw):
    model_type, _, cfg, sd = _case(case)
    app = port_family_app(model_type, cfg, sd=sd, **CASE_KW.get(case, {}), **kw)
    return serve(InferenceEngine, SamplingParams, SchedulerConfig, app, prompts, n)


def jax_streams(case, prompts, n, **kw):
    model_type, _, cfg, sd = _case(case)
    app = jax_family_app(model_type, cfg, sd, **CASE_KW.get(case, {}), **kw)
    return serve(JaxEngine, JaxSP, JaxSC, app, prompts, n)


def hf_streams(case, prompts, n):
    model = _case(case)[1]
    return [hf_greedy(model, np.array([p]), n)[0, len(p):].tolist() for p in prompts]


@pytest.mark.parametrize("case", sorted(JAX_MIXED))
def test_mixed_matches_the_jax_mixed_engine(case):
    """Streams equal the JAX mixed engine's (and HF greedy where
    transformers has the class) and every mixed dispatch's logits lie within
    1e-4 of the JAX dispatch's; every dispatch is a mixed one."""
    prompts, n = JAX_MIXED[case]
    model_type, model, cfg, sd = _case(case)
    japp = jax_family_app(model_type, cfg, sd, **CASE_KW.get(case, {}), **MIXED)
    tapp = port_family_app(model_type, cfg, sd=sd, **CASE_KW.get(case, {}), **MIXED)
    jlog, tlog = [], []
    _mixed_logits(japp, jlog)
    _mixed_logits(tapp, tlog)
    want, _ = serve(JaxEngine, JaxSP, JaxSC, japp, prompts, n)
    got, eng = serve(InferenceEngine, SamplingParams, SchedulerConfig, tapp, prompts, n)
    assert got == want
    if model is not None:
        assert got == hf_streams(case, prompts, n)
    assert len(tlog) == len(jlog) == eng.dispatches[TAG_MIXED] == sum(eng.dispatches.values())
    for t, j in zip(tlog, jlog):
        np.testing.assert_allclose(t, j, atol=LOGIT_TOL, rtol=0)
    strategies = {s for ss in tapp.models[TAG_MIXED].attention_strategies.values() for s in ss}
    assert "mixed_ragged_xla" in strategies and "mixed_ragged_kernel" not in strategies


@pytest.mark.parametrize("case", SPLIT)
def test_mixed_matches_the_split_engines_past_the_window(case):
    """A window, a chunk, sinks or softcaps, 12-token prompts and 12 new
    tokens (past the window or chunk of 8): the port's mixed streams equal
    the JAX split engine's, the port's split engine's and HF greedy (where
    transformers has the class); on Mistral's window the JAX mixed
    engine's stream leaves them."""
    got, eng = port_streams(case, LONG, 12, **MIXED)
    assert eng.dispatches[TAG_MIXED] == sum(eng.dispatches.values()) > 0
    split, _ = port_streams(case, LONG, 12, **PAGED)
    jsplit, _ = jax_streams(case, LONG, 12, **PAGED)
    assert got == split == jsplit
    if _case(case)[1] is not None:
        assert got == hf_streams(case, LONG, 12)
    if case == "mistral":
        jmixed, _ = jax_streams(case, LONG, 12, **MIXED)
        assert jmixed != got  # the JAX mixed step drops the window


def test_mixed_builds_and_serves_on_every_switch():
    """Every switch ``family_switches`` can name (and Gemma-3's local rope
    pair) is on in some case, and each case's mixed engine serves the same
    streams as its split engine."""
    import inspect
    import re

    from test_torch_family_spec import config

    seen = set()
    for case in sorted(ALL_CASES):
        model_type, _, cfg, _ = _case(case)
        fam, c = config(False, model_type, cfg, **CASE_KW.get(case, {}), **MIXED)
        seen |= {s.split("=")[0] for s in family_switches(fam.build_arch(c))}
        if local_rope(fam, c):
            seen.add("use_local_rope")
        if case in JAX_MIXED or case in SPLIT:
            continue
        got, eng = port_streams(case, SHORT, 6, **MIXED)
        assert eng.dispatches[TAG_MIXED] == sum(eng.dispatches.values())
        assert got == port_streams(case, SHORT, 6, **PAGED)[0]
    want = set(re.findall(r'^\s*\(f?"([a-z_0-9]+)', inspect.getsource(family_switches), re.M))
    assert want | {"use_local_rope"} <= seen, sorted(want - seen)
