"""The port's contiguous continuous-batching engine (slot = cache line, rows
routed by ``seq_ids``) and the sampled paths of ``generate()`` and the
engines, on the CPU (plain versions), against the JAX package's engine and
adapter (Pallas kernels in interpret mode) and HF greedy.

Greedy streams of the port's engine must equal the JAX engine's over the
same traffic, decoding 1-step, in K-step windows and through the device
loop. Where the JAX reference is a standing red (one request in a window,
its padding lane sharing row 0's cache line: ROADMAP Queue 3) the port is
pinned to its own 1-step stream and HF greedy instead. Sampled decode has no
JAX counterpart with the same random bits: it is held to itself (one key
schedule for every path, seeded runs repeat)."""

import numpy as np
import pytest
import torch

from nxdi_tpu.config import OnDeviceSamplingConfig as JaxODSC
from nxdi_tpu.config import TpuConfig
from nxdi_tpu.generation.hf_adapter import HuggingFaceGenerationAdapter as JaxAdapter
from nxdi_tpu.models.llama import modeling_llama as jml
from nxdi_tpu.runtime.application import TpuModelForCausalLM
from nxdi_tpu.serving import InferenceEngine as JaxEngine
from nxdi_tpu.serving import SamplingParams as JaxSP
from nxdi_tpu.serving import SchedulerConfig as JaxSC
from nxdi_tpu.utils.accuracy import hf_greedy_generate
from nxdi_tpu_torch.config import OnDeviceSamplingConfig, TorchConfig
from nxdi_tpu_torch.generation.hf_adapter import HuggingFaceGenerationAdapter
from nxdi_tpu_torch.models.llama import modeling_llama as tml
from nxdi_tpu_torch.runtime.application import TorchModelForCausalLM
from nxdi_tpu_torch.runtime.model_wrapper import (
    TAG_CONTEXT_ENCODING,
    TAG_DEVICE_LOOP,
    TAG_TOKEN_GENERATION,
    TAG_TOKEN_GENERATION_MULTISTEP,
)
from nxdi_tpu_torch.serving import InferenceEngine, SamplingParams, SchedulerConfig
from test_torch_slice import fresh_jax_compiles

P0 = [5, 9, 3, 17, 2, 8]
P1 = [7, 13, 21, 4, 33]
P2 = [9, 9, 2, 40, 17, 3, 11]
SAMPLED = dict(do_sample=True, top_k=50, top_p=0.9, temperature=0.8)


@pytest.fixture(autouse=True, scope="module")
def _fresh_jax_compiles():
    with fresh_jax_compiles():
        yield


@pytest.fixture(scope="module")
def tiny():
    from transformers import LlamaConfig, LlamaForCausalLM

    torch.manual_seed(0)
    cfg = LlamaConfig(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                      num_attention_heads=4, num_key_value_heads=2, vocab_size=256,
                      max_position_embeddings=256, rms_norm_eps=1e-5, tie_word_embeddings=False)
    return LlamaForCausalLM(cfg).eval(), cfg


def _cb(**kw):
    d = dict(tp_degree=1, seq_len=64, max_context_length=32, batch_size=2, dtype="float32",
             skip_warmup=True, is_continuous_batching=True, ctx_batch_size=2,
             tkg_batch_size=2, kv_cache_batch_size=2)
    d.update(kw)
    return d


def jax_app(tiny, **kw):
    hf, cfg = tiny
    sd = {k: v.detach().numpy() for k, v in hf.state_dict().items()}
    odsc = kw.pop("odsc", {})
    c = jml.LlamaInferenceConfig(TpuConfig(on_device_sampling_config=JaxODSC(**odsc), **kw),
                                 load_config=lambda: cfg.to_dict())

    class App(TpuModelForCausalLM):
        def get_state_dict(self):
            return sd

    app = App("<memory>", c, model_family=jml)
    app.load()
    return app


def port_app(tiny, **kw):
    hf, cfg = tiny
    sd = {k: v.detach() for k, v in hf.state_dict().items()}
    odsc = kw.pop("odsc", {})
    c = tml.LlamaInferenceConfig(TorchConfig(on_device_sampling_config=OnDeviceSamplingConfig(
        **odsc), **kw), load_config=lambda: cfg.to_dict())

    class App(TorchModelForCausalLM):
        def get_state_dict(self):
            return sd

    app = App("<memory>", c, model_family=tml, device="cpu")
    app.load()
    return app


def _drive(engine, sp_cls, prompts, params, arrivals):
    """Requests arrive before the engine step given by ``arrivals``; returns
    the streams in request order."""
    reqs, outs, step = [None] * len(prompts), [], 0
    while engine.has_work() or any(r is None for r in reqs):
        for i, a in enumerate(arrivals):
            if reqs[i] is None and a <= step:
                reqs[i] = engine.add_request(prompts[i], sp_cls(**params[i]))
        outs += engine.step()
        step += 1
        assert step < 300, "engine failed to drain"
    got = {o.request_id: o.token_ids for o in outs}
    return [got[r.request_id] for r in reqs]


PROMPTS = [P0, P1, P2]
ARRIVALS = [0, 0, 2]


@pytest.fixture(scope="module")
def eos(tiny):
    """EOS ids the streams hit mid-run: P1's 4th greedy token."""
    hf, _ = tiny
    return int(hf_greedy_generate(hf, np.array([P1]), 8)[0, len(P1) + 3])


MODES = {"1-step": {}, "K-step": dict(decode_steps_per_dispatch=4),
         "loop": dict(device_loop=True), "loop-fence": dict(device_loop=True,
                                                             device_loop_fence=3)}
# the JAX engine's K-step windows are a standing red on this traffic (rows
# with different budgets in one window: request 0's stream leaves HF greedy
# at its 7th token, the family of test_device_loop.py::
# test_scan_path_unclamped_heterogeneous_budgets): there the port is held to
# its own 1-step engine and HF greedy
JAX_RED = {"K-step"}


@pytest.mark.parametrize("mode", list(MODES))
def test_greedy_streams_match_jax_engine(tiny, eos, mode):
    """Interleaved arrivals (the third request arrives mid-stream), an EOS
    finish (request 1) and length finishes: the port's streams equal the JAX
    contiguous engine's with the same flags (its 1-step engine's where the
    JAX engine is red), and HF greedy per request."""
    hf, _ = tiny
    params = [dict(max_new_tokens=10), dict(max_new_tokens=12, eos_token_ids=(eos,)),
              dict(max_new_tokens=7)]
    sched = dict(num_slots=2, max_prefills_per_step=2)
    if mode in JAX_RED:
        ref_engine = InferenceEngine(port_app(tiny, **_cb()), SchedulerConfig(**sched))
        want = _drive(ref_engine, SamplingParams, PROMPTS, params, ARRIVALS)
    else:
        jeng = JaxEngine(jax_app(tiny, **_cb(**MODES[mode])), JaxSC(**sched))
        want = _drive(jeng, JaxSP, PROMPTS, params, ARRIVALS)
    teng = InferenceEngine(port_app(tiny, **_cb(**MODES[mode])), SchedulerConfig(**sched))
    got = _drive(teng, SamplingParams, PROMPTS, params, ARRIVALS)
    assert got == want
    assert len(got[1]) < 12 and got[1][-1] == eos  # an EOS finish
    for p, s, prm in zip(PROMPTS, got, params):
        ref = hf_greedy_generate(hf, np.array([p]), prm["max_new_tokens"])[0, len(p):].tolist()
        assert s == ref[:len(s)]
    disp = teng.dispatches
    if mode == "K-step":
        assert disp[TAG_TOKEN_GENERATION_MULTISTEP] > 0
    if mode.startswith("loop"):
        assert disp[TAG_DEVICE_LOOP] == teng.loop_launches > 0
        assert teng.loop_tokens == sum(len(s) for s in got) - len(got)
    if mode == "loop":
        assert disp[TAG_TOKEN_GENERATION] == 0


@pytest.mark.parametrize("mode", ["K-step", "loop"])
def test_single_request_windows_pin_to_one_step(tiny, eos, mode):
    """One request in a window of two rows (the padding lane shares its
    line): streams equal the port's 1-step engine and HF greedy, an EOS
    inside a window finishes the row exactly there, and the budget is never
    overshot."""
    hf, _ = tiny
    one = InferenceEngine(port_app(tiny, **_cb()), SchedulerConfig(num_slots=2))
    many = InferenceEngine(port_app(tiny, **_cb(**MODES[mode])), SchedulerConfig(num_slots=2))
    for prm in (dict(max_new_tokens=6), dict(max_new_tokens=12, eos_token_ids=(eos,)),
                dict(max_new_tokens=9)):
        a = _drive(one, SamplingParams, [P1], [prm], [0])
        b = _drive(many, SamplingParams, [P1], [prm], [0])
        assert a == b
        ref = hf_greedy_generate(hf, np.array([P1]), prm["max_new_tokens"])[0, len(P1):]
        assert b[0] == ref[:len(b[0])].tolist() and len(b[0]) <= prm["max_new_tokens"]
    assert many.dispatches[TAG_TOKEN_GENERATION] == 0 or mode == "K-step"


def test_engine_construction_rules(tiny):
    static = port_app(tiny, **_cb(is_continuous_batching=False))
    with pytest.raises(ValueError, match="continuous-batching"):
        InferenceEngine(static)
    cb = port_app(tiny, **_cb())
    with pytest.raises(ValueError, match="prefix_cache requires the paged"):
        InferenceEngine(cb, SchedulerConfig(prefix_cache=True))
    with pytest.raises(ValueError, match="num_slots"):
        InferenceEngine(cb, SchedulerConfig(num_slots=3))
    with pytest.raises(ValueError, match="seq_ids must lie"):
        cb.forward(np.array([P0], np.int32), np.arange(len(P0), dtype=np.int32)[None],
                   seq_ids=np.array([2], np.int32))


def _sampled_engine(tiny, seed, **kw):
    return InferenceEngine(port_app(tiny, odsc=dict(do_sample=True), **_cb(**kw)),
                           SchedulerConfig(num_slots=2, max_prefills_per_step=2), seed=seed)


def test_sampled_engine_paths_draw_one_stream(tiny):
    """Sampled (top_k 50, top_p 0.9, temperature 0.8), both requests prefilled
    in one step with equal budgets: the 1-step engine, K-step windows (rungs
    2 and 4: two windows of 4, then a 1-step dispatch, so the schedule must
    advance past each window's keys), the loop (fenced, so the schedule
    advances between launches) and a seeded rerun give one stream; another
    seed another; greedy rows in the sampled app stay the greedy stream."""
    params = [dict(max_new_tokens=10, **SAMPLED)] * 2
    one = _drive(_sampled_engine(tiny, 3), SamplingParams, [P0, P1], params, [0, 0])
    kstep_eng = _sampled_engine(tiny, 3, decode_steps_per_dispatch=4)
    kstep = _drive(kstep_eng, SamplingParams, [P0, P1], params, [0, 0])
    assert kstep_eng.dispatches[TAG_TOKEN_GENERATION_MULTISTEP] == 2
    loop = _drive(_sampled_engine(tiny, 3, device_loop=True, device_loop_fence=4),
                  SamplingParams, [P0, P1], params, [0, 0])
    again = _drive(_sampled_engine(tiny, 3), SamplingParams, [P0, P1], params, [0, 0])
    other = _drive(_sampled_engine(tiny, 4), SamplingParams, [P0, P1], params, [0, 0])
    assert one == kstep == loop == again
    assert one != other
    greedy = [dict(max_new_tokens=10)] * 2
    g_sampled_app = _drive(_sampled_engine(tiny, 3), SamplingParams, [P0, P1], greedy, [0, 0])
    g_greedy_app = _drive(InferenceEngine(port_app(tiny, **_cb()), SchedulerConfig(
        num_slots=2, max_prefills_per_step=2)), SamplingParams, [P0, P1], greedy, [0, 0])
    assert g_sampled_app == g_greedy_app


def test_sampled_siblings_sample_apart(tiny):
    """``n = 2``: the siblings draw different uniforms (their rows differ),
    so their continuations differ; the run repeats under its seed."""
    def run():
        eng = _sampled_engine(tiny, 9)
        eng.add_request(P0, SamplingParams(max_new_tokens=12, n=2, **SAMPLED))
        return [o.token_ids for o in eng.run()]

    a = run()
    assert len(a) == 2 and a[0] != a[1]
    assert run() == a


def _paged(**kw):
    d = dict(tp_degree=1, seq_len=64, max_context_length=32, batch_size=1, ctx_batch_size=1,
             tkg_batch_size=2, dtype="float32", skip_warmup=True, is_block_kv_layout=True,
             pa_block_size=8, pa_num_blocks=32)
    d.update(kw)
    return d


@pytest.mark.parametrize("mixed", [False, True])
def test_sampled_paged_engines(tiny, mixed):
    """Sampled serving on the paged pool, split and mixed dispatch: a seeded
    run repeats, n = 2 siblings differ, and greedy requests in the sampled
    app equal the greedy app's (and HF greedy)."""
    hf, _ = tiny
    kw = dict(mixed_dispatch=True) if mixed else {}

    def run(seed, params, do_sample=True):
        app = port_app(tiny, odsc=dict(do_sample=do_sample), **_paged(**kw))
        eng = InferenceEngine(app, SchedulerConfig(num_slots=2), seed=seed)
        reqs = [eng.add_request(P0, params), eng.add_request(P2, params)]
        got = {o.request_id: o.token_ids for o in eng.run()}
        return [got[r.request_id] for r in reqs]

    sp = SamplingParams(max_new_tokens=10, **SAMPLED)
    a = run(5, sp)
    assert run(5, sp) == a and run(6, sp) != a
    greedy = SamplingParams(max_new_tokens=10)
    g = run(5, greedy)
    assert g == run(5, greedy, do_sample=False)
    assert g[0] == hf_greedy_generate(hf, np.array([P0]), 10)[0, len(P0):].tolist()
    app = port_app(tiny, odsc=dict(do_sample=True), **_paged(**kw))
    eng = InferenceEngine(app, SchedulerConfig(num_slots=2), seed=1)
    eng.add_request(P0, SamplingParams(max_new_tokens=8, n=2, **SAMPLED))
    sib = [o.token_ids for o in eng.run()]
    assert sib[0] != sib[1]


def _static(**kw):
    d = dict(tp_degree=1, seq_len=64, max_context_length=32, batch_size=2, dtype="float32",
             skip_warmup=True)
    d.update(kw)
    return d


PROMPT = np.array([[5, 9, 3, 17, 2, 0, 0], [7, 13, 21, 4, 33, 8, 9]])


def test_generate_logits_processor_matches_jax(tiny):
    """HF ``RepetitionPenaltyLogitsProcessor`` on the host over the emitted
    logits, greedy: tokens equal the JAX adapter's."""
    from transformers import RepetitionPenaltyLogitsProcessor

    jax_out = JaxAdapter(jax_app(tiny, output_logits=True, **_static())).generate(
        PROMPT, max_new_tokens=12, logits_processor=[RepetitionPenaltyLogitsProcessor(1.5)])
    port = HuggingFaceGenerationAdapter(port_app(tiny, output_logits=True, **_static()))
    got = port.generate(PROMPT, max_new_tokens=12,
                        logits_processor=[RepetitionPenaltyLogitsProcessor(1.5)])
    np.testing.assert_array_equal(got, jax_out)
    plain = port.generate(PROMPT, max_new_tokens=12)
    assert not (plain == got).all()  # the penalty changed the stream
    with pytest.raises(ValueError, match="output_logits"):
        HuggingFaceGenerationAdapter(port_app(tiny, **_static())).generate(
            PROMPT, max_new_tokens=4, logits_processor=[RepetitionPenaltyLogitsProcessor(1.5)])
    # sampled on the host: the same sampler, the adapter's key schedule
    a = port.generate(PROMPT, max_new_tokens=12, seed=3, **SAMPLED,
                      logits_processor=[RepetitionPenaltyLogitsProcessor(1.5)])
    b = port.generate(PROMPT, max_new_tokens=12, seed=3, **SAMPLED,
                      logits_processor=[RepetitionPenaltyLogitsProcessor(1.5)])
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("eos_row", [None, 0])
def test_sampled_generate_paths_draw_one_stream(tiny, eos_row):
    """generate(do_sample=True, seed=...): the sync loop, the async chain and
    K-step windows (K 4, then the tail rung) give one stream; with an EOS
    mid-run the windows trim like the loops."""
    kw = dict(max_new_tokens=14, seed=7, **SAMPLED)
    sync = HuggingFaceGenerationAdapter(port_app(tiny, odsc=dict(do_sample=True), **_static()))
    ref = sync.generate(PROMPT, **kw)
    if eos_row is not None:
        kw["eos_token_id"] = int(ref[eos_row, 5 + 4])
        ref = sync.generate(PROMPT, **kw)
    asy = HuggingFaceGenerationAdapter(port_app(tiny, odsc=dict(do_sample=True),
                                                **_static(async_mode=True)))
    ms = HuggingFaceGenerationAdapter(port_app(tiny, odsc=dict(do_sample=True),
                                               **_static(decode_steps_per_dispatch=4)))
    np.testing.assert_array_equal(asy.generate(PROMPT, **kw), ref)
    np.testing.assert_array_equal(ms.generate(PROMPT, **kw), ref)
    assert not (sync.generate(PROMPT, **dict(kw, seed=8)) == ref).all()


def test_generate_multistep_greedy_matches_jax(tiny):
    """Greedy K-step windows of generate() against the JAX adapter's."""
    jax_out = JaxAdapter(jax_app(tiny, **_static(decode_steps_per_dispatch=4))).generate(
        PROMPT, max_new_tokens=13)
    got = HuggingFaceGenerationAdapter(port_app(tiny, **_static(
        decode_steps_per_dispatch=4))).generate(PROMPT, max_new_tokens=13)
    np.testing.assert_array_equal(got, jax_out)


def test_generation_config_supplies_unset_arguments(tiny):
    from transformers import GenerationConfig

    app = port_app(tiny, odsc=dict(do_sample=True), **_static())
    ad = HuggingFaceGenerationAdapter(app)
    gc = GenerationConfig(max_new_tokens=9, do_sample=True, top_k=50, top_p=0.9,
                          temperature=0.8)
    a = ad.generate(PROMPT, generation_config=gc, seed=2)
    b = ad.generate(PROMPT, max_new_tokens=9, seed=2, **SAMPLED)
    np.testing.assert_array_equal(a, b)
    assert a.shape[1] == PROMPT.shape[1] + 9
    assert app.models[TAG_CONTEXT_ENCODING].needs_rng
