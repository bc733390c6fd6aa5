"""The port's K-step decode (``multi_step_token_gen``, the ``tkg_multistep``
submodel) and device loop (``device_loop_token_gen``, ``tkg_device_loop``)
on the contiguous continuous-batching cache, held against the JAX package's
on the CPU (plain versions; its Pallas kernels in interpret mode).

Both apps are built from one tiny random HF llama (2 layers, hidden 64,
vocab 256, float32) and prefilled with the same prompts into routed cache
lines; then the same window goes through both wrappers: greedy tokens must
be equal, ``loop_iters`` equal, and the final caches within 1e-5. A window
with a padding lane (which shares row 0's cache line) is pinned to the
port's own 1-step greedy stream instead: the JAX package's test of that
shape is a standing red (ROADMAP Queue 3). Sampled windows are held within
the port: a K-step window equals K chained 1-step dispatches, and the loop
equals the 1-step host key schedule."""

import numpy as np
import pytest
import torch

import jax

from nxdi_tpu.config import OnDeviceSamplingConfig as JaxODSC
from nxdi_tpu.config import TpuConfig
from nxdi_tpu.models.llama import modeling_llama as jml
from nxdi_tpu.runtime import autobucketing as jab
from nxdi_tpu.runtime.application import TpuModelForCausalLM
from nxdi_tpu_torch.config import OnDeviceSamplingConfig, TorchConfig
from nxdi_tpu_torch.models.llama import modeling_llama as tml
from nxdi_tpu_torch.runtime import autobucketing as tab
from nxdi_tpu_torch.runtime.application import TorchModelForCausalLM
from nxdi_tpu_torch.runtime.model_wrapper import TAG_DEVICE_LOOP, TAG_TOKEN_GENERATION_MULTISTEP
from test_torch_slice import fresh_jax_compiles

P0 = [5, 9, 3, 17, 2, 8]
P1 = [7, 13, 21, 4, 33, 40, 11, 2, 6]
LINES = [1, 0]  # row 0 decodes in cache line 1, row 1 in line 0
CACHE_TOL = 1e-5  # float32 caches after the same window (measured ~1e-7)


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
    hf = LlamaForCausalLM(cfg).eval()
    return {k: v.detach().numpy() for k, v in hf.state_dict().items()}, cfg


def _common(**kw):
    d = dict(tp_degree=1, seq_len=64, max_context_length=32, batch_size=2, dtype="float32",
             skip_warmup=True, is_continuous_batching=True, ctx_batch_size=2,
             tkg_batch_size=2, kv_cache_batch_size=2, decode_steps_per_dispatch=4,
             device_loop=True)
    d.update(kw)
    return d


def jax_app(tiny, **kw):
    sd, cfg = tiny
    odsc = kw.pop("odsc", {})
    c = jml.LlamaInferenceConfig(TpuConfig(on_device_sampling_config=JaxODSC(**odsc),
                                           **_common(**kw)), load_config=lambda: cfg.to_dict())

    class App(TpuModelForCausalLM):
        def get_state_dict(self):
            return sd

    app = App("<memory>", c, model_family=jml)
    app.load()
    return app


def port_app(tiny, **kw):
    sd, cfg = tiny
    odsc = kw.pop("odsc", {})
    c = tml.LlamaInferenceConfig(TorchConfig(on_device_sampling_config=OnDeviceSamplingConfig(
        **odsc), **_common(**kw)), load_config=lambda: cfg.to_dict())

    class App(TorchModelForCausalLM):
        def get_state_dict(self):
            return {k: torch.from_numpy(v) for k, v in sd.items()}

    app = App("<memory>", c, model_family=tml, device="cpu")
    app.load()
    return app


def _tok(out):
    t = out["tokens"]
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(jax.device_get(t))


def _prefill(app, rows=((P0, 1), (P1, 0)), rng=None):
    """Prefill each (prompt, line); returns each row's first token."""
    first = []
    for i, (p, line) in enumerate(rows):
        kw = {} if rng is None else {"rng": rng + np.array([0, i])}
        out = app.forward(np.array([p], np.int32), np.arange(len(p), dtype=np.int32)[None],
                          last_token_index=np.array([len(p) - 1], np.int32),
                          seq_ids=np.array([line], np.int32), **kw)
        first.append(int(_tok(out)[0, 0]))
    return np.array(first, np.int32)


def _window(first, rows=((P0, 1), (P1, 0)), **extra):
    return dict(input_ids=first[:, None], last_token_index=np.zeros(len(first), np.int32),
                position_ids=np.array([[len(p)] for p, _ in rows], np.int32),
                seq_ids=np.array([line for _, line in rows], np.int32), **extra)


def _one_step_stream(app, first, n, rows=((P0, 1), (P1, 0)), rng=None):
    """n chained 1-step dispatches from ``first`` (the host loop): (b, n)."""
    toks, pos, out = first, np.array([[len(p)] for p, _ in rows], np.int32), []
    for i in range(n):
        kw = {} if rng is None else {"rng": rng + np.array([0, i])}
        toks = _tok(app.forward(toks[:, None].astype(np.int32), pos,
                                last_token_index=np.zeros(len(toks), np.int32),
                                seq_ids=np.array([line for _, line in rows], np.int32),
                                **kw))[:, 0]
        out.append(toks)
        pos = pos + 1
    return np.stack(out, axis=1)


def _same_caches(japp, tapp):
    for key in ("k", "v"):
        np.testing.assert_allclose(tapp.kv_cache[key].numpy(),
                                   np.asarray(jax.device_get(japp.kv_cache[key])),
                                   atol=CACHE_TOL, rtol=CACHE_TOL)


@pytest.fixture(scope="module")
def probe(tiny):
    """The port's 1-step greedy streams of the two rows (12 tokens)."""
    app = port_app(tiny)
    first = _prefill(app)
    return first, _one_step_stream(app, first, 12)


@pytest.mark.parametrize("steps", [2, 4])
def test_multistep_greedy_matches_jax(tiny, probe, steps):
    """One K-step window with an EOS mid-window (row 0) and a budget (row 1
    stops after 3 tokens when K = 4): tokens equal, caches within 1e-5."""
    first, stream = probe
    eos = np.full((2, 8), -1, np.int32)
    eos[0, 0] = stream[0, 1]
    budgets = np.array([0, 3 if steps == 4 else 0], np.int32)
    japp, tapp = jax_app(tiny), port_app(tiny)
    np.testing.assert_array_equal(_prefill(tapp), _prefill(japp))
    batch = _window(first, eos_token_ids=eos, pad_token_id=np.zeros(2, np.int32),
                    budget_steps=budgets, decode_steps=steps)
    want, got = _tok(japp.token_gen_multistep(dict(batch))), _tok(tapp.token_gen_multistep(batch))
    np.testing.assert_array_equal(got, want)
    assert got.shape == (2, steps)
    # row 0: its stream up to the EOS, then the pad token
    np.testing.assert_array_equal(got[0, :2], stream[0, :2])
    assert (got[0, 2:] == 0).all()
    _same_caches(japp, tapp)


def test_device_loop_greedy_matches_jax(tiny, probe):
    """One loop launch with heterogeneous budgets (7 and 3) and an EOS
    (row 0 at its 5th token): tokens (b, cap), ``loop_iters`` equal, caches
    within 1e-5; the rows' tokens are the 1-step streams up to their halt."""
    first, stream = probe
    eos = np.full((2, 8), -1, np.int32)
    eos[0, 0] = stream[0, 4]
    japp, tapp = jax_app(tiny), port_app(tiny)
    np.testing.assert_array_equal(_prefill(tapp), _prefill(japp))
    batch = _window(first, eos_token_ids=eos, pad_token_id=np.zeros(2, np.int32),
                    budget_steps=np.array([7, 3], np.int32))
    jout, tout = japp.token_gen_device_loop(dict(batch)), tapp.token_gen_device_loop(batch)
    np.testing.assert_array_equal(_tok(tout), _tok(jout))
    assert int(tout["loop_iters"]) == int(jax.device_get(jout["loop_iters"])) == 5
    np.testing.assert_array_equal(_tok(tout)[0, :5], stream[0, :5])
    np.testing.assert_array_equal(_tok(tout)[1, :3], stream[1, :3])
    _same_caches(japp, tapp)


def test_device_loop_unlimited_budget_runs_to_cap_matches_jax(tiny, probe):
    first, _ = probe
    japp, tapp = jax_app(tiny), port_app(tiny)
    _prefill(japp), _prefill(tapp)
    batch = _window(first, loop_cap=8)
    jout, tout = japp.token_gen_device_loop(dict(batch)), tapp.token_gen_device_loop(batch)
    np.testing.assert_array_equal(_tok(tout), _tok(jout))
    assert int(tout["loop_iters"]) == int(jax.device_get(jout["loop_iters"])) == 8
    _same_caches(japp, tapp)


@pytest.mark.parametrize("steps", [2, 4])
def test_padding_lane_window_pins_to_one_step(tiny, steps):
    """One real row in a batch of two: the padding lane repeats row 0 (its
    cache line, its inputs) with a budget of 1, so it freezes after one
    identical write; row 0's K-step tokens and loop tokens are its 1-step
    stream and its cache line is the 1-step run's."""
    rows = ((P1, 1),)
    ref = port_app(tiny)
    first = _prefill(ref, rows)
    stream = _one_step_stream(ref, first, 7, rows)
    ms = port_app(tiny)
    _prefill(ms, rows)
    got = _tok(ms.token_gen_multistep(_window(first, rows, decode_steps=steps)))
    np.testing.assert_array_equal(got[0], stream[0, :steps])
    lp = port_app(tiny)
    _prefill(lp, rows)
    out = lp.token_gen_device_loop(_window(first, rows, budget_steps=np.array([7], np.int32)))
    np.testing.assert_array_equal(_tok(out)[0, :7], stream[0])
    assert int(out["loop_iters"]) == 7
    end = len(P1) + 7  # the loop wrote positions [len(P1), len(P1) + 7)
    for key in ("k", "v"):
        torch.testing.assert_close(lp.kv_cache[key][:, 1, :, :end], ref.kv_cache[key][:, 1, :, :end],
                                   atol=CACHE_TOL, rtol=CACHE_TOL)


SAMPLED = dict(do_sample=True, top_k=50, top_p=0.9, temperature=0.8)


def _sampled_window(first, **extra):
    from nxdi_tpu_torch.ops.sampling import SamplingParams

    return _window(first, sampling_params=SamplingParams(**SAMPLED).tensor(2), **extra)


def test_sampled_kstep_equals_chained_one_step(tiny):
    """A sampled K-step window with key (seed, c) draws step t with
    (seed, c + t): the tokens of 4 chained 1-step dispatches with those
    keys."""
    from nxdi_tpu_torch.ops.sampling import SamplingParams

    key = np.array([9, 100], np.int64)
    one = port_app(tiny, odsc=dict(do_sample=True))
    first = _prefill(one, rng=np.array([9, 1]))
    sp = SamplingParams(**SAMPLED).tensor(2)
    toks, pos, ref = first, np.array([[len(P0)], [len(P1)]], np.int32), []
    for i in range(8):
        toks = _tok(one.forward(toks[:, None], pos, last_token_index=np.zeros(2, np.int32),
                                seq_ids=np.array(LINES, np.int32), sampling_params=sp,
                                rng=key + np.array([0, i])))[:, 0]
        ref.append(toks)
        pos = pos + 1
    ref = np.stack(ref, axis=1)
    ms = port_app(tiny, odsc=dict(do_sample=True))
    np.testing.assert_array_equal(_prefill(ms, rng=np.array([9, 1])), first)
    out = ms.token_gen_multistep(_sampled_window(first, decode_steps=4, rng=key))
    got = [_tok(out).copy()]
    # the second window chains on the device from the first's next_inputs
    out = ms.token_gen_multistep_device(out["next_inputs"], len(P1) + 9, steps=4)
    got.append(_tok(out)[:2])
    np.testing.assert_array_equal(np.concatenate(got, axis=1), ref)
    assert len(set(map(tuple, ref.tolist()))) == 2


def test_sampled_loop_equals_one_step_schedule(tiny):
    """The loop's iteration t draws (seed, c + t): the tokens of chained
    1-step dispatches keyed c, c + 1, ...; a host schedule advanced by
    loop_iters - 1 lands on the next dispatch's key."""
    from nxdi_tpu_torch.ops.sampling import SamplingParams, StepRngSchedule

    sched = StepRngSchedule(21)
    one = port_app(tiny, odsc=dict(do_sample=True))
    first = _prefill(one, rng=np.array([21, 1]))
    sp = SamplingParams(**SAMPLED).tensor(2)
    sched.counter = 5
    toks, pos, ref = first, np.array([[len(P0)], [len(P1)]], np.int32), []
    for _ in range(6):
        toks = _tok(one.forward(toks[:, None], pos, last_token_index=np.zeros(2, np.int32),
                                seq_ids=np.array(LINES, np.int32), sampling_params=sp,
                                rng=sched.next()))[:, 0]
        ref.append(toks)
        pos = pos + 1
    after_one_step = sched.next()
    lp = port_app(tiny, odsc=dict(do_sample=True))
    _prefill(lp, rng=np.array([21, 1]))
    sched = StepRngSchedule(21)
    sched.counter = 5
    out = lp.token_gen_device_loop(_sampled_window(
        first, rng=sched.next(), budget_steps=np.array([6, 6], np.int32)))
    iters = int(out["loop_iters"])
    np.testing.assert_array_equal(_tok(out)[:, :6], np.stack(ref, axis=1))
    sched.advance(iters - 1)
    np.testing.assert_array_equal(sched.next(), after_one_step)


def test_graph_key_is_chosen_by_the_dispatch_alone(tiny):
    """The K-step and loop wrappers take their (rung, bucket) graph key from
    the host batch alone, whatever the dispatch before it chose; the budgets
    are padded by ``_pad_budget_rows`` only (padding lanes get 1)."""
    app = port_app(tiny)
    ks, lp = app.models[TAG_TOKEN_GENERATION_MULTISTEP], app.models[TAG_DEVICE_LOOP]
    assert "budget_steps" not in ks.extra_inputs and "budget_steps" not in lp.extra_inputs
    first = np.array([3, 4], np.int32)
    one_row = _window(first[:1], rows=((P0, 1),), budget_steps=np.array([2], np.int32))
    unlimited = _window(first, budget_steps=np.array([0, 5], np.int32))
    key_small, b, host = lp.host_inputs(one_row)
    assert b == 1 and host["budget_steps"].tolist() == [2, 1]
    key_big = lp.host_inputs(unlimited)[0]
    assert key_small == (lp.select_cap(2), key_small[1]) and key_big[0] == lp.max_cap
    assert lp.host_inputs(one_row)[0] == key_small  # not the previous dispatch's cap
    assert ks.host_inputs(dict(unlimited, decode_steps=2))[0][0] == 2
    assert ks.host_inputs(unlimited)[0][0] == ks.max_steps  # the default, not the last rung
    with pytest.raises(ValueError, match="not a rung"):
        ks.host_inputs(dict(unlimited, decode_steps=3))


def test_loop_outfeed_ring_matches_buffered_result(tiny):
    """``device_loop_outfeed=True`` on the CPU: every iteration's (t, tokens,
    done) in iteration order, equal to the buffered tokens; done monotone and
    all true at the end. Off, the ring is empty."""
    app = port_app(tiny, device_loop_outfeed=True)
    first = _prefill(app)
    out = app.token_gen_device_loop(_window(first, budget_steps=np.array([5, 3], np.int32)))
    ring = app.models[TAG_DEVICE_LOOP].drain_outfeed()
    assert [e[0] for e in ring] == list(range(int(out["loop_iters"]))) == list(range(5))
    toks = _tok(out)
    for t, row, done in ring:
        np.testing.assert_array_equal(row, toks[:, t])
    done = np.stack([e[2] for e in ring])
    assert (np.diff(done.astype(np.int8), axis=0) >= 0).all() and done[-1].all()
    assert done[2].tolist() == [False, True]  # row 1's budget of 3 ends at t = 2
    off = port_app(tiny)
    _prefill(off)
    off.token_gen_device_loop(_window(first, budget_steps=np.array([5, 3], np.int32)))
    assert off.models[TAG_DEVICE_LOOP].drain_outfeed() == []


@pytest.mark.parametrize("k", [1, 2, 3, 6, 8, 13])
def test_ladders_match_jax(k):
    assert tab.multistep_step_ladder(k) == jab.multistep_step_ladder(k)
    assert tab.device_loop_budget_ladder(k * 3) == jab.device_loop_budget_ladder(k * 3)
    ladder = tab.device_loop_budget_ladder(40)
    assert tab.get_target_steps(k, ladder) == jab.get_target_steps(k, ladder)


def test_config_rules_match_jax():
    """The JAX package's rules for the K-step and loop submodels."""
    base = dict(tp_degree=1, seq_len=64)
    odsc = dict(on_device_sampling_config=OnDeviceSamplingConfig())
    for key in (dict(decode_steps_per_dispatch=4), dict(device_loop=True)):
        with pytest.raises(ValueError, match="on-device sampling"):
            TorchConfig(**base, **key)
        with pytest.raises(ValueError, match="in-graph KV addressing"):
            TorchConfig(**base, **odsc, **key, is_block_kv_layout=True, pa_block_size=8)
        with pytest.raises(ValueError, match="ctx_batch_size == tkg_batch_size"):
            TorchConfig(**base, **odsc, **key, batch_size=2, ctx_batch_size=1,
                        tkg_batch_size=2)
    with pytest.raises(ValueError, match="mixed_dispatch"):
        TorchConfig(**base, **odsc, device_loop=True, mixed_dispatch=True,
                    is_block_kv_layout=False)
    with pytest.raises(ValueError, match="device_loop_fence"):
        TorchConfig(**base, **odsc, device_loop=True, device_loop_fence=-1)
    with pytest.raises(ValueError, match="decode_steps_per_dispatch"):
        TorchConfig(**base, decode_steps_per_dispatch=0)
    cfg = TorchConfig(**base, **odsc, decode_steps_per_dispatch=4, device_loop=True,
                      device_loop_fence=8, is_continuous_batching=True)
    assert TorchConfig.from_dict(cfg.to_dict()).to_dict() == cfg.to_dict()
    assert TorchConfig(**base, on_device_sampling_config=OnDeviceSamplingConfig(
        do_sample=True)).on_device_sampling_config.do_sample
