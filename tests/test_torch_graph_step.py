"""The pieces of the port's graph step (one CUDA graph per (submodel,
bucket)) that run without a card.

- Fixed-length paged writes: :func:`kv_cache.scatter_indices_fixed` sends
  every dropped token (padding rows and lanes, holes) to the pool's drop
  block; the reachable pool equals the variable-length path's bit for bit
  and the JAX package's layout update, and after the same engine traffic
  the reachable pool of the port's engine equals the JAX engine's (float32,
  within 1e-5: the two packages' projections round differently).
- The ragged work list sized from shapes: :func:`ragged_capacity` bounds
  every plan of the mixed ladder; a plan padded to it, read as the kernels
  read it (counts from its header, the split and combine lists walked with
  the stride of a capped grid), runs every item and token once, and its
  emulation equals the unpadded plan's bit for bit and the JAX kernel in
  interpret mode within 1e-5.
- The replay counter arithmetic: a capture's recorded launches, replayed,
  give the eager counts.
- The staging path (pinned staging buffer, static inputs, bucket records)
  equals the eager ``forward`` bit for bit for every submodel, through the
  static generate path and the split and mixed engines.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nxdi_tpu.kvcache import kv_cache as jkv
from nxdi_tpu.ops.kernels import ragged_paged_attention as jax_ragged  # the function
from nxdi_tpu.serving import SamplingParams as JaxSP
from nxdi_tpu_torch.config import OnDeviceSamplingConfig, TorchConfig
from nxdi_tpu_torch.generation.hf_adapter import HuggingFaceGenerationAdapter
from nxdi_tpu_torch.kvcache import kv_cache as tkv
from nxdi_tpu_torch.models.llama import modeling_llama as tml
from nxdi_tpu_torch.ops.kernels import flash_attention as fa
from nxdi_tpu_torch.ops.kernels import kv_commit as kc
from nxdi_tpu_torch.ops.kernels import ragged_paged_attention as rpa
from nxdi_tpu_torch.runtime import model_wrapper as mw
from nxdi_tpu_torch.runtime.application import TorchModelForCausalLM
from nxdi_tpu_torch.serving import InferenceEngine, SamplingParams, SchedulerConfig
from test_torch_engine import LONG, PROMPTS, _Pair
from test_torch_engine import _common as engine_common
from test_torch_ragged_plan import LADDER, TOL, _check_plan, _emulate, _engine_stream
from test_torch_slice import PROMPT, fresh_jax_compiles, port_app

POOL_TOL = 1e-5
ENGINE = dict(is_prefix_caching=True, pa_block_size=8, pa_num_blocks=24, ctx_batch_size=1,
              tkg_batch_size=3, chunked_prefill_config={"chunk_size": 8},
              attn_kernel_enabled=True, attn_tkg_kernel_enabled=True)
SCHED = dict(num_slots=3, prefix_cache=True, cache_aware_admission=False)


@pytest.fixture(autouse=True, scope="module")
def _fresh_jax_compiles():
    with fresh_jax_compiles():
        yield


def _engine_app(hf_model, hf_cfg, graphs=True, params=None, **kw):
    """A port engine app on the CPU (the engine tests' configuration)."""
    cfg = tml.LlamaInferenceConfig(
        TorchConfig(on_device_sampling_config=OnDeviceSamplingConfig(), **engine_common(**kw)),
        load_config=lambda: hf_cfg.to_dict(),
    )

    class App(TorchModelForCausalLM):
        def get_state_dict(self):
            return {k: v.detach() for k, v in hf_model.state_dict().items()}

        def build_params(self):
            return params if params is not None else super().build_params()

    app = App("<memory>", cfg, model_family=tml, device="cpu", graphs=graphs)
    app.load()
    return app


# ---------------------------------------------------------------------------
# fixed-length paged writes
# ---------------------------------------------------------------------------

# (slot mapping (b, S)): padding rows, holes and sequence padding drop
SLOT_CASES = {
    "padding_row": np.array([[5, 6, 7], [-1, -1, -1]], np.int32),
    "holes_and_lanes": np.array([[-1, 9, 10], [17, -1, -1]], np.int32),
    "all_dropped": np.full((2, 3), -1, np.int32),
}


@pytest.mark.parametrize("case", sorted(SLOT_CASES))
def test_fixed_scatter_matches_variable_and_jax(case):
    slots = SLOT_CASES[case]
    bs, nblk, KV, D = 4, 6, 2, 8
    rng = np.random.default_rng(len(case))
    pool_k = rng.standard_normal(((nblk + 1) * bs, KV, D)).astype(np.float32)
    pool_v = rng.standard_normal(((nblk + 1) * bs, KV, D)).astype(np.float32)
    k_new = rng.standard_normal((2, KV, 3, D)).astype(np.float32)
    v_new = rng.standard_normal((2, KV, 3, D)).astype(np.float32)
    spec = tkv.BlockKVCacheSpec(1, nblk + 1, bs, KV, D, dtype="float32")
    layout = tkv.BlockKVLayout(block_size=bs)
    drop = tkv.drop_slot(nblk, bs)
    fixed = {k: torch.from_numpy(v) for k, v in tkv.scatter_indices_fixed(slots, drop).items()}
    assert fixed["write_index"].shape == fixed["write_slots"].shape == (slots.size,)
    assert set(fixed["write_slots"][slots.reshape(-1) < 0].tolist()) <= {drop}
    variable = {k: torch.from_numpy(v) for k, v in tkv.scatter_indices(slots).items()}
    got, ref = [], []
    for ci, out in ((fixed, got), (variable, ref)):
        tk, tv = torch.from_numpy(pool_k.copy()), torch.from_numpy(pool_v.copy())
        layout.update(tk, tv, torch.from_numpy(k_new), torch.from_numpy(v_new), ci, spec)
        out += [tk[:nblk * bs], tv[:nblk * bs]]
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    jspec = jkv.BlockKVCacheSpec(1, nblk, bs, KV, D, dtype="float32")
    jk, jv = jkv.BlockKVLayout(block_size=bs).update(
        jnp.asarray(pool_k[:nblk * bs]), jnp.asarray(pool_v[:nblk * bs]), jnp.asarray(k_new),
        jnp.asarray(v_new), {"slot_mapping": jnp.asarray(slots)}, jspec)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(jk))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(jv))


def _engine_traffic(eng, SP):
    """Requests sharing a prefix, a chunked long prompt, padding rows (3
    slots, fewer live), and decode steps whose tables have holes past
    their blocks."""
    reqs = [eng.add_request(PROMPTS[0], SP(max_new_tokens=6))]
    eng.step()
    reqs += [eng.add_request(p, SP(max_new_tokens=5)) for p in (PROMPTS[1], LONG)]
    outs = eng.run()
    got = {o.request_id: o.token_ids for o in outs}
    return [got[r.request_id] for r in reqs]


def test_engine_pool_matches_variable_writes_and_jax(tiny_hf_llama, monkeypatch):
    """The same traffic through the JAX engine, the port's engine (fixed
    writes) and the port's engine with variable-length writes: identical
    streams; the port's two reachable pools equal bit for bit, and equal
    the JAX pool within POOL_TOL."""
    hf_model, hf_cfg = tiny_hf_llama
    pair = _Pair(hf_model, hf_cfg, **ENGINE)
    jeng, teng = pair.engines(**SCHED)
    jout = _engine_traffic(jeng, JaxSP)
    tout = _engine_traffic(teng, SamplingParams)
    assert tout == jout
    reach = 24 * 8
    port_k, port_v = (pair.tapp.kv_cache[k][:, :reach].clone() for k in ("k", "v"))
    assert pair.tapp.kv_cache["k"].shape[1] == reach + 8  # the drop block
    np.testing.assert_allclose(port_k.numpy(), np.asarray(pair.japp.kv_cache["k"]),
                               atol=POOL_TOL, rtol=0)
    np.testing.assert_allclose(port_v.numpy(), np.asarray(pair.japp.kv_cache["v"]),
                               atol=POOL_TOL, rtol=0)

    def variable(sm, drop):
        return tkv.scatter_indices(sm)

    # variable lengths change the inputs' shapes from step to step: eager
    monkeypatch.setattr(mw, "scatter_indices_fixed", variable)
    other = _engine_app(hf_model, hf_cfg, graphs=False, **ENGINE)
    assert _engine_traffic(InferenceEngine(other, SchedulerConfig(**SCHED)),
                           SamplingParams) == tout
    assert torch.equal(other.kv_cache["k"][:, :reach], port_k)
    assert torch.equal(other.kv_cache["v"][:, :reach], port_v)


# ---------------------------------------------------------------------------
# the ragged work list sized from shapes
# ---------------------------------------------------------------------------


def _as_the_kernels_read(flat, cap, kv_heads):
    """The plan the kernels see in a padded list launched at ``cap``'s
    sizes: the counts from the header; every listed item and token to
    combine walked exactly once by the strided blocks of the capped grids,
    and no direct tile past the count."""
    hdr = flat[:rpa.PLAN_HEADER]
    plan = rpa.RaggedPlan(T=int(hdr[0]), n_direct=int(hdr[1]), n_items=int(hdr[2]),
                          n_slots=int(hdr[3]), n_comb=int(hdr[4]), chunk=int(hdr[5]),
                          flat=flat)
    g_direct, g_items, g_comb = cap.grids(kv_heads)
    assert g_direct == cap.n_direct >= plan.n_direct
    for n, g in ((plan.n_items, g_items), (plan.n_comb, g_comb)):
        walked = [i for blk in range(g) for i in range(blk, n, g)]
        assert sorted(walked) == list(range(n))
    return plan


@pytest.mark.parametrize("T", LADDER)
def test_capacity_bounds_every_plan(T):
    """Engine packings and adversarial streams (every token of a row at the
    far end of the table; tokens split over many rows) stay within the
    bucket's capacity, and the padded list reads back as the plan."""
    R, kv_width, KV = 8, 16 * 128, 8
    cap = rpa.ragged_capacity(T, R, kv_width, KV)
    rng = np.random.default_rng(T)
    streams = [_engine_stream(T, R, rng, kv_width) for _ in range(3)]
    alt = np.arange(T, dtype=np.int32) % R  # no tile is one row's: every token split
    streams.append((alt, np.full(T, kv_width - 1, np.int32)))
    streams.append((np.zeros(T, np.int32), kv_width - T + np.arange(T, dtype=np.int32)))
    for rid, qp in streams:
        plan = rpa.ragged_plan(rid, qp, R, kv_width, KV)
        flat = rpa.pad_plan(plan, cap)
        assert flat.size == cap.flat_len
        seen = _as_the_kernels_read(flat, cap, KV)
        assert (seen.n_direct, seen.n_items, seen.n_slots, seen.n_comb, seen.chunk) == (
            plan.n_direct, plan.n_items, plan.n_slots, plan.n_comb, plan.chunk)
        np.testing.assert_array_equal(seen.items(), plan.items())
        np.testing.assert_array_equal(seen.combined(), plan.combined())
        _check_plan(seen, rid, qp, R, kv_width)


def test_padded_plan_matches_unpadded_and_jax():
    """The 96-token stream of test_torch_ragged_plan (a prefill chunk with
    its tail split, decode rows with holes, a row that sees nothing,
    padding): the padded plan, read as the kernels read it, gives the
    unpadded plan's output bit for bit, and the JAX kernel's within TOL."""
    rng = np.random.default_rng(11)
    H, KV, T, D, bs, NB, R = 8, 2, 96, 16, 16, 20, 5
    k = rng.standard_normal((64 * bs, KV, D)).astype(np.float32)
    v = rng.standard_normal((64 * bs, KV, D)).astype(np.float32)
    perm = rng.permutation(64)
    bt = np.full((R, NB), -1, np.int32)
    bt[2, :19], bt[3, :20], bt[0, :9], bt[1, :1] = perm[:19], perm[19:39], perm[39:48], perm[48:49]
    bt[3, 4] = -1
    rid = np.full(T, -1, np.int32)
    qp = np.zeros(T, np.int32)
    rid[:74], qp[:74] = 2, np.arange(226, 300)
    rid[74:78], qp[74:78] = [3, 0, 4, 1], [310, 140, 60, 5]
    q = rng.standard_normal((1, H, T, D)).astype(np.float32)
    plan = rpa.ragged_plan(rid, qp, R, NB * bs, KV)
    cap = rpa.ragged_capacity(T, R, NB * bs, KV)
    seen = _as_the_kernels_read(rpa.pad_plan(plan, cap), cap, KV)
    qt, kt, vt = torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v)
    got = _emulate(qt, kt, vt, bt, rid, qp, seen, bs, None, 1.0, 1.0)
    want = _emulate(qt, kt, vt, bt, rid, qp, plan, bs, None, 1.0, 1.0)
    assert torch.equal(got, want) and not torch.isnan(got).any()
    ref = jax_ragged(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bt),
                     jnp.asarray(rid), jnp.asarray(qp), block_size=bs, block_q=8)
    np.testing.assert_allclose(got.numpy()[:, :, :78], np.asarray(ref)[:, :, :78], atol=TOL,
                               rtol=0)


def test_pad_plan_refuses_a_plan_past_the_capacity():
    rid = np.zeros(64, np.int32)
    plan = rpa.ragged_plan(rid, np.arange(64, dtype=np.int32), 1, 256, 2)
    with pytest.raises(ValueError, match="capacity"):
        rpa.pad_plan(plan, rpa.ragged_capacity(32, 1, 256, 2))


# ---------------------------------------------------------------------------
# replay counter arithmetic
# ---------------------------------------------------------------------------


def test_replayed_counts_equal_eager_counts():
    """An eager forward's launches E; the capture records E and leaves the
    counters as they were; k replays add k x E (as k eager forwards would)."""
    wrappers = (fa.flash_attention_prefill, rpa.ragged_paged_attention, kc.kv_commit_rows)
    eager = {fa.flash_attention_prefill: 16, rpa.ragged_paged_attention: 16,
             kc.kv_commit_rows: 1}
    saved = [w.launches for w in wrappers]

    def forward():
        for w, n in eager.items():
            w.launches += n
        return "out"

    try:
        for w in wrappers:
            w.launches = 5
        out, launches = mw.count_launches(forward)
        assert out == "out" and dict(launches) == eager
        assert all(w.launches == 5 for w in wrappers)  # the capture launched nothing
        for _ in range(3):
            mw.add_launches(launches)
        assert {w: w.launches - 5 for w in wrappers} == {w: 3 * n for w, n in eager.items()}
        with pytest.raises(RuntimeError):
            mw.count_launches(lambda: (forward(), (_ for _ in ()).throw(RuntimeError()))[0])
        assert all(w.launches == 5 + 3 * eager[w] for w in wrappers)  # put back on failure
    finally:
        for w, n in zip(wrappers, saved):
            w.launches = n


# ---------------------------------------------------------------------------
# the staging path equals the eager forward
# ---------------------------------------------------------------------------


def _recording(app, log):
    inner = app.forward

    def fwd(*a, **k):
        out = inner(*a, **k)
        log.append({key: v.clone() for key, v in out.items() if key != "next_inputs"})
        return out

    app.forward = fwd


def _assert_same_dispatches(a, b):
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for key in x:
            assert torch.equal(x[key], y[key]), key


def test_staging_path_equals_eager_static(tiny_hf_llama):
    """The static generate path (context encoding, token generation across
    buckets): every dispatch's tokens and logits, and the cache, bit for
    bit; every token-generation bucket shares one set of static inputs."""
    hf_model, hf_cfg = tiny_hf_llama
    kw = dict(output_logits=True, batch_size=2, enable_bucketing=True,
              context_encoding_buckets=[8, 16, 32], token_generation_buckets=[16, 32, 64])
    staged = port_app(hf_model, hf_cfg, **kw)
    eager = port_app(hf_model, hf_cfg, params=staged.params, **kw)
    for w in eager.models.values():
        w.graphs = False
    logs = ([], [])
    prompt = np.concatenate([PROMPT, PROMPT[:, ::-1]])
    outs = []
    for app, log in zip((staged, eager), logs):
        _recording(app, log)
        outs.append(HuggingFaceGenerationAdapter(app).generate(prompt, max_new_tokens=40))
    np.testing.assert_array_equal(outs[0], outs[1])
    _assert_same_dispatches(*logs)
    for key in ("k", "v"):
        assert torch.equal(staged.kv_cache[key], eager.kv_cache[key])
    tkg = staged.models["token_generation_model"]
    assert set(tkg.bucket_graphs) == {16, 32, 64} and len(tkg._input_sets) == 1
    assert not eager.models["token_generation_model"].bucket_graphs


@pytest.mark.parametrize("mixed", [False, True], ids=["split", "mixed"])
def test_staging_path_equals_eager_engine(tiny_hf_llama, mixed):
    """The engines (split: context encoding, prefix prefill, token
    generation; mixed: the mixed submodel with the fused projections): the
    same traffic through staged and eager apps gives the same streams, every
    dispatch's outputs and the whole pool bit for bit."""
    hf_model, hf_cfg = tiny_hf_llama
    kw = dict(ENGINE, output_logits=True)
    if mixed:
        kw.update(mixed_dispatch=True, fused_qkv=True, qkv_kernel_enabled=True,
                  mlp_kernel_enabled=True)
    staged = _engine_app(hf_model, hf_cfg, **kw)
    eager = _engine_app(hf_model, hf_cfg, graphs=False, params=staged.params, **kw)
    logs, streams = ([], []), []
    for app, log in zip((staged, eager), logs):
        _recording(app, log)
        eng = InferenceEngine(app, SchedulerConfig(**SCHED))
        streams.append(_engine_traffic(eng, SamplingParams))
    assert streams[0] == streams[1]
    _assert_same_dispatches(*logs)
    for key in ("k", "v"):
        assert torch.equal(staged.kv_cache[key], eager.kv_cache[key])
    used = {tag for tag, w in staged.models.items() if w.bucket_graphs}
    want = ({"mixed_model"} if mixed else
            {"context_encoding_model", "prefix_prefill_model", "token_generation_model"})
    assert used == want


def test_collector_paused_around_captures():
    """The garbage collector is off inside ``collector_paused`` (the CUDA
    graph captures run there), even when the allocation thresholds ask for
    collections, and on again after, also after an error."""
    import gc
    import weakref

    from nxdi_tpu_torch.runtime.model_wrapper import collector_paused

    class Node:
        pass

    freed = []
    thresholds = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        with collector_paused():
            assert not gc.isenabled()
            a = Node()
            a.self = a  # garbage only the collector frees
            weakref.finalize(a, freed.append, True)
            del a
            junk = [Node() for _ in range(100)]  # allocations that would trigger it
            assert freed == [] and junk
        assert gc.isenabled()
        gc.collect()
        assert freed == [True]
    finally:
        gc.set_threshold(*thresholds)
    with pytest.raises(RuntimeError):
        with collector_paused():
            raise RuntimeError("capture failed")
    assert gc.isenabled()
    gc.disable()
    try:
        with collector_paused():
            pass
        assert not gc.isenabled()  # a caller's choice is kept
    finally:
        gc.enable()
