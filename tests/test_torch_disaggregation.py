"""Prefill/decode disaggregation in the port held against the JAX package,
engine to engine (no router): a prefill-role engine prefills and parks each
request, its KV chain moves as a ``HandoffPayload`` (through the wire), a
decode-role engine imports it and decodes on. On the tiny random llama:

- the wire: a JAX ``to_wire()`` payload decodes in the port to the same
  arrays (bits), and the port's decodes in the JAX package's ``from_wire``,
  for bfloat16 and float8_e4m3 pools;
- greedy streams: the port's pair equals the port's unified engine, the
  JAX pair driven the same way and the JAX unified engine, over a bf16 and
  a float8_e4m3 pool, with chunked prefill crossing the handoff;
- a decode-role app holds no context-encoding or prefix-prefill submodel,
  and its engine refuses ``add_request``;
- format mismatches raise ``ValueError``, a full decode engine
  ``HandoffCapacityError``.
"""

import numpy as np
import pytest
import torch

from nxdi_tpu.config import TpuConfig
from nxdi_tpu.serving import SamplingParams as JaxSP
from nxdi_tpu.serving.handoff import HandoffPayload as JaxPayload
from nxdi_tpu_torch.config import TorchConfig
from nxdi_tpu_torch.runtime.application import TAG_PREFIX_PREFILL
from nxdi_tpu_torch.runtime.model_wrapper import TAG_CONTEXT_ENCODING
from nxdi_tpu_torch.serving import SamplingParams
from nxdi_tpu_torch.serving.handoff import HandoffCapacityError, HandoffPayload
from test_torch_engine import _Pair
from test_torch_slice import fresh_jax_compiles

WORKLOAD = [
    [5, 9, 3, 17, 2, 8, 11, 42],
    [7, 201, 44, 13, 95, 8, 160, 77, 31, 5, 118, 9, 64, 2, 250, 41, 86, 19, 140, 55],
    [9, 9, 2, 40, 17, 3],
]
GEOMETRY = dict(pa_block_size=8, pa_num_blocks=32, ctx_batch_size=1, tkg_batch_size=3,
                attn_kernel_enabled=True, attn_block_tkg_kernel_enabled=True,
                chunked_prefill_config=dict(chunk_size=8, kernel_q_tile_size=8))
# a decode-role engine never prefills, so it takes no chunk size (the JAX rule)
DECODE_GEOMETRY = {k: v for k, v in GEOMETRY.items() if k != "chunked_prefill_config"}
STORES = {None: {}, "float8_e4m3": dict(kv_cache_quant=True)}


@pytest.fixture(autouse=True, scope="module")
def _fresh_jax_compiles():
    with fresh_jax_compiles():
        yield


def _bits(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy()
        return (t.view(torch.uint8) if t.element_size() == 1 else t).numpy()
    a = np.asarray(t)
    return a.view(np.uint8 if a.dtype.itemsize == 1 else np.int16)


def _jax_payload(store):
    import ml_dtypes

    rng = np.random.default_rng(0)
    dt = ml_dtypes.float8_e4m3fn if store else ml_dtypes.bfloat16
    kv = {s: rng.standard_normal((2, 16, 2, 16)).astype(np.float32).astype(dt) for s in "kv"}
    return JaxPayload(
        request_id=7, prompt=list(range(1, 12)), first_tokens=[42], committed=11,
        sampling=JaxPayload.sampling_wire(JaxSP(max_new_tokens=5, eos_token_ids=(2,))),
        rng_seed=3, rng_counter=9, block_size=8, dtype=str(np.dtype(dt)), kv=kv,
        session_id="s1")


@pytest.mark.parametrize("store", list(STORES))
def test_wire_roundtrip_with_jax(store):
    jp = _jax_payload(store)
    port = HandoffPayload.from_wire(jp.to_wire())
    assert port.dtype == jp.dtype and port.nbytes == jp.nbytes
    assert (port.prompt, port.first_tokens, port.committed, port.sampling, port.session_id) == (
        jp.prompt, jp.first_tokens, jp.committed, jp.sampling, jp.session_id)
    assert port.sampling_params() == SamplingParams(max_new_tokens=5, eos_token_ids=(2,))
    for s in "kv":
        want_dt = torch.float8_e4m3fn if store else torch.bfloat16
        assert port.kv[s].dtype == want_dt and tuple(port.kv[s].shape) == jp.kv[s].shape
        np.testing.assert_array_equal(_bits(port.kv[s]), _bits(jp.kv[s]))
    back = JaxPayload.from_wire(port.to_wire())
    assert back.dtype == jp.dtype
    for s in "kv":
        np.testing.assert_array_equal(_bits(back.kv[s]), _bits(jp.kv[s]))
    port.validate_against(8, torch.float8_e4m3fn if store else torch.bfloat16)


def test_payload_validation_refuses_like_jax():
    jp = _jax_payload(None)
    port = HandoffPayload.from_wire(jp.to_wire())
    cases = [(dict(block_size=16), "block_size mismatch"),
             (dict(dtype="float8_e4m3fn"), "dtype mismatch"),
             (dict(committed=30), "chain length mismatch"),
             (dict(first_tokens=[]), "payload incomplete")]
    for change, msg in cases:
        for p in (jp, port):
            saved = {k: getattr(p, k) for k in change}
            for k, v in change.items():
                setattr(p, k, v)
            store = torch.bfloat16 if p is port else jp.kv["k"].dtype
            with pytest.raises(ValueError, match=msg):
                p.validate_against(8, store)
            for k, v in saved.items():
                setattr(p, k, v)
    wire = port.to_wire()
    wire["version"] = 2
    with pytest.raises(ValueError, match="unsupported handoff wire version"):
        HandoffPayload.from_wire(wire)


def _drive_pair(pre, dec, SP, wire):
    """Every request through the prefill engine, then its chain into the
    decode engine (through the JSON wire when ``wire``); returns the
    streams by prompt index."""
    ids = {}
    for i, p in enumerate(WORKLOAD):
        ids[pre.add_request(p, SP(max_new_tokens=6)).request_id] = i
    out = {}
    while pre.has_work():
        for o in pre.step():  # a request done at its first token never parks
            out[ids[o.request_id]] = o.token_ids
        for rid in pre.take_ready_handoffs():
            payload = pre.export_handoff(rid)
            if wire:
                payload = type(payload).from_wire(payload.to_wire())
            dec.admit_handoff(payload)
            pre.ack_handoff(rid)
    for o in dec.run():
        out[ids[o.request_id]] = o.token_ids
    return [out[i] for i in range(len(WORKLOAD))]


def _drive_unified(eng, SP):
    reqs = [eng.add_request(p, SP(max_new_tokens=6)) for p in WORKLOAD]
    got = {o.request_id: o.token_ids for o in eng.run()}
    return [got[r.request_id] for r in reqs]


@pytest.mark.parametrize("store", list(STORES))
def test_disaggregated_pair_matches_unified_and_jax(tiny_hf_llama, store):
    hf_model, hf_cfg = tiny_hf_llama
    kw = dict(GEOMETRY, **STORES[store])
    pre = _Pair(hf_model, hf_cfg, role="prefill", **kw)
    uni = _Pair(hf_model, hf_cfg, **kw)
    dec = _Pair(hf_model, hf_cfg, role="decode", **DECODE_GEOMETRY, **STORES[store])
    jpre, tpre = pre.engines()
    jdec, tdec = dec.engines()
    juni, tuni = uni.engines()
    port = _drive_pair(tpre, tdec, SamplingParams, wire=True)
    ref = _drive_pair(jpre, jdec, JaxSP, wire=True)
    assert port == ref
    assert port == _drive_unified(tuni, SamplingParams) == _drive_unified(juni, JaxSP)
    assert tpre.handoff_exports == tdec.handoff_imports == len(WORKLOAD)
    assert tpre.handoff_bytes == tdec.handoff_bytes > 0
    assert tpre.dispatches[TAG_CONTEXT_ENCODING] == len(WORKLOAD)
    assert dec.tapp.kv_cache["k"].dtype == (torch.float8_e4m3fn if store else torch.float32)
    # the prefill engine retired every parked request: its pool is free again
    assert not tpre.scheduler.unpreemptible and tpre.scheduler.slots_busy == 0


def test_decode_role_app_and_engine_rules(tiny_hf_llama):
    hf_model, hf_cfg = tiny_hf_llama
    pair = _Pair(hf_model, hf_cfg, role="decode", **DECODE_GEOMETRY)
    for app in (pair.japp, pair.tapp):
        assert TAG_CONTEXT_ENCODING not in app.models and TAG_PREFIX_PREFILL not in app.models
    assert set(pair.tapp.models) == set(pair.japp.models)
    jeng, teng = pair.engines()
    for eng, SP in ((jeng, JaxSP), (teng, SamplingParams)):
        with pytest.raises(ValueError, match="admits requests via KV handoff only"):
            eng.add_request([1, 2, 3], SP())
    with pytest.raises(KeyError, match="not built in this app"):
        pair.tapp.forward(np.ones((1, 4), np.int32), np.arange(4, dtype=np.int32)[None])
    for cls in (TpuConfig, TorchConfig):
        for kw, msg in ((dict(role="decode"), "requires is_block_kv_layout"),
                        (dict(role="prefill", is_block_kv_layout=True, pa_num_blocks=8,
                              mixed_dispatch=True), "cannot compose with role"),
                        (dict(role="bogus"), "role must be")):
            with pytest.raises(ValueError, match=msg):
                cls(**kw)


def test_decode_engine_capacity_errors(tiny_hf_llama):
    hf_model, hf_cfg = tiny_hf_llama
    pre = _Pair(hf_model, hf_cfg, role="prefill", **GEOMETRY)
    dec = _Pair(hf_model, hf_cfg, role="decode", **dict(DECODE_GEOMETRY, pa_num_blocks=4,
                                                        tkg_batch_size=2))
    _, tpre = pre.engines()
    _, tdec = dec.engines()
    reqs = [tpre.add_request(p, SamplingParams(max_new_tokens=6)) for p in WORKLOAD]
    while len(tpre._handoffs) < len(WORKLOAD):
        tpre.step()
    short, long_, short2 = (tpre.export_handoff(r.request_id) for r in reqs)
    tdec.admit_handoff(short)  # 1 block of 4, one slot busy
    # 20 committed tokens need 3 blocks: 3 free minus 3 is under the watermark
    with pytest.raises(HandoffCapacityError, match="pool pressure"):
        tdec.admit_handoff(long_)
    tdec.admit_handoff(short2)
    with pytest.raises(HandoffCapacityError, match="no free engine slot"):
        tdec.admit_handoff(long_)
    # the parked chain stays exportable until it is acknowledged
    assert tpre.export_handoff(reqs[1].request_id).committed == len(WORKLOAD[1])
    with pytest.raises(KeyError):
        tpre.ack_handoff(12345)
