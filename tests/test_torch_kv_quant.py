"""The port's quantized KV cache held against the JAX package's, the same
numpy inputs through both:

- ``KVQuantizationConfig`` and the layout construction rules, word for word;
- the scaled contiguous layout in all four modes and the scaled paged layout
  (direct_cast, per_tensor) for float8_e4m3 / float8_e5m2 / int8 stores:
  ``update``, ``commit_rows`` and the store casts bit-equal, ``read``
  equal (float32 compute);
- the plain versions of the four kernels that read or write a one-byte
  store (the commit, the paged decode and prefill, the ragged kernel)
  against the Pallas kernels in interpret mode: the commit bit-equal, the
  attention within 1e-4 (float32; K/V values up to ~40 make scores of
  ~100, where the two packages' softmax orders differ by a few ulps);
- ``export_kv_blocks`` / ``import_kv_blocks``: round trip and every refusal;
- ``calibrate_kv_scales``: the JAX package's scales;
- end to end: greedy ``generate()`` identical to the JAX package's with
  ``kv_cache_quant`` (direct_cast, per_tensor, per_channel), the stores
  bit-equal after it, and the paged engine on a float8_e4m3 pool streaming
  the JAX engine's tokens.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nxdi_tpu.config import KVQuantizationConfig as JaxKVQ
from nxdi_tpu.config import TpuConfig
from nxdi_tpu.generation.hf_adapter import HuggingFaceGenerationAdapter as JaxAdapter
from nxdi_tpu.kvcache import calibration as jcal
from nxdi_tpu.kvcache import kv_cache as jkv
from nxdi_tpu.ops.kernels import flash_attention as jfa
from nxdi_tpu.ops.kernels import kv_commit as jkc
from nxdi_tpu.ops.kernels import ragged_paged_attention as jax_ragged
from nxdi_tpu.serving import SamplingParams as JaxSP
from nxdi_tpu_torch.config import KVQuantizationConfig, TorchConfig
from nxdi_tpu_torch.generation.hf_adapter import HuggingFaceGenerationAdapter
from nxdi_tpu_torch.kvcache import calibration as tcal
from nxdi_tpu_torch.kvcache import kv_cache as tkv
from nxdi_tpu_torch.ops.kernels import flash_attention as tfa
from nxdi_tpu_torch.ops.kernels import kv_commit as tkc
from nxdi_tpu_torch.ops.kernels import ragged_paged_attention as tra
from nxdi_tpu_torch.serving import SamplingParams
from test_torch_engine import _Pair, _streams
from test_torch_slice import _strategies, fresh_jax_compiles, jax_app, port_app

ATTN_TOL = 1e-4
STORES = {"float8_e4m3": (jnp.float8_e4m3fn, torch.float8_e4m3fn),
          "float8_e5m2": (jnp.float8_e5m2, torch.float8_e5m2),
          "int8": (jnp.int8, torch.int8)}
PROMPT = np.array([[5, 9, 3, 17, 2, 8, 11, 42]], dtype=np.int64)


@pytest.fixture(autouse=True, scope="module")
def _fresh_jax_compiles():
    with fresh_jax_compiles():
        yield


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return (x.view(torch.uint8) if x.element_size() == 1 else x).numpy()
    a = np.asarray(x)
    return a.view(np.uint8) if a.dtype.itemsize == 1 else a


def _to_torch(x) -> torch.Tensor:
    """A JAX array as a CPU tensor, bits preserved (fp8 through uint8)."""
    a = np.asarray(x)
    for jdt, tdt in STORES.values():
        if a.dtype == jnp.dtype(jdt) and a.dtype.itemsize == 1 and a.dtype != np.int8:
            return torch.from_numpy(a.view(np.uint8).copy()).view(tdt)
    return torch.from_numpy(np.array(a, copy=True))


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(scale_mode="bogus"),
    dict(k_scale=2.0),
    dict(scale_mode="per_key"),
    dict(scale_mode="direct_cast", k_scales=[[1.0]], v_scales=[[1.0]]),
], ids=["mode", "direct-scale", "per-key-needs-arrays", "arrays-need-array-mode"])
def test_kv_quant_config_refuses_like_jax(kw):
    with pytest.raises(ValueError) as jerr:
        JaxKVQ(**kw)
    with pytest.raises(ValueError) as terr:
        KVQuantizationConfig(**kw)
    assert str(terr.value).split("(")[0] == str(jerr.value).split("(")[0]


def test_kv_quant_config_keys_and_composition(tmp_path):
    np.savez(tmp_path / "s.npz", k_scales=np.array([0.5, 2.0], np.float32),
             v_scales=np.array([1.0, 3.0], np.float32))
    for cls in (JaxKVQ, KVQuantizationConfig):  # calibration's (L,) -> per-tensor max
        c = cls(scale_mode="per_tensor", scales_path=str(tmp_path / "s.npz"))
        assert (c.k_scale, c.v_scale, c.k_scales) == (2.0, 3.0, None)
    tc = TorchConfig(kv_cache_quant=True)
    assert tc.kv_quant_config.dtype == "float8_e4m3"
    assert TorchConfig.from_dict(tc.to_dict()).kv_quant_config.scale_mode == "direct_cast"
    kvq = dict(dtype="int8", scale_mode="per_channel", k_scales=[[1.0] * 16] * 4,
               v_scales=[[1.0] * 16] * 4)
    for cls in (TpuConfig, TorchConfig):
        with pytest.raises(ValueError, match="composes with the contiguous KV layout only"):
            cls(is_block_kv_layout=True, pa_num_blocks=8, kv_quant_config=kvq)


# ---------------------------------------------------------------------------
# the layouts
# ---------------------------------------------------------------------------

L, B, KV, S, D = 3, 2, 2, 32, 16


def _layout_pair(mode, store):
    rng = np.random.default_rng(7)
    kw = {}
    if mode == "per_tensor":
        kw = dict(k_scale=0.37, v_scale=2.5)
    elif mode in ("per_key", "per_channel"):
        shape = (L, KV) if mode == "per_key" else (L, D)
        kw = dict(k_scales=tuple(map(tuple, rng.uniform(0.05, 0.5, shape).tolist())),
                  v_scales=tuple(map(tuple, rng.uniform(0.05, 0.5, shape).tolist())),
                  scale_axis="key" if mode == "per_key" else "channel")
    return jkv.ContiguousKVLayout(**kw), tkv.ContiguousKVLayout(**kw)


@pytest.mark.parametrize("store", list(STORES))
@pytest.mark.parametrize("mode", ["direct_cast", "per_tensor", "per_key", "per_channel"])
def test_contiguous_layout_matches_jax(store, mode):
    jdt, tdt = STORES[store]
    jl, tl = _layout_pair(mode, store)
    rng = np.random.default_rng(8)
    spec_kw = dict(num_layers=L, batch_size=B, num_kv_heads=KV, max_len=S, head_dim=D,
                   dtype="float32", quant_dtype=store)
    jspec, tspec = jkv.KVCacheSpec(**spec_kw), tkv.KVCacheSpec(**spec_kw)
    assert tspec.store_dtype == tdt
    jc, tc_ = jkv.init_kv_cache(jspec), tkv.init_kv_cache(tspec, "cpu")
    # one prefill at layer 1 (the CTE slice path), then a decode commit of the stack
    k_new = (rng.standard_normal((B, KV, 5, D)) * 30).astype(np.float32)
    v_new = (rng.standard_normal((B, KV, 5, D)) * 30).astype(np.float32)
    pos = np.tile(np.arange(5, dtype=np.int32), (B, 1))
    ci = dict(position_ids=pos, prefill_from_zero=True, layer_idx=1)
    jk, jv = jl.update(jc["k"][1], jc["v"][1], jnp.asarray(k_new), jnp.asarray(v_new),
                       {**ci, "position_ids": jnp.asarray(pos), "layer_idx": jnp.int32(1)},
                       jspec)
    tl.update(tc_["k"][1], tc_["v"][1], torch.from_numpy(k_new), torch.from_numpy(v_new),
              {**ci, "position_ids": torch.from_numpy(pos)}, tspec)
    np.testing.assert_array_equal(_bits(tc_["k"][1]), _bits(jk))
    np.testing.assert_array_equal(_bits(tc_["v"][1]), _bits(jv))
    jc = {"k": jc["k"].at[1].set(jk), "v": jc["v"].at[1].set(jv)}
    rows = (rng.standard_normal((2, L, B, KV, 1, D)) * 30).astype(np.float32)
    dpos = np.array([[7], [-1]], np.int32)  # the second row is frozen: dropped
    jc = jl.commit_rows(jc, jnp.asarray(rows[0]), jnp.asarray(rows[1]),
                        {"position_ids": jnp.asarray(dpos)}, jspec)
    tl.commit_rows(tc_, torch.from_numpy(rows[0]), torch.from_numpy(rows[1]),
                   {"position_ids": torch.from_numpy(dpos)}, tspec)
    for side in ("k", "v"):
        np.testing.assert_array_equal(_bits(tc_[side]), _bits(jc[side]))
    # reads dequantize with the layer's scale row
    jr = jl.read(jc["k"][1], jc["v"][1], {"layer_idx": jnp.int32(1)}, jspec)
    tr = tl.read(tc_["k"][1], tc_["v"][1], {"layer_idx": 1}, tspec)
    for a, b in zip(tr, jr):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # the deferred decode's round trip of a fresh row through the store
    fresh = torch.from_numpy((rng.standard_normal((B, KV, 1, D)) * 30).astype(np.float32))
    want = (jkv.ContiguousKVLayout.clip_to_store(
        jnp.asarray(fresh.numpy()) / (jl._scale_for("k", {"layer_idx": jnp.int32(1)}, False)
                                      if jl.has_array_scales() else jl.k_scale),
        jdt).astype(jdt).astype(jnp.float32))
    sc = jl._scale_for("k", {"layer_idx": jnp.int32(1)}, False) if jl.has_array_scales() \
        else jl.k_scale
    np.testing.assert_array_equal(
        tl.round_trip("k", fresh, tdt, {"layer_idx": 1}).numpy(),
        np.asarray((want * sc).astype(jnp.float32)))


@pytest.mark.parametrize("store", list(STORES))
@pytest.mark.parametrize("scales", [{}, dict(k_scale=0.37, v_scale=2.5)],
                         ids=["direct_cast", "per_tensor"])
def test_block_layout_matches_jax(store, scales):
    jdt, tdt = STORES[store]
    bs, nblk = 8, 6
    rng = np.random.default_rng(9)
    spec_kw = dict(num_layers=1, num_blocks=nblk, block_size=bs, num_kv_heads=KV, head_dim=D,
                   dtype="float32", quant_dtype=store)
    jspec, tspec = jkv.BlockKVCacheSpec(**spec_kw), tkv.BlockKVCacheSpec(**spec_kw)
    jc, tc_ = jkv.init_block_kv_cache(jspec), tkv.init_kv_cache(tspec, "cpu")
    jl, tl = jkv.BlockKVLayout(block_size=bs, **scales), tkv.BlockKVLayout(block_size=bs,
                                                                           **scales)
    k_new = (rng.standard_normal((2, KV, 12, D)) * 30).astype(np.float32)
    v_new = (rng.standard_normal((2, KV, 12, D)) * 30).astype(np.float32)
    sm = rng.permutation(nblk * bs)[:24].reshape(2, 12).astype(np.int32)
    sm[1, 9:] = -1  # padding lanes drop
    jk, jv = jl.update(jc["k"][0], jc["v"][0], jnp.asarray(k_new), jnp.asarray(v_new),
                       {"slot_mapping": jnp.asarray(sm)}, jspec)
    idx = {k: torch.from_numpy(v) for k, v in tkv.scatter_indices(sm).items()}
    tl.update(tc_["k"][0], tc_["v"][0], torch.from_numpy(k_new), torch.from_numpy(v_new), idx,
              tspec)
    np.testing.assert_array_equal(_bits(tc_["k"][0]), _bits(jk))
    np.testing.assert_array_equal(_bits(tc_["v"][0]), _bits(jv))
    bt = np.array([[3, 1, -1, 0], [5, 2, 4, -1]], np.int32)
    jr = jl.read(jk, jv, {"block_table": jnp.asarray(bt)}, jspec)
    tr = tl.read(tc_["k"][0], tc_["v"][0], {"block_table": torch.from_numpy(bt)}, tspec)
    for a, b in zip(tr, jr):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("store", list(STORES))
def test_store_cast_matches_xla(store):
    """The paged layout's plain store cast: out-of-range values overflow and
    saturate as XLA's convert does (torch's own cast differs there)."""
    jdt, tdt = STORES[store]
    x = np.array([0.3, -2.7, 127.4, 300.0, -300.0, 463.9, 464.0, 464.1, 1e5, -6e4, 0.0],
                 np.float32)
    want = jnp.asarray(x).astype(jdt)
    got = tkv.xla_cast(torch.from_numpy(x), tdt)
    np.testing.assert_array_equal(_bits(got), _bits(want))


# ---------------------------------------------------------------------------
# the kernels' plain versions on one-byte stores
# ---------------------------------------------------------------------------


def _quantized_pool(store, rng, total, scale=8.0):
    jdt, _ = STORES[store]
    k = jnp.asarray((rng.standard_normal((total, KV, D)) * scale).astype(np.float32)).astype(jdt)
    v = jnp.asarray((rng.standard_normal((total, KV, D)) * scale).astype(np.float32)).astype(jdt)
    return (k, v), (_to_torch(k), _to_torch(v))


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATTN_TOL, rtol=0)


@pytest.fixture
def launch_counts():
    fns = (tfa.paged_attention_decode, tfa.paged_attention_prefill, tra.ragged_paged_attention,
           tkc.kv_commit_rows)
    for fn in fns:
        fn.launches = 0
    yield lambda: [fn.launches for fn in fns]


@pytest.mark.parametrize("store", list(STORES))
def test_one_byte_paged_kernels_match_pallas(store, launch_counts):
    bs, nblk = 8, 12
    rng = np.random.default_rng(10)
    (jk, jv), (tk, tv) = _quantized_pool(store, rng, nblk * bs)
    bt = rng.permutation(nblk)[:6].reshape(1, 6).astype(np.int32).repeat(2, 0)
    bt[1, 2] = -1  # a hole
    scales = dict(k_scale=0.5, v_scale=2.0)
    q = rng.standard_normal((2, 4, 1, D)).astype(np.float32)
    qp = np.array([[40], [20]], np.int32)
    want = jfa.paged_attention_decode(jnp.asarray(q), jk, jv, jnp.asarray(bt), jnp.asarray(qp),
                                      block_size=bs, **scales)
    _close(tfa.paged_attention_decode(torch.from_numpy(q), tk, tv, torch.from_numpy(bt),
                                      torch.from_numpy(qp), block_size=bs, **scales), want)
    qs = rng.standard_normal((2, 4, 12, D)).astype(np.float32)
    qps = np.array([30, 5], np.int32)[:, None] + np.arange(12, dtype=np.int32)
    want = jfa.paged_attention_prefill(jnp.asarray(qs), jk, jv, jnp.asarray(bt),
                                       jnp.asarray(qps), block_size=bs, **scales)
    _close(tfa.paged_attention_prefill(torch.from_numpy(qs), tk, tv, torch.from_numpy(bt),
                                       torch.from_numpy(qps), block_size=bs, **scales), want)
    # the ragged stream: a 10-token chunk of row 0, a decode token of row 1, padding
    qr = rng.standard_normal((1, 4, 16, D)).astype(np.float32)
    rid = np.array([0] * 10 + [1] + [-1] * 5, np.int32)
    qpr = np.array(list(range(30, 40)) + [20] + [0] * 5, np.int32)
    want = jax_ragged(jnp.asarray(qr), jk, jv, jnp.asarray(bt), jnp.asarray(rid),
                      jnp.asarray(qpr), block_size=bs, block_q=8, **scales)
    got = tra.ragged_paged_attention(torch.from_numpy(qr), tk, tv, bt, rid, qpr, block_size=bs,
                                     **scales)
    _close(got, want)
    assert torch.equal(got[:, :, 11:], torch.zeros_like(got[:, :, 11:]))
    assert launch_counts() == [0, 0, 0, 0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["paged_decode", "ragged"])
@pytest.mark.parametrize("store", list(STORES))
def test_one_byte_plain_equals_upcast_pool(store, kernel, dtype, launch_counts):
    """The invariant the card holds the one-byte decode and split kernels to:
    the plain version over a one-byte pool equals, bit for bit, its own
    output on the pool up-cast to q's dtype under the same scales (every
    store value is exact there); with f32 q both equal the Pallas kernel in
    interpret mode on the one-byte pool."""
    bs, nblk = 8, 12
    rng = np.random.default_rng(12)
    (jk, jv), (tk, tv) = _quantized_pool(store, rng, nblk * bs)
    bt = rng.permutation(nblk)[:6].reshape(1, 6).astype(np.int32).repeat(2, 0)
    bt[1, 2] = -1  # a hole
    scales = dict(k_scale=0.5, v_scale=2.0)
    up_k, up_v = tk.to(dtype), tv.to(dtype)
    if kernel == "paged_decode":
        q = rng.standard_normal((2, 4, 1, D)).astype(np.float32)
        qp = np.array([[40], [20]], np.int32)
        args = (torch.from_numpy(bt), torch.from_numpy(qp))

        def run(k, v):
            return tfa.paged_attention_decode(torch.from_numpy(q).to(dtype), k, v, *args,
                                              block_size=bs, **scales)

        def pallas():
            return jfa.paged_attention_decode(jnp.asarray(q), jk, jv, jnp.asarray(bt),
                                              jnp.asarray(qp), block_size=bs, **scales)
    else:  # decode tokens of both rows (split items), a 3-token run of row 0, padding
        q = rng.standard_normal((1, 4, 8, D)).astype(np.float32)
        rid = np.array([1, 0, 0, 0, 0, -1, -1, -1], np.int32)
        qpr = np.array([20, 37, 38, 39, 40, 0, 0, 0], np.int32)

        def run(k, v):
            return tra.ragged_paged_attention(torch.from_numpy(q).to(dtype), k, v, bt, rid, qpr,
                                              block_size=bs, **scales)

        def pallas():
            return jax_ragged(jnp.asarray(q), jk, jv, jnp.asarray(bt), jnp.asarray(rid),
                              jnp.asarray(qpr), block_size=bs, block_q=8, **scales)
    got = run(tk, tv)
    assert got.dtype == dtype
    np.testing.assert_array_equal(_bits(got), _bits(run(up_k, up_v)))
    if dtype == torch.float32:
        _close(got, pallas())
    assert launch_counts() == [0, 0, 0, 0]


@pytest.mark.parametrize("store", list(STORES))
def test_one_byte_commit_matches_pallas(store, launch_counts):
    jdt, tdt = STORES[store]
    rng = np.random.default_rng(11)
    Lc, Bc, Sc = 2, 3, 128
    cache = jnp.asarray((rng.standard_normal((Lc, Bc, KV, Sc, D)) * 4).astype(np.float32))
    rows = jnp.asarray((rng.standard_normal((Lc, Bc, KV, 1, D)) * 4).astype(np.float32))
    cache, rows = cache.astype(jdt), rows.astype(jdt)
    pos = np.array([[5], [127], [-1]], np.int32)
    want_k, want_v = jkc.kv_commit_rows(cache, cache, rows, rows, jnp.asarray(pos))
    ck, cv = _to_torch(cache), _to_torch(cache)
    tkc.kv_commit_rows(ck, cv, _to_torch(rows), _to_torch(rows), torch.from_numpy(pos))
    np.testing.assert_array_equal(_bits(ck), _bits(want_k))
    np.testing.assert_array_equal(_bits(cv), _bits(want_v))
    assert launch_counts() == [0, 0, 0, 0]


def test_one_byte_wrappers_refuse_mixed_stores():
    q = torch.zeros((1, 4, 1, 16))
    k = torch.zeros((64, 2, 16), dtype=torch.float8_e4m3fn)
    v = torch.zeros((64, 2, 16), dtype=torch.float8_e5m2)
    from nxdi_tpu_torch.ops.kernels import _build

    with pytest.raises(TypeError, match="neither q's"):
        _build.store_code(torch.zeros(1, dtype=torch.float16), q, "x")
    assert _build.store_code(k, q, "x") == 2 and _build.store_code(v, q, "x") == 3
    c16, r16 = (torch.zeros((1, 1, 2, n, 16), dtype=torch.float16) for n in (8, 1))
    with pytest.raises(TypeError, match="not supported"):
        tkc.kv_commit_rows(c16, c16, r16, r16, torch.zeros((1, 1), dtype=torch.int32))


# ---------------------------------------------------------------------------
# the handoff's export / import
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("store", ["float8_e4m3", None])
def test_export_import_roundtrip_and_refusals(store):
    bs, nblk = 4, 8
    spec_kw = dict(num_layers=2, num_blocks=nblk, block_size=bs, num_kv_heads=KV, head_dim=D,
                   dtype="bfloat16", quant_dtype=store)
    rng = np.random.default_rng(12)
    src = tkv.init_kv_cache(tkv.BlockKVCacheSpec(**spec_kw), "cpu")
    for side in ("k", "v"):
        src[side].copy_(torch.from_numpy(rng.standard_normal(src[side].shape).astype(
            np.float32)).to(src[side].dtype))
    dst = tkv.init_kv_cache(tkv.BlockKVCacheSpec(**spec_kw), "cpu")
    # the JAX package's gather/scatter on the same bits
    jsrc = {s: jnp.asarray(_bits(src[s])) for s in ("k", "v")}
    payload = tkv.export_kv_blocks(src, [5, 2, 7], bs)
    jpayload = jkv.export_kv_blocks(jsrc, [5, 2, 7], bs)
    for s in ("k", "v"):
        assert payload[s].dtype == src[s].dtype and payload[s].shape == (2, 12, KV, D)
        np.testing.assert_array_equal(_bits(payload[s]), jpayload[s])
    out = tkv.import_kv_blocks(dst, [1, 0, 6], payload, bs)
    assert out is dst
    for s in ("k", "v"):
        np.testing.assert_array_equal(_bits(dst[s][:, 4:8]), _bits(src[s][:, 20:24]))
        np.testing.assert_array_equal(_bits(dst[s][:, 24:28]), _bits(src[s][:, 28:32]))
    jdst = {s: jnp.zeros(jsrc[s].shape, jsrc[s].dtype) for s in ("k", "v")}
    bad = [
        ([1, 0], payload, "length mismatch"),
        ([1, 0, 6], {s: payload[s][:1] for s in ("k", "v")}, "layout mismatch"),
        ([1, 0, 6], {s: payload[s].view(torch.uint8) if payload[s].element_size() == 1
                     else payload[s].float() for s in ("k", "v")}, "dtype mismatch"),
        ([], payload, "empty block chain"),
        ([1, -1, 6], payload, "negative block id"),
    ]
    for blocks, p, msg in bad:
        with pytest.raises(ValueError, match=msg):
            tkv.import_kv_blocks(dst, blocks, p, bs)
        if msg != "dtype mismatch":  # the JAX side sees the same check
            jp = {s: np.asarray(_bits(p[s])) for s in ("k", "v")}
            with pytest.raises(ValueError, match=msg):
                jkv.import_kv_blocks(jdst, blocks, jp, bs)


# ---------------------------------------------------------------------------
# calibration and end to end
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["per_tensor", "per_key", "per_channel"])
def test_calibrate_kv_scales_matches_jax(tiny_hf_llama, mode):
    hf_model, hf_cfg = tiny_hf_llama
    japp, tapp = jax_app(hf_model, hf_cfg), port_app(hf_model, hf_cfg)
    prompts = [PROMPT[0, :6].tolist(), PROMPT[0].tolist()]
    want = jcal.calibrate_kv_scales(japp, prompts, mode=mode)
    got = tcal.calibrate_kv_scales(tapp, prompts, mode=mode)
    for key in ("k_scales", "v_scales"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5)
    with pytest.raises(ValueError, match="WITHOUT kv_quant_config"):
        tcal.calibrate_kv_scales(port_app(hf_model, hf_cfg, kv_cache_quant=True), prompts)


def _kvq(hf_model, hf_cfg, mode):
    if mode == "direct_cast":
        return dict(kv_cache_quant=True)
    if mode == "per_tensor":
        return dict(kv_quant_config=dict(dtype="int8", scale_mode="per_tensor",
                                         k_scale=0.05, v_scale=0.02))
    scales = tcal.calibrate_kv_scales(port_app(hf_model, hf_cfg), [PROMPT[0].tolist()],
                                      mode=mode)
    return dict(kv_quant_config=dict(dtype="float8_e5m2", scale_mode=mode,
                                     k_scales=scales["k_scales"].tolist(),
                                     v_scales=scales["v_scales"].tolist()))


@pytest.mark.parametrize("mode", ["direct_cast", "per_tensor", "per_channel"])
def test_kv_quant_generate_token_identical(tiny_hf_llama, mode):
    hf_model, hf_cfg = tiny_hf_llama
    kw = _kvq(hf_model, hf_cfg, mode)
    japp, tapp = jax_app(hf_model, hf_cfg, **kw), port_app(hf_model, hf_cfg, **kw)
    want = JaxAdapter(japp).generate(PROMPT, max_new_tokens=10)
    got = HuggingFaceGenerationAdapter(tapp).generate(PROMPT, max_new_tokens=10)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert tapp.kv_cache["k"].dtype == STORES[tapp.tpu_config.kv_quant_config.dtype][1]
    # the stacked fused decode is off a quantized store; both packages take
    # the per-layer fused kernel over the dequantized lines
    assert _strategies(tapp) == _strategies(japp)
    for side in ("k", "v"):  # the stores hold the same bits
        np.testing.assert_array_equal(
            _bits(tapp.kv_cache[side]), _bits(_to_torch(jax.device_get(japp.kv_cache[side]))))


def test_paged_engine_on_fp8_pool_matches_jax_engine(tiny_hf_llama):
    hf_model, hf_cfg = tiny_hf_llama
    pair = _Pair(hf_model, hf_cfg, pa_block_size=8, pa_num_blocks=32, ctx_batch_size=1,
                 tkg_batch_size=3, attn_kernel_enabled=True, attn_block_tkg_kernel_enabled=True,
                 is_prefix_caching=True, kv_cache_quant=True)
    prompts = {"a": [5, 9, 3, 17, 2, 8, 11, 42, 7], "b": [7, 13, 21, 4, 33],
               "c": [5, 9, 3, 17, 2, 8, 11, 42, 7, 13, 21]}

    def drive(eng, SP):
        reqs = {k: eng.add_request(p, SP(max_new_tokens=8)) for k, p in prompts.items()}
        return _streams(eng.run(), reqs)

    jeng, teng = pair.engines(prefix_cache=True)
    assert drive(teng, SamplingParams) == drive(jeng, JaxSP)
    assert pair.tapp.kv_cache["k"].dtype == torch.float8_e4m3fn
    pair.strategies_match()


@pytest.mark.parametrize("store", list(STORES))
def test_one_byte_pool_takes_the_mma_sync_prefill_body(store):
    """q stays bf16 and wgmma multiplies bf16 only by bf16: a one-byte
    pool's paged prefill runs the mma.sync body for bf16 q at head dims
    other than 64 and 128 (at 64 and 128 the one-byte TMA + wgmma body,
    which converts the raw boxes to bf16 in shared memory) or the CUDA
    cores (f32), and the card's limits admit it only at head dims that are
    multiples of 16."""
    from nxdi_tpu_torch.models.base import _card_limits

    tdt = STORES[store][1]
    q = torch.zeros((1, 8, 128, 64), dtype=torch.bfloat16)
    pool = torch.zeros((8 * 64, 2, 64), dtype=tdt)
    q32, pool32 = q[..., :32].contiguous(), pool[..., :32].contiguous()
    assert tfa.paged_prefill_body(q32, pool32, pool32, 64) == "mma"
    assert tfa.paged_prefill_body(q, pool, pool, 64) == "wgmma"
    assert tfa.paged_prefill_body(q.float(), pool, pool, 64) == "simt"
    assert tfa.paged_prefill_body(q, pool.to(torch.bfloat16), pool.to(torch.bfloat16),
                                  64) == "wgmma"
    assert _card_limits(64, torch.bfloat16, store=tdt) == []
    assert "multiple of 16" in _card_limits(40, torch.bfloat16, store=tdt)[-1]
    assert "one-byte" in _card_limits(64, torch.bfloat16, store=torch.float16)[-1]
