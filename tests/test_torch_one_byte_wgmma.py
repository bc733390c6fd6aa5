"""The one-byte pool's TMA + wgmma body (``csrc/prefill_wgmma.cuh``,
``prefill_wgmma_1b_kernel``), checked without a card: which body a call
runs, the boxes its producer loads, and the ragged plan's wgmma items.

- ``paged_prefill_body`` picks ``"wgmma"`` for bf16 q over float8_e4m3fn,
  float8_e5m2 and int8 pools at head dims 64 and 128 for every block size
  the tile walk takes (8, 16, 32, 64 and multiples of 128), and so does
  ``ragged_direct_body`` for the ragged kernel's one-row tiles; f32 q,
  other head dims and other block sizes keep the mma.sync or CUDA-core
  bodies; a pool whose base or strides TMA cannot take raises (an eligible
  call never falls back).
- The boxes ``paged_prefill_boxes`` lists (the producer's TMA loads, raw
  one-byte rows here) cover every live pool block of a row once and never
  a hole.
- ``ragged_plan(wgmma=True)``'s wgmma items and split items cover every
  (token, visible position) pair exactly once, every token written once,
  at every rung of the mixed engine's ladder with 8, 64 and 96 rows, and
  with a chunk whose positions are not consecutive (its tile goes to the
  split items); the plan fits the bucket's capacity.
- A plain emulation of what the kernels do with such a plan (each wgmma
  item a paged prefill chunk of its row) agrees with
  ``ragged_paged_attention_plain`` and with the JAX package's Pallas kernel
  in interpret mode on a one-byte pool. Tolerance 1e-5 (float32), as the
  ragged plan's own tests: only the order of the sums differs.
"""

import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nxdi_tpu.ops.kernels import ragged_paged_attention as jax_ragged  # the function
from nxdi_tpu_torch.ops.kernels import flash_attention as fa
from nxdi_tpu_torch.ops.kernels import ragged_paged_attention as rpa
from nxdi_tpu_torch.runtime.model_wrapper import MixedModelWrapper
from test_torch_ragged_plan import LADDER, TOL, _check_plan, _emulate, _engine_stream
from test_torch_slice import fresh_jax_compiles

STORES = {"float8_e4m3": (jnp.float8_e4m3fn, torch.float8_e4m3fn),
          "float8_e5m2": (jnp.float8_e5m2, torch.float8_e5m2),
          "int8": (jnp.int8, torch.int8)}
BLOCKS = (8, 16, 32, 64, 128, 256)  # the block sizes the TMA tile walk takes


@pytest.fixture(autouse=True, scope="module")
def _fresh_jax_compiles():
    with fresh_jax_compiles():
        yield


def _q(S, H, D, dtype=torch.bfloat16):
    """(1, H, S, D) as the model hands it over: a transposed (1, S, H, D)."""
    return torch.zeros((1, S, H, D), dtype=dtype).transpose(1, 2)


@pytest.mark.parametrize("bs", BLOCKS)
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("store", list(STORES))
def test_one_byte_pool_takes_the_wgmma_body(store, D, bs):
    tdt = STORES[store][1]
    pool = torch.zeros((4 * max(bs, 128), 2, D), dtype=tdt)
    assert fa.paged_prefill_body(_q(200, 8, D), pool, pool, bs) == "wgmma"
    assert rpa.ragged_direct_body(torch.bfloat16, tdt, D, bs) == "wgmma"


@pytest.mark.parametrize("store", list(STORES))
def test_one_byte_pool_keeps_the_other_bodies(store):
    tdt = STORES[store][1]
    pool = torch.zeros((512, 2, 64), dtype=tdt)
    # f32 q: the CUDA cores
    assert fa.paged_prefill_body(_q(40, 8, 64, torch.float32), pool, pool, 64) == "simt"
    assert rpa.ragged_direct_body(torch.float32, tdt, 64, 64) == "simt"
    # other head dims that are multiples of 16: mma.sync
    p32 = torch.zeros((512, 2, 32), dtype=tdt)
    assert fa.paged_prefill_body(_q(40, 8, 32), p32, p32, 64) == "mma"
    assert rpa.ragged_direct_body(torch.bfloat16, tdt, 32, 64) == "mma"
    # block sizes the tile walk does not take
    for bs in (4, 12, 48, 96, 192):
        assert fa.paged_prefill_body(_q(40, 8, 64), pool[:bs * 4], pool[:bs * 4], bs) == "mma"
        assert rpa.ragged_direct_body(torch.bfloat16, tdt, 64, bs) == "mma"
    # a bf16 pool's ragged tiles stay direct
    assert rpa.ragged_direct_body(torch.bfloat16, torch.bfloat16, 64, 64) == "mma"


@pytest.mark.parametrize("store", list(STORES))
def test_one_byte_wgmma_raises_on_strides_tma_cannot_take(store):
    tdt = STORES[store][1]
    q = _q(40, 8, 64)
    # a base 8 bytes off 16-byte alignment
    buf = torch.zeros(512 * 2 * 64 + 8, dtype=torch.uint8)
    off = buf[8:].view(tdt).view(512, 2, 64)
    # rows 72 bytes apart
    wide = torch.zeros((512, 2, 72), dtype=tdt)[..., :64]
    for pool in (off, wide):
        with pytest.raises(ValueError, match="TMA"):
            fa.paged_prefill_body(q, pool, pool, 64)


@pytest.mark.parametrize("bs", BLOCKS)
def test_one_byte_boxes_cover_every_live_block_once(bs):
    """Three rows of tables with holes (one all holes, one past its last
    live block): the boxes of every kv tile up to the table's width load
    each live block's slots once and no hole."""
    rng = np.random.default_rng(bs)
    NB = max(2, 2048 // bs)
    table = rng.permutation(3 * NB).reshape(3, NB).astype(np.int64)
    table[0, rng.choice(NB, NB // 3, replace=False)] = -1
    table[1, :] = -1
    table[2, NB // 2:] = -1
    for row in table:
        loaded = []
        for kt in range(-(-NB * bs // fa.PAGED_TILE)):
            for first, slot, rows in fa.paged_prefill_boxes(row, kt, bs):
                assert rows == min(bs, fa.PAGED_TILE) and first % rows == 0
                pos = kt * fa.PAGED_TILE + first  # the box's first logical position
                assert row[pos // bs] >= 0 and slot == row[pos // bs] * bs + pos % bs
                loaded += range(slot, slot + rows)
        want = [s for b in row if b >= 0 for s in range(b * bs, (b + 1) * bs)]
        assert sorted(loaded) == sorted(want) and len(set(loaded)) == len(loaded)


@pytest.mark.parametrize("R", [8, 64, 96])
@pytest.mark.parametrize("T", LADDER)
def test_wgmma_plan_covers_every_pair_once(T, R):
    rng = np.random.default_rng(T * 10 + R)
    kv_width = 16 * 128
    rid, qp = _engine_stream(T, R, rng, kv_width)
    plan = rpa.ragged_plan(rid, qp, R, kv_width, 8, wgmma=True)
    assert plan.wgmma and plan.n_direct == 0
    _check_plan(plan, rid, qp, R, kv_width)
    # the same one-row tiles the direct-tile plan runs, as items of up to 128 tokens
    direct = rpa.ragged_plan(rid, qp, R, kv_width, 8)
    n_direct_tokens = sum(int(((rid[t * rpa.TILE:(t + 1) * rpa.TILE] >= 0)
                               & (rid[t * rpa.TILE:(t + 1) * rpa.TILE] < R)).sum())
                          for t in direct.direct_tiles())
    assert int(plan.wgmma_items()[:, 1].sum()) == n_direct_tokens
    assert plan.n_wg == -(-len(direct.direct_tiles()) // 2)  # the engine's chunk: tiles paired
    extents = plan.wgmma_items()[:, 3] + plan.wgmma_items()[:, 1]
    assert list(extents) == sorted(extents, reverse=True)  # longest first
    cap = rpa.ragged_capacity(T, R, kv_width, 8, wgmma=True)
    padded = rpa.pad_plan(plan, cap)
    assert padded.size == cap.flat_len and np.array_equal(padded[:plan.flat_len], plan.flat)
    with pytest.raises(ValueError, match="capacity"):
        rpa.pad_plan(plan, rpa.ragged_capacity(T, R, kv_width, 8))


def test_wgmma_plan_sends_a_jumping_chunk_to_the_split_items():
    """A 192-token chunk whose positions jump inside its second tile: its
    first tile is one wgmma item (the jump stops the merge), the jumping
    tile's tokens are split items, its third tile another item; a chunk of
    30 sharing no tile, then padding inside its tile (written 0)."""
    T, R, kv_width = 320, 4, 1024
    rid = np.full(T, -1, np.int32)
    qp = np.zeros(T, np.int32)
    rid[:192], qp[:192] = 1, np.arange(100, 292)
    qp[100:192] += 7  # the jump, mid tile 1
    rid[192:222], qp[192:222] = 3, np.arange(0, 30)
    plan = rpa.ragged_plan(rid, qp, R, kv_width, 8, wgmma=True)
    _check_plan(plan, rid, qp, R, kv_width)
    assert sorted(plan.wgmma_items().tolist()) == [[0, 64, 1, 100], [128, 64, 1, 235],
                                                   [192, 30, 3, 0]]
    assert set(plan.items()[:, 0]) == set(range(64, 128))
    zeroed = plan.combined()[plan.combined()[:, 2] == 0, 0]
    assert list(zeroed) == list(range(222, T))


@pytest.mark.parametrize("store", list(STORES))
def test_wgmma_plan_matches_plain_and_jax_on_one_byte_pools(store):
    """Rows 2 (a 128-token chunk after 20 cached, a hole inside it: one
    merged wgmma item), 3 (44 tokens sharing a tile with decode rows: split
    items; a hole), 0 and 1 (decode), 4 (all holes: sees nothing), 5 (39
    tokens, then padding in its tile: an item of 39); a one-byte pool cast
    as the JAX package casts it, with scales that bring its values back near
    1 (fp8: values ~2, k_scale 0.5, v_scale 2; int8: values ~20, both
    scales 0.05), so the f32 outputs are of order 1."""
    jdt, tdt = STORES[store]
    rng = np.random.default_rng(29)
    T, H, KV, D, bs, NB, R = 256, 4, 2, 16, 16, 10, 6
    scale = 20.0 if store == "int8" else 2.0
    k = jnp.asarray((rng.standard_normal((64 * bs, KV, D)) * scale).astype(np.float32)).astype(jdt)
    v = jnp.asarray((rng.standard_normal((64 * bs, KV, D)) * scale).astype(np.float32)).astype(jdt)

    def to_torch(x):
        a = np.asarray(x)
        if a.dtype.itemsize == 1 and a.dtype != np.int8:
            return torch.from_numpy(a.view(np.uint8).copy()).view(tdt)
        return torch.from_numpy(np.array(a, copy=True))

    tk, tv = to_torch(k), to_torch(v)
    perm = rng.permutation(64)
    bt = np.full((R, NB), -1, np.int32)
    bt[2], bt[3, :3], bt[0, :8], bt[1, :1], bt[5, :3] = perm[:10], perm[10:13], perm[13:21], \
        perm[21:22], perm[22:25]
    bt[2, 3] = -1
    bt[3, 1] = -1
    rid = np.full(T, -1, np.int32)
    qp = np.zeros(T, np.int32)
    rid[:128], qp[:128] = 2, np.arange(20, 148)
    rid[128:172], qp[128:172] = 3, np.arange(0, 44)
    rid[172:175], qp[172:175] = [0, 1, 4], [120, 9, 30]
    rid[192:231], qp[192:231] = 5, np.arange(7, 46)
    q = rng.standard_normal((1, H, T, D)).astype(np.float32)
    plan = rpa.ragged_plan(rid, qp, R, NB * bs, KV, wgmma=True)
    assert plan.wgmma_items().tolist() == [[0, 128, 2, 20], [192, 39, 5, 7]]
    _check_plan(plan, rid, qp, R, NB * bs)
    scales = dict(k_scale=0.05, v_scale=0.05) if store == "int8" else dict(k_scale=0.5,
                                                                            v_scale=2.0)
    qt = torch.from_numpy(q)
    got = _emulate(qt, tk, tv, bt, rid, qp, plan, bs, None, **scales)
    assert not torch.isnan(got).any()
    assert torch.all(got[:, :, 174] == 0) and torch.all(got[:, :, 231:] == 0)
    plain = rpa.ragged_paged_attention_plain(qt, tk, tv, bt, rid, qp, block_size=bs, **scales)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=TOL, rtol=0)
    want = jax_ragged(jnp.asarray(q), k, v, jnp.asarray(bt), jnp.asarray(rid), jnp.asarray(qp),
                      block_size=bs, block_q=8, **scales)
    real = np.flatnonzero(rid >= 0)
    np.testing.assert_allclose(got.numpy()[:, :, real], np.asarray(want)[:, :, real], atol=TOL,
                               rtol=0)


@pytest.mark.parametrize("kv_quant,want", [(None, False), ("float8_e4m3", True),
                                           ("int8", True)])
def test_mixed_wrapper_builds_wgmma_plans_over_one_byte_pools(kv_quant, want):
    """The mixed step's wrapper builds its plans (and its graphs' capacity)
    with wgmma items exactly when the ragged kernel's one-row tiles run the
    one-byte body: Llama-3.2-1B's widths (bf16, head dim 64) at block 128."""
    w = object.__new__(MixedModelWrapper)
    w.arch = types.SimpleNamespace(dtype="bfloat16", kv_quant_dtype=kv_quant, head_dim=64,
                                   num_kv_heads=8)
    w.layout = types.SimpleNamespace(block_size=128)
    w.config = types.SimpleNamespace(tpu_config=types.SimpleNamespace(seq_len=2048))
    w.num_rows = 8
    assert w._ragged_wgmma() is want
    cap = w._ragged_capacity(1032)
    assert cap.wgmma is want and (cap.n_wg > 0) is want and (cap.n_direct > 0) is not want
