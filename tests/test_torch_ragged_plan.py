"""The ragged kernels' work list (``ragged_paged_attention.ragged_plan``) and
the contiguous prefill's body choice (``flash_attention.prefill_body``),
checked without a card.

- The plan covers every (token, visible key position) pair exactly once and
  gives every token exactly one writer (a direct tile, a one-chunk item, or
  the combine), at every rung of the mixed engine's packed-token ladder
  (2 ... 1032), with the engine's chunk-first packing, slots that do not
  ascend, a token that sees no position, and 1, 8 and 64 rows; and with 65
  and 96 rows, which only the split plan takes (``split=False``, the
  one-kernel design with a 64-bit row mask per tile, still refuses them).
- A plain emulation of what the CUDA kernels do with the plan (per-chunk
  f32 softmax states, merged in chunk order; direct tiles through the plain
  version) agrees with ``ragged_paged_attention_plain`` and with the JAX
  package's Pallas kernel in interpret mode. Tolerance 1e-5 (float32): only
  the order of the sums differs. Also with 96 rows.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nxdi_tpu.ops.kernels import ragged_paged_attention as jax_ragged  # the function
from nxdi_tpu_torch.ops.attention import NEG_INF
from nxdi_tpu_torch.ops.kernels import flash_attention as fa
from nxdi_tpu_torch.ops.kernels import ragged_paged_attention as rpa
from nxdi_tpu_torch.runtime.autobucketing import generate_buckets
from test_torch_slice import fresh_jax_compiles

LADDER = generate_buckets(2, 1024 + 8)  # mixed_token_buckets at max_context_length 1024, 8 slots
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _fresh_jax_compiles():
    # the Pallas reference compiles without a persistent cache an earlier
    # test on this worker left on (ROADMAP Queue 3)
    with fresh_jax_compiles():
        yield


def _engine_stream(T, R, rng, kv_width):
    """The mixed engine's packing at bucket T: a prefill chunk of one slot
    first (when the bucket has room), then one decode token for each of up
    to R - 1 other slots in shuffled order, then padding (-1). One decode
    token sits past the table's width, one at position 0."""
    rid = np.full(T, -1, np.int32)
    qp = np.zeros(T, np.int32)
    slots = rng.permutation(R)
    n_dec = min(R - 1 if T > R else T, T) if R > 1 else 0
    n_chunk = T - n_dec if T > 8 else 0
    t = 0
    if n_chunk or R == 1:
        n_chunk = max(n_chunk, 1)
        start = int(rng.integers(0, max(1, kv_width - n_chunk)))
        rid[:n_chunk], qp[:n_chunk] = slots[0], start + np.arange(n_chunk)
        t = n_chunk
    for i, s in enumerate(slots[1:1 + min(n_dec, T - t)]):
        rid[t] = s
        qp[t] = 0 if i == 1 else kv_width + 5 if i == 2 else int(rng.integers(1, kv_width))
        t += 1
    return rid, qp


def _check_plan(plan, rid, qp, R, kv_width):
    """Every real token's visible positions [0, min(pos + 1, kv_width))
    covered once, every token written once."""
    T = rid.shape[0]
    writers = np.zeros(T, np.int64)
    covered = {}
    for tile in plan.direct_tiles():
        for t in range(tile * rpa.TILE, min(T, (tile + 1) * rpa.TILE)):
            writers[t] += 1
            if 0 <= rid[t] < R:
                covered[t] = [(0, min(int(qp[t]) + 1, kv_width))]
    for t0, n, row, p0 in plan.wgmma_items():  # one row's run at consecutive positions
        assert plan.wgmma and not plan.n_direct and 0 < n <= rpa.WG_TILE
        for t in range(t0, t0 + n):
            assert rid[t] == row and qp[t] == p0 + t - t0
            writers[t] += 1
            covered[t] = [(0, min(int(qp[t]) + 1, kv_width))]
    slots = set()
    for t, row, lo, hi, c, nch, first in plan.items():
        assert 0 <= lo < hi <= kv_width and hi - lo <= plan.chunk and lo == c * plan.chunk
        assert rid[t] == row and t // rpa.TILE not in plan.direct_tiles()
        covered.setdefault(t, []).append((lo, min(hi, int(qp[t]) + 1)))
        if nch == 1:
            writers[t] += (c == 0)
        else:
            slot = first + c
            assert slot not in slots and 0 <= slot < plan.n_slots
            slots.add(slot)
    for t, first, nch in plan.combined():
        writers[t] += 1
        if nch == 0:
            assert not (0 <= rid[t] < R) or min(int(qp[t]) + 1, kv_width) <= 0 or t not in covered
    assert len(slots) == plan.n_slots
    assert np.all(writers == 1), np.nonzero(writers != 1)
    for t in range(T):
        if not (0 <= rid[t] < R):
            continue
        want = max(0, min(int(qp[t]) + 1, kv_width))
        got = sorted((lo, hi) for lo, hi in covered.get(t, []) if hi > lo)
        pos = 0
        for lo, hi in got:  # contiguous, no overlap, from 0 to the token's limit
            assert lo == pos, (t, got)
            pos = hi
        assert pos == want, (t, got, want)


@pytest.mark.parametrize("R", [1, 8, 64])
@pytest.mark.parametrize("T", LADDER)
def test_plan_covers_every_pair_once(T, R):
    rng = np.random.default_rng(T * 100 + R)
    kv_width = 16 * 128
    rid, qp = _engine_stream(T, R, rng, kv_width)
    plan = rpa.ragged_plan(rid, qp, R, kv_width, 8)
    _check_plan(plan, rid, qp, R, kv_width)
    blocks = 8 * plan.n_items
    if plan.n_items and plan.chunk > rpa.CHUNK_UNIT:
        # a larger chunk only while the launch stays full
        assert blocks >= rpa.MIN_SPLIT_BLOCKS
    legacy = rpa.ragged_plan(rid, qp, R, kv_width, 8, split=False)
    assert legacy.n_items == legacy.n_comb == 0
    assert legacy.n_direct == -(-T // rpa.TILE)
    _check_plan(legacy, rid, qp, R, kv_width)


@pytest.mark.parametrize("R", [65, 96])
@pytest.mark.parametrize("T", [64, 128, 256, 1032])
def test_plan_covers_every_pair_once_beyond_64_rows(T, R):
    """More rows than the one-kernel design's 64-bit mask holds: the split
    plan covers them (its direct tiles hold one row each), split=False
    refuses them with the kernel's message."""
    rng = np.random.default_rng(T * 1000 + R)
    kv_width = 16 * 128
    rid, qp = _engine_stream(T, R, rng, kv_width)
    plan = rpa.ragged_plan(rid, qp, R, kv_width, 8)
    assert plan.split
    _check_plan(plan, rid, qp, R, kv_width)
    for tile in plan.direct_tiles():  # one row per direct tile
        rows = rid[tile * rpa.TILE:(tile + 1) * rpa.TILE]
        assert len(set(rows[(rows >= 0) & (rows < R)].tolist())) == 1
    with pytest.raises(ValueError, match=f"{R} rows exceed the kernel's {rpa.MAX_ROWS}"):
        rpa.ragged_plan(rid, qp, R, kv_width, 8, split=False)
    assert not rpa.ragged_plan(rid, qp, rpa.MAX_ROWS, kv_width, 8, split=False).split


def test_plan_decode_only_bucket_8():
    """Phase 3c's decode-only point: 8 rows, one token each at 230 ... 1000,
    kv heads 8. Every token is split; the launch holds >= 2 blocks per SM."""
    rid = np.arange(8, dtype=np.int32)
    qp = np.array([230 + 110 * i for i in range(8)], np.int32)
    plan = rpa.ragged_plan(rid, qp, 8, 16 * 128, 8)
    assert plan.n_direct == 0 and plan.chunk == 128
    assert plan.n_items == sum(-(-(p + 1) // 128) for p in qp)
    assert 8 * plan.n_items >= rpa.MIN_SPLIT_BLOCKS
    assert sorted(plan.combined()[:, 0]) == list(range(8))
    _check_plan(plan, rid, qp, 8, 16 * 128)


def test_plan_prefill_chunk_tiles_are_direct():
    """A 512-token chunk then 7 decode tokens, padded to 1032 (phase 3c's
    packed stream): the chunk's 8 tiles run the direct kernel, the decode
    tokens split, the padding is zeroed by the combine."""
    T = 1032
    rid = np.full(T, -1, np.int32)
    qp = np.zeros(T, np.int32)
    rid[:512], qp[:512] = 5, np.arange(384, 896)
    rid[512:519], qp[512:519] = [3, 0, 7, 1, 6, 2, 4], [200 + 300 * i for i in range(7)]
    plan = rpa.ragged_plan(rid, qp, 8, 16 * 128, 8)
    assert list(plan.direct_tiles()) == list(range(8))
    assert set(plan.items()[:, 0]) == set(range(512, 519))
    zeroed = plan.combined()[plan.combined()[:, 2] == 0, 0]
    assert list(zeroed) == list(range(519, T))
    _check_plan(plan, rid, qp, 8, 16 * 128)


def _take(cache, slots):
    """``cache[slots]``, fp8 stores gathered as bytes."""
    if cache.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
        return cache.view(torch.uint8)[slots].view(cache.dtype)
    return cache[slots]


def _emulate(q, k, v, bt, rid, qp, plan, bs, scale, k_scale, v_scale):
    """What the CUDA kernels compute with ``plan``, in float32: direct tiles
    through the plain version (the prefill kernels' arithmetic), each wgmma
    item as the paged prefill of its row's chunk (positions p0 + i), each
    item one chunk's softmax state (m, l, acc) per token and q head, written
    out for a one-chunk run or merged by the combine in chunk order. K/V may
    be a one-byte store (read as its values)."""
    H, T, D = q.shape[1], q.shape[2], q.shape[3]
    G = H // k.shape[1]
    sc = (D ** -0.5 if scale is None else scale) * k_scale
    out = torch.full_like(q, float("nan"))
    plain = rpa.ragged_paged_attention_plain(q, k, v, bt, rid, qp, block_size=bs, scale=scale,
                                             k_scale=k_scale, v_scale=v_scale)
    for tile in plan.direct_tiles():
        sl = slice(tile * rpa.TILE, (tile + 1) * rpa.TILE)
        out[:, :, sl] = plain[:, :, sl]
    # a wgmma item: a paged prefill chunk of its row (positions p0 + i)
    for t0, n, row, p0 in plan.wgmma_items():
        out[:, :, t0:t0 + n] = fa.paged_attention_plain(
            q[:, :, t0:t0 + n], k, v, torch.from_numpy(bt[row:row + 1]),
            torch.arange(p0, p0 + n)[None], block_size=bs, scale=scale, k_scale=k_scale,
            v_scale=v_scale)
    heads = torch.arange(H) // G
    partial = {}
    for t, row, lo, hi, c, nch, first in plan.items():
        j = torch.arange(lo, hi)
        blk = torch.from_numpy(bt[row])[j // bs].long()
        slot = (blk * bs + j % bs).clamp(min=0)
        kk, vv = (_take(c, slot)[:, heads].float() for c in (k, v))  # (L, H, D)
        vis = (blk >= 0) & (j <= int(qp[t]))
        s = torch.einsum("hd,lhd->hl", q[0, :, t], kk) * sc
        s = torch.where(vis, s, torch.full_like(s, NEG_INF))
        m = s.amax(dim=-1)
        p = torch.where(vis, torch.exp(s - m[:, None]), torch.zeros_like(s))
        l, acc = p.sum(dim=-1), torch.einsum("hl,lhd->hd", p, vv)
        if nch == 1:
            out[0, :, t] = acc * v_scale / l.clamp_min(1e-20)[:, None]
        else:
            partial[first + c] = (m, l, acc)
    for t, first, nch in plan.combined():
        if nch == 0:
            out[0, :, t] = 0.0
            continue
        parts = [partial[first + i] for i in range(nch)]  # chunk order
        M = torch.stack([m for m, _, _ in parts]).amax(dim=0)
        L = sum(l * torch.exp(m - M) for m, l, _ in parts)
        A = sum(acc * torch.exp(m - M)[:, None] for m, _, acc in parts)
        out[0, :, t] = A * v_scale / L.clamp_min(1e-20)[:, None]
    return out


@pytest.mark.parametrize("H,KV,scales", [(8, 2, (1.0, 1.0)), (4, 4, (0.5, 2.0))])
def test_split_and_combine_match_plain_and_jax(H, KV, scales):
    """A 74-token prefill chunk of slot 2 (its first tile direct, its last
    10 tokens split beside decode rows), decode tokens of slots 3 (a hole
    below it), 0, 4 (every block a hole: sees nothing) and 1, padding;
    128-key chunks (too few blocks for longer ones), so rows of 300
    positions take 3."""
    k_scale, v_scale = scales
    rng = np.random.default_rng(11)
    T, D, bs, NB, R = 96, 16, 16, 20, 5
    k = rng.standard_normal((64 * bs, KV, D)).astype(np.float32)
    v = rng.standard_normal((64 * bs, KV, D)).astype(np.float32)
    perm = rng.permutation(64)
    bt = np.full((R, NB), -1, np.int32)
    bt[2, :19], bt[3, :20], bt[0, :9], bt[1, :1] = perm[:19], perm[19:39], perm[39:48], perm[48:49]
    bt[3, 4] = -1  # a hole inside slot 3's range
    rid = np.full(T, -1, np.int32)
    qp = np.zeros(T, np.int32)
    rid[:74], qp[:74] = 2, np.arange(226, 300)
    rid[74:78], qp[74:78] = [3, 0, 4, 1], [310, 140, 60, 5]
    q = rng.standard_normal((1, H, T, D)).astype(np.float32)
    plan = rpa.ragged_plan(rid, qp, R, NB * bs, KV)
    assert plan.chunk == 128 and list(plan.direct_tiles()) == [0] and plan.n_slots > 0
    _check_plan(plan, rid, qp, R, NB * bs)
    qt, kt, vt = torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v)
    got = _emulate(qt, kt, vt, bt, rid, qp, plan, bs, None, k_scale, v_scale)
    assert not torch.isnan(got).any()
    assert torch.all(got[:, :, 76] == 0) and torch.all(got[:, :, 78:] == 0)
    plain = rpa.ragged_paged_attention_plain(qt, kt, vt, bt, rid, qp, block_size=bs,
                                             k_scale=k_scale, v_scale=v_scale)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=TOL, rtol=0)
    want = jax_ragged(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bt),
                      jnp.asarray(rid), jnp.asarray(qp), block_size=bs, block_q=8,
                      k_scale=k_scale, v_scale=v_scale)
    np.testing.assert_allclose(got.numpy()[:, :, :78], np.asarray(want)[:, :, :78], atol=TOL,
                               rtol=0)


def test_split_and_combine_match_plain_and_jax_beyond_64_rows():
    """96 rows: a 70-token prefill chunk of row 80 (its first tile direct,
    its tail split), then one decode token for each of 95 other rows at
    positions up to 47 (rows 7 and 93 see nothing: all holes), padding."""
    rng = np.random.default_rng(96)
    R, H, KV, D, bs, NB = 96, 4, 2, 16, 16, 6
    T = 176
    nblk = R * NB
    k = rng.standard_normal((nblk * bs, KV, D)).astype(np.float32)
    v = rng.standard_normal((nblk * bs, KV, D)).astype(np.float32)
    bt = rng.permutation(nblk).astype(np.int32).reshape(R, NB)
    bt[[7, 93]] = -1
    bt[40, 1] = -1  # a hole inside row 40's range
    rid = np.full(T, -1, np.int32)
    qp = np.zeros(T, np.int32)
    rid[:70], qp[:70] = 80, np.arange(20, 90)
    others = [r for r in rng.permutation(R).tolist() if r != 80]
    rid[70:165], qp[70:165] = others, rng.integers(0, 48, 95)
    q = rng.standard_normal((1, H, T, D)).astype(np.float32)
    plan = rpa.ragged_plan(rid, qp, R, NB * bs, KV)
    assert list(plan.direct_tiles()) == [0] and plan.n_slots == 0
    _check_plan(plan, rid, qp, R, NB * bs)
    qt, kt, vt = torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v)
    got = _emulate(qt, kt, vt, bt, rid, qp, plan, bs, None, 1.0, 1.0)
    assert not torch.isnan(got).any()
    blind = np.flatnonzero(np.isin(rid, [7, 93]))
    assert torch.all(got[:, :, blind] == 0) and torch.all(got[:, :, 165:] == 0)
    plain = rpa.ragged_paged_attention_plain(qt, kt, vt, bt, rid, qp, block_size=bs)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=TOL, rtol=0)
    want = jax_ragged(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bt),
                      jnp.asarray(rid), jnp.asarray(qp), block_size=bs, block_q=16)
    np.testing.assert_allclose(got.numpy()[:, :, :165], np.asarray(want)[:, :, :165], atol=TOL,
                               rtol=0)


def test_wrapper_takes_a_plan_on_the_cpu():
    """On CPU tensors the wrapper runs the plain version whatever plan it is
    handed (the plan only steers the card's launches)."""
    rng = np.random.default_rng(3)
    H, KV, T, D, bs = 4, 2, 8, 8, 8
    k = torch.from_numpy(rng.standard_normal((32, KV, D)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((1, H, T, D)).astype(np.float32))
    bt = np.array([[1, 0], [2, -1]], np.int32)
    rid = np.array([0, 0, 1, -1, -1, -1, -1, -1], np.int32)
    qp = np.array([3, 4, 9, 0, 0, 0, 0, 0], np.int32)
    plan = rpa.ragged_plan(rid, qp, 2, 16, KV)
    got = rpa.ragged_paged_attention(q, k, k, bt, rid, qp, block_size=bs, plan=plan)
    want = rpa.ragged_paged_attention_plain(q, k, k, bt, rid, qp, block_size=bs)
    assert torch.equal(got, want)


def _model_layout(B, S, H, D, dtype=torch.bfloat16):
    """(B, H, S, D) as the model hands it over: a transposed (B, S, H, D)."""
    return torch.zeros((B, S, H, D), dtype=dtype).transpose(1, 2)


@pytest.mark.parametrize("D", [64, 128])
def test_prefill_body_takes_wgmma_for_the_model_layouts(D):
    q, k = _model_layout(2, 100, 8, D), _model_layout(2, 100, 2, D)
    assert fa.prefill_body(q, k, k) == "wgmma"
    # contiguous (B, H, S, D) tensors too
    assert fa.prefill_body(q.contiguous(), k.contiguous(), k.contiguous()) == "wgmma"


def test_prefill_body_keeps_the_other_bodies():
    assert fa.prefill_body(*[_model_layout(1, 40, 4, 32)] * 3) == "mma"
    assert fa.prefill_body(*[_model_layout(1, 40, 4, 40)] * 3) == "simt"
    assert fa.prefill_body(*[_model_layout(1, 40, 4, 64, torch.float32)] * 3) == "simt"


def test_prefill_body_raises_on_misaligned_strides():
    # rows of 68 columns: 136-byte strides, not whole 16-byte units
    q = torch.zeros((1, 40, 4, 68), dtype=torch.bfloat16)[..., :64].transpose(1, 2)
    k = _model_layout(1, 40, 4, 64)
    with pytest.raises(ValueError, match="TMA"):
        fa.prefill_body(q, k, k)
    # a base 2 bytes off 16-byte alignment
    buf = torch.zeros(1 * 40 * 4 * 64 + 8, dtype=torch.bfloat16)
    q = buf[1:1 + 40 * 4 * 64].view(1, 40, 4, 64).transpose(1, 2)
    with pytest.raises(ValueError, match="TMA"):
        fa.prefill_body(q, k, k)
