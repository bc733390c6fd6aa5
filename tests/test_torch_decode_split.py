"""The decode kernel's kv split and the paged prefill's TMA body, checked
without a card.

- ``flash_attention.decode_chunk`` takes the chunk length from shapes only
  (B, KV, kv_len, the SM count). Every visible position of every row falls
  in exactly one (chunk, kv head, row) block, at B 1/8/64, KV 1/8 and kv_len
  16 ... 4096, a row that sees nothing included; the chunk is the largest
  that keeps two blocks per SM.
- A plain emulation of what the CUDA kernels do with that split (per block
  the f32 softmax state (m, l, acc) of its chunk's visible positions, an
  empty state for a chunk with none; the combine merging the chunks in
  order, folding in the fresh row (fused mode) and applying v_scale; one
  chunk writing its output directly) agrees with the plain versions and
  with the JAX package's Pallas kernels in interpret mode in all three
  modes: fused with window/chunk masks and offset starts, window, and
  paged at block 16 and 128 with a hole and k/v scales. Tolerance 1e-5
  (float32): only the order of the sums differs.
- ``flash_attention.paged_prefill_body`` picks the TMA body for the
  engine's bf16 layouts and block sizes, the others otherwise, and raises
  on strides TMA cannot take; ``paged_prefill_boxes`` lists each kv tile's
  live pool blocks as boxes covering its non-hole positions exactly once,
  at block 16 and 128.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nxdi_tpu.ops.kernels import flash_attention as jfa
from nxdi_tpu_torch.ops.attention import NEG_INF
from nxdi_tpu_torch.ops.kernels import flash_attention as fa
from test_torch_slice import fresh_jax_compiles

TOL = 1e-5
N_SM = 132  # an H100


@pytest.fixture(autouse=True, scope="module")
def _fresh_jax_compiles():
    # the Pallas references compile without a persistent cache an earlier
    # test on this worker left on (ROADMAP Queue 3)
    with fresh_jax_compiles():
        yield


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _blocks(lo, hi, kv_len, chunk):
    """Each block's positions, as decode_split_kernel cuts them: chunk c of
    row b covers [max(lo, c chunk), min(hi, (c + 1) chunk, kv_len))."""
    n = max(1, -(-kv_len // chunk))
    return [[(c, max(int(lo[b]), c * chunk), min(int(hi[b]), (c + 1) * chunk, kv_len))
             for c in range(n)] for b in range(len(lo))]


# ---------------------------------------------------------------------------
# the split plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv_len", [16, 100, 128, 129, 1000, 2048, 4096])
@pytest.mark.parametrize("KV", [1, 8])
@pytest.mark.parametrize("B", [1, 8, 64])
def test_decode_chunk_covers_every_visible_position_once(B, KV, kv_len):
    rng = np.random.default_rng(B * 10000 + KV * 100 + kv_len)
    chunk = fa.decode_chunk(B, KV, kv_len, N_SM)
    n = max(1, -(-kv_len // chunk))
    unit = fa.DECODE_CHUNK_UNIT
    assert chunk % unit == 0 and chunk >= unit and n * chunk >= kv_len
    whole = -(-kv_len // unit) * unit
    if chunk > unit:  # a longer chunk only while the launch keeps two blocks per SM
        assert B * KV * n >= 2 * N_SM or chunk == whole
    if chunk < whole:  # ... and the longest such
        assert B * KV * -(-kv_len // (chunk + unit)) < 2 * N_SM
    q_pos = rng.integers(0, kv_len + 3, B)
    q_pos[0] = 0  # fused: the slot at q_pos is stale, so nothing is visible
    kv_start = rng.integers(0, 4, B)
    kv_start[-1] = 2 ** 30  # a row whose first position is a hole's poison
    for fresh, window in ((True, None), (False, None), (False, 7)):
        lo, hi = fa.decode_visible_range(q_pos, kv_start, kv_len, fresh=fresh, window=window)
        if fresh:
            assert hi[0] == 0
        assert hi[-1] == 0
        for b, blocks in enumerate(_blocks(lo, hi, kv_len, chunk)):
            seen = np.zeros(kv_len, np.int64)
            for _, a, z in blocks:
                if z > a:
                    seen[a:z] += 1
            want = np.zeros(kv_len, np.int64)
            want[lo[b]:hi[b]] = 1
            assert np.array_equal(seen, want), (b, lo[b], hi[b], blocks)
            top = q_pos[b] - kv_start[b] + (0 if fresh else 1)
            assert hi[b] == max(0, min(kv_len, top))


def test_decode_chunk_at_the_slice_shapes():
    """Phase 3/3b's decode points (B 8, KV 8, 2048 positions): 384-position
    chunks, 6 a row, 384 blocks; the engine's largest batch at 64 rows fills
    the card with one block per (row, kv head): the earlier design."""
    assert fa.decode_chunk(8, 8, 2048, N_SM) == 384
    assert fa.decode_chunk(64, 8, 2048, N_SM) == 2048
    assert fa.decode_chunk(1, 8, 2048, N_SM) == 128


# ---------------------------------------------------------------------------
# split + combine, emulated, against the plain versions and Pallas
# ---------------------------------------------------------------------------


def _emulate(q, rows_of, lo, hi, kv_len, visible, scale, *, fresh=None, v_scale=1.0,
             n_chunks=None):
    """What decode_split_kernel and decode_combine_kernel compute, in f32.
    ``rows_of(b, kvh, j)``: K, V rows (n, D) of positions j and whether each
    is live; ``visible(b, j)``: the position masks. ``fresh``: (k_new,
    v_new) (B, KV, 1, D) for the fused mode."""
    B, H, _, D = q.shape
    KV = rows_of.kv_heads
    G = H // KV
    chunk = (fa.decode_chunk(B, KV, kv_len, N_SM) if n_chunks is None
             else -(-kv_len // n_chunks))
    out = torch.full((B, H, 1, D), float("nan"))
    for b, blocks in enumerate(_blocks(lo, hi, kv_len, chunk)):
        for kvh in range(KV):
            qg = q[b, kvh * G:(kvh + 1) * G, 0]  # (G, D)
            states = []
            for c, a, z in blocks:
                if z <= a:
                    states.append((torch.full((G,), NEG_INF), torch.zeros(G), torch.zeros(G, D)))
                    continue
                j = torch.arange(a, z)
                kk, vv, live = rows_of(b, kvh, j)
                vis = live & visible(b, j)
                s = (qg @ kk.T) * scale
                s = torch.where(vis, s, torch.full_like(s, NEG_INF))
                m = s.amax(dim=-1)
                p = torch.where(vis, torch.exp(s - m[:, None]), torch.zeros_like(s))
                states.append((m, p.sum(dim=-1), p @ vv))
            # the combine, in chunk order (one chunk: the block itself)
            M = torch.stack([m for m, _, _ in states]).amax(dim=0)
            L = sum(l * torch.exp(m - M) for m, l, _ in states)
            A = sum(acc * torch.exp(m - M)[:, None] for m, _, acc in states)
            if fresh is not None:
                kn, vn = fresh[0][b, kvh, 0], fresh[1][b, kvh, 0]
                s2 = (qg @ kn) * scale
                m_new = torch.maximum(M, s2)
                corr, p2 = torch.exp(M - m_new), torch.exp(s2 - m_new)
                L = L * corr + p2
                A = A * corr[:, None] + p2[:, None] * vn[None]
            out[b, kvh * G:(kvh + 1) * G, 0] = A * v_scale / L.clamp_min(1e-20)[:, None]
    return out


class _Contiguous:
    """K/V rows of a (B, KV, S, D) cache: position j is slot j."""

    def __init__(self, k, v):
        self.k, self.v, self.kv_heads = k, v, k.shape[1]

    def __call__(self, b, kvh, j):
        return self.k[b, kvh, j], self.v[b, kvh, j], torch.ones(len(j), dtype=torch.bool)


class _Paged:
    """K/V rows through a (B, NB) table over a (slots, KV, D) pool."""

    def __init__(self, k, v, bt, bs):
        self.k, self.v, self.bt, self.bs, self.kv_heads = k, v, bt, bs, k.shape[1]

    def __call__(self, b, kvh, j):
        blk = torch.from_numpy(self.bt[b])[j // self.bs].long()
        slot = (blk * self.bs + j % self.bs).clamp(min=0)
        return self.k[slot, kvh], self.v[slot, kvh], blk >= 0


def _mask(q_pos, kv_start, strict, window, chunk):
    def visible(b, j):
        kp, qp = kv_start[b] + j, int(q_pos[b])
        m = kp < qp if strict else kp <= qp
        if window:
            m = m & (kp > qp - window)
        if chunk:
            m = m & (torch.div(kp, chunk, rounding_mode="floor") == qp // chunk)
        return m
    return visible


@pytest.mark.parametrize("n_chunks", [None, 1])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("window,chunk", [(None, None), (40, None), (None, 96)])
def test_fused_split_matches_plain_and_pallas(window, chunk, G, n_chunks):
    """Rows at positions that end mid-chunk, at 0 (only the fresh row), past
    the cache window, and with offset starts (kv_len 300 of 320 slots)."""
    B, KV, S, D, W = 4, 2, 320, 16, 300
    q, kk, vv = _rand((B, KV * G, 1, D), 1), _rand((B, KV, S, D), 2), _rand((B, KV, S, D), 3)
    kn, vn = _rand((B, KV, 1, D), 4), _rand((B, KV, 1, D), 5)
    q_pos = np.array([[137], [0], [310], [205]], np.int32)
    kv_start = np.array([0, 0, 3, 11], np.int32)
    kv_pos = kv_start[:, None] + np.arange(S, dtype=np.int32)[None]
    args = (q, kk, vv, kn, vn, q_pos, kv_pos)
    ref = jfa.flash_attention_decode_fused(*(jnp.asarray(x) for x in args), sliding_window=window,
                                           chunk_size=chunk, block_k=20, kv_len=W)
    t = [torch.from_numpy(x) for x in args]
    plain = fa.flash_attention_decode_fused_plain(*t[:6], t[6][:, 0], sliding_window=window,
                                                  chunk_size=chunk, kv_len=W)
    assert fa.decode_chunk(B, KV, W, N_SM) == 128  # 3 chunks a row
    lo, hi = fa.decode_visible_range(q_pos, kv_start, W, fresh=True, window=window)
    got = _emulate(t[0], _Contiguous(t[1], t[2]), lo, hi, W,
                   _mask(q_pos[:, 0], torch.from_numpy(kv_start), True, window, chunk),
                   D ** -0.5, fresh=(t[3], t[4]), n_chunks=n_chunks)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=TOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL, rtol=0)


@pytest.mark.parametrize("n_chunks", [None, 1])
@pytest.mark.parametrize("window,chunk", [(None, None), (50, None), (None, 64)])
def test_window_split_matches_plain_and_pallas(window, chunk, n_chunks):
    """The window holds this step's row (inclusive mask); row 1 starts at a
    hole's poisoned position and sees nothing (exactly 0)."""
    B, KV, G, Sk, D = 3, 2, 4, 280, 16
    q, k, v = _rand((B, KV * G, 1, D), 6), _rand((B, KV, Sk, D), 7), _rand((B, KV, Sk, D), 8)
    q_pos = np.array([[279], [20], [150]], np.int32)
    kv_start = np.array([0, 2 ** 30, 5], np.int32)
    kv_pos = kv_start[:, None] + np.arange(Sk, dtype=np.int32)[None]
    args = (q, k, v, q_pos, kv_pos)
    ref = jfa.flash_attention_decode(*(jnp.asarray(x) for x in args), sliding_window=window,
                                     chunk_size=chunk, block_k=40)
    t = [torch.from_numpy(x) for x in args]
    plain = fa.flash_attention_decode_plain(*t, sliding_window=window, chunk_size=chunk)
    lo, hi = fa.decode_visible_range(q_pos, kv_start, Sk, fresh=False, window=window)
    got = _emulate(t[0], _Contiguous(t[1], t[2]), lo, hi, Sk,
                   _mask(q_pos[:, 0], torch.from_numpy(kv_start), False, window, chunk),
                   D ** -0.5, n_chunks=n_chunks)
    assert torch.equal(got[1], torch.zeros_like(got[1]))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=TOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL, rtol=0)


@pytest.mark.parametrize("n_chunks", [None, 1])
@pytest.mark.parametrize("bs", [16, 128])
def test_paged_split_matches_plain_and_pallas(bs, n_chunks):
    """384 positions a row (3 chunks of 128): a dense row, a hole inside a
    row's range, a row right-padded with holes and a row of holes only
    (output exactly 0); k/v scales."""
    KV, G, D = 2, 4, 16
    NB = 384 // bs
    rng = np.random.default_rng(bs)
    perm = rng.permutation(3 * NB).astype(np.int32)
    bt = np.stack([perm[:NB], perm[NB:2 * NB], perm[2 * NB:], np.full(NB, -1, np.int32)])
    bt[1, 130 // bs] = -1
    bt[2, 200 // bs + 1:] = -1
    kc, vc = _rand((3 * NB * bs, KV, D), 10), _rand((3 * NB * bs, KV, D), 11)
    q = _rand((4, KV * G, 1, D), 12)
    q_pos = np.array([[383], [300], [250], [100]], np.int32)
    scales = dict(k_scale=0.5, v_scale=2.0)
    args = (q, kc, vc, bt, q_pos)
    ref = jfa.paged_attention_decode(*(jnp.asarray(x) for x in args), block_size=bs, **scales)
    t = [torch.from_numpy(x) for x in args]
    plain = fa.paged_attention_decode_plain(*t, block_size=bs, **scales)
    lo, hi = fa.decode_visible_range(q_pos, None, NB * bs, fresh=False)
    got = _emulate(t[0], _Paged(t[1], t[2], bt, bs), lo, hi, NB * bs,
                   _mask(q_pos[:, 0], torch.zeros(4, dtype=torch.long), False, None, None),
                   D ** -0.5 * 0.5, v_scale=2.0, n_chunks=n_chunks)
    assert torch.equal(got[3], torch.zeros_like(got[3]))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=TOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL, rtol=0)


def test_decode_split_is_looked_up_per_call():
    """The wrappers take the split from ``decode_chunk`` at call time, so a
    caller can force one chunk a row (chip_smoke.py times the earlier design
    that way); on CPU tensors the plain version runs whatever it says."""
    q, k, v = (torch.from_numpy(_rand(s, i)) for i, s in
               enumerate([(2, 4, 1, 16), (2, 2, 40, 16), (2, 2, 40, 16)]))
    qp = torch.tensor([[39], [7]], dtype=torch.int32)
    kvp = torch.arange(40, dtype=torch.int32)[None].expand(2, 40)
    saved, before = fa.decode_chunk, fa.flash_attention_decode.launches
    try:
        fa.decode_chunk = lambda B, KV, kv_len, n_sm: 1 << 30
        got = fa.flash_attention_decode(q, k, v, qp, kvp)
    finally:
        fa.decode_chunk = saved
    assert torch.equal(got, fa.flash_attention_decode_plain(q, k, v, qp, kvp))
    assert fa.flash_attention_decode.launches == before  # CPU calls never count


# ---------------------------------------------------------------------------
# the paged prefill's TMA body
# ---------------------------------------------------------------------------


def _model_q(B, S, H, D, dtype=torch.bfloat16):
    return torch.zeros((B, S, H, D), dtype=dtype).transpose(1, 2)


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("bs", [8, 16, 32, 64, 128, 256])
def test_paged_prefill_body_takes_wgmma_for_the_engine_layouts(D, bs):
    q = _model_q(1, 512, 32, D)
    pool = torch.zeros((16 * bs, 8, D), dtype=torch.bfloat16)
    assert fa.paged_wgmma_block(bs)
    assert fa.paged_prefill_body(q, pool, pool, bs) == "wgmma"


def test_paged_prefill_body_keeps_the_other_bodies():
    pool = torch.zeros((96, 2, 64), dtype=torch.bfloat16)
    q = _model_q(1, 40, 4, 64)
    for bs in (4, 24, 48, 96):  # not whole boxes of a 1 KB swizzle atom per 128-row tile
        assert not fa.paged_wgmma_block(bs)
        assert fa.paged_prefill_body(q, pool, pool, bs) == "mma"
    pool32 = torch.zeros((96, 2, 32), dtype=torch.bfloat16)
    assert fa.paged_prefill_body(_model_q(1, 40, 4, 32), pool32, pool32, 16) == "mma"
    pool40 = torch.zeros((96, 2, 40), dtype=torch.bfloat16)
    assert fa.paged_prefill_body(_model_q(1, 40, 4, 40), pool40, pool40, 16) == "simt"
    f32 = torch.zeros((96, 2, 64))
    assert fa.paged_prefill_body(_model_q(1, 40, 4, 64, torch.float32), f32, f32, 16) == "simt"


def test_paged_prefill_body_raises_on_misaligned_strides():
    pool = torch.zeros((128, 2, 64), dtype=torch.bfloat16)
    q = torch.zeros((1, 40, 4, 68), dtype=torch.bfloat16)[..., :64].transpose(1, 2)
    with pytest.raises(ValueError, match="TMA"):
        fa.paged_prefill_body(q, pool, pool, 16)
    buf = torch.zeros(128 * 2 * 64 + 8, dtype=torch.bfloat16)
    pool_off = buf[1:1 + 128 * 2 * 64].view(128, 2, 64)
    with pytest.raises(ValueError, match="TMA"):
        fa.paged_prefill_body(_model_q(1, 40, 4, 64), pool_off, pool_off, 16)


@pytest.mark.parametrize("bs", [16, 128])
def test_paged_prefill_boxes_cover_live_positions_once(bs):
    """Every kv tile's boxes map each non-hole position of the tile to its
    table slot exactly once; holes, positions past the table and tiles of
    holes only get no box."""
    NB = 1024 // bs
    rng = np.random.default_rng(bs + 1)
    row = rng.permutation(NB + 4).astype(np.int32)[:NB]
    row[3 * 128 // bs] = -1           # a hole (at bs 128: all of tile 3)
    row[5 * 128 // bs:6 * 128 // bs] = -1  # tile 5: holes only
    width = NB * bs
    for kt in range(-(-width // fa.PAGED_TILE) + 1):  # one tile past the table too
        boxes = fa.paged_prefill_boxes(row, kt, bs)
        seen = {}
        for r0, slot, rows in boxes:
            assert rows == min(bs, fa.PAGED_TILE) and r0 % rows == 0
            for i in range(rows):
                j = kt * fa.PAGED_TILE + r0 + i
                assert j not in seen
                seen[j] = slot + i
        for j in range(kt * fa.PAGED_TILE, (kt + 1) * fa.PAGED_TILE):
            live = j < width and row[j // bs] >= 0
            if live:
                assert seen.get(j) == row[j // bs] * bs + j % bs
            else:
                assert j not in seen
        if kt == 5 or kt >= -(-width // fa.PAGED_TILE):
            assert boxes == []
