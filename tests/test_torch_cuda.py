"""The port's CUDA kernels on the card, held against their plain versions.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU. The card's
machine has no JAX, so run them there without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider -o markers=cuda -m cuda \
        tests/test_torch_cuda.py -q
"""

import dataclasses
import re

import numpy as np
import pytest
import torch

from nxdi_tpu_torch.ops.kernels import flash_attention as fa
from nxdi_tpu_torch.ops.kernels import fused_proj as fp
from nxdi_tpu_torch.ops.kernels import kv_commit as kc
from nxdi_tpu_torch.ops.kernels import ragged_paged_attention as rpa

pytestmark = pytest.mark.cuda

TOL = 1e-5  # float32


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, *shape):
    return torch.randn(shape, generator=gen, device="cuda")


def test_prefill_takes_positions_from_the_host(gen):
    """Position tensors on the CPU with operands on the card: the wrapper
    moves the starts to the card, launches once, and matches the plain
    version."""
    B, H, KV, S, D = 2, 4, 2, 40, 16
    q, k, v = _randn(gen, B, H, S, D), _randn(gen, B, KV, S, D), _randn(gen, B, KV, S, D)
    pos = torch.arange(S, dtype=torch.int32)[None] + torch.tensor([[0], [9]], dtype=torch.int32)
    before = fa.flash_attention_prefill.launches
    got = fa.flash_attention_prefill(q, k, v, pos, pos)
    assert fa.flash_attention_prefill.launches == before + 1
    want = fa.flash_attention_prefill_plain(q, k, v, pos.cuda(), pos.cuda())
    assert (got - want).abs().max().item() <= TOL


def test_fused_decode_takes_positions_from_the_host(gen):
    B, H, KV, S, D = 2, 8, 2, 64, 16
    q, kn, vn = _randn(gen, B, H, 1, D), _randn(gen, B, KV, 1, D), _randn(gen, B, KV, 1, D)
    kc_, vc_ = _randn(gen, B, KV, S, D), _randn(gen, B, KV, S, D)
    q_pos = torch.tensor([[17], [0]], dtype=torch.int32)
    kv_pos = torch.arange(S, dtype=torch.int32)[None].expand(B, S)
    before = fa.flash_attention_decode_fused.launches
    got = fa.flash_attention_decode_fused(q, kc_, vc_, kn, vn, q_pos, kv_pos, kv_len=48)
    assert fa.flash_attention_decode_fused.launches == before + 1
    want = fa.flash_attention_decode_fused_plain(q, kc_, vc_, kn, vn, q_pos.cuda(), kv_len=48)
    assert (got - want).abs().max().item() <= TOL


def test_fused_decode_takes_fresh_rows_of_other_strides(gen):
    """k_new contiguous and v_new a strided view (a fused QKV projection's
    output, as the model hands them under fused_qkv): every row reads its
    own fresh V row."""
    B, H, KV, S, D = 3, 8, 2, 64, 16
    q = _randn(gen, B, H, 1, D)
    kc_, vc_ = _randn(gen, B, KV, S, D), _randn(gen, B, KV, S, D)
    qkv = _randn(gen, B, 1, (H + 2 * KV) * D)
    kn = qkv[..., H * D:(H + KV) * D].reshape(B, 1, KV, D).transpose(1, 2).contiguous()
    vn = qkv[..., (H + KV) * D:].reshape(B, 1, KV, D).transpose(1, 2)
    assert kn.stride() != vn.stride()
    q_pos = torch.tensor([[17], [40], [5]], dtype=torch.int32, device="cuda")
    kv_pos = torch.arange(S, dtype=torch.int32, device="cuda")[None].expand(B, S)
    got = fa.flash_attention_decode_fused(q, kc_, vc_, kn, vn, q_pos, kv_pos)
    want = fa.flash_attention_decode_fused_plain(q, kc_, vc_, kn, vn, q_pos)
    assert (got - want).abs().max().item() <= TOL


def test_commit_takes_slots_from_the_host(gen):
    L, B, KV, S, D = 3, 4, 2, 32, 16
    k_cache, v_cache = _randn(gen, L, B, KV, S, D), _randn(gen, L, B, KV, S, D)
    k_rows, v_rows = _randn(gen, L, B, KV, 1, D), _randn(gen, L, B, KV, 1, D)
    slots = torch.tensor([[3], [-1], [31], [0]], dtype=torch.int32)
    k_ref, v_ref = k_cache.clone(), v_cache.clone()
    kc.kv_commit_rows_plain(k_ref, v_ref, k_rows, v_rows, slots.cuda())
    before = kc.kv_commit_rows.launches
    kc.kv_commit_rows(k_cache, v_cache, k_rows, v_rows, slots)
    assert kc.kv_commit_rows.launches == before + 1
    assert torch.equal(k_cache, k_ref) and torch.equal(v_cache, v_ref)


def test_window_decode_takes_positions_from_the_host(gen):
    B, H, KV, S, D = 2, 8, 2, 64, 16
    q, k, v = _randn(gen, B, H, 1, D), _randn(gen, B, KV, S, D), _randn(gen, B, KV, S, D)
    q_pos = torch.tensor([[17], [63]], dtype=torch.int32)
    kv_pos = torch.arange(S, dtype=torch.int32)[None].expand(B, S)
    before = fa.flash_attention_decode.launches
    got = fa.flash_attention_decode(q, k, v, q_pos, kv_pos)
    assert fa.flash_attention_decode.launches == before + 1
    want = fa.flash_attention_decode_plain(q, k, v, q_pos.cuda(), kv_pos.cuda())
    assert (got - want).abs().max().item() <= TOL


def _paged_case(gen, Sq):
    """A 12-block pool of 8 slots and host-side int32 tables with a hole
    and a right-padded row."""
    B, H, KV, D, bs = 2, 8, 2, 16, 8
    kc, vc = _randn(gen, 12 * bs, KV, D), _randn(gen, 12 * bs, KV, D)
    bt = torch.tensor([[3, 7, -1, 1, 0, 5], [11, 2, 9, -1, -1, -1]], dtype=torch.int32)
    start = torch.tensor([[30], [10]], dtype=torch.int32)
    q_pos = start + torch.arange(Sq, dtype=torch.int32)[None]
    return _randn(gen, B, H, Sq, D), kc, vc, bt, q_pos, bs


def test_paged_decode_takes_tables_from_the_host(gen):
    q, kc, vc, bt, q_pos, bs = _paged_case(gen, 1)
    before = fa.paged_attention_decode.launches
    got = fa.paged_attention_decode(q, kc, vc, bt, q_pos, block_size=bs, k_scale=0.5, v_scale=2.0)
    assert fa.paged_attention_decode.launches == before + 1
    want = fa.paged_attention_decode_plain(q, kc, vc, bt.cuda(), q_pos.cuda(), block_size=bs,
                                           k_scale=0.5, v_scale=2.0)
    assert (got - want).abs().max().item() <= TOL


def test_paged_prefill_takes_tables_from_the_host(gen):
    q, kc, vc, bt, q_pos, bs = _paged_case(gen, 12)
    before = fa.paged_attention_prefill.launches
    got = fa.paged_attention_prefill(q, kc, vc, bt, q_pos, block_size=bs, k_scale=1.5,
                                     v_scale=0.25)
    assert fa.paged_attention_prefill.launches == before + 1
    want = fa.paged_attention_prefill_plain(q, kc, vc, bt.cuda(), q_pos.cuda(), block_size=bs,
                                            k_scale=1.5, v_scale=0.25)
    assert (got - want).abs().max().item() <= TOL


@pytest.mark.parametrize("dtype,tol", [(torch.float32, TOL), (torch.bfloat16, 2e-2)])
def test_ragged_takes_tags_and_tables_from_the_host(gen, dtype, tol):
    """int32 numpy tags and tables with operands on the card: a prefill chunk
    of slot 2, then decode tokens of slots 0 and 3 (a hole before one), a
    row whose blocks are all holes, and padding, which must be exactly 0."""
    H, KV, D, bs, T = 8, 2, 64, 16, 40
    kc_, vc_ = _randn(gen, 16 * bs, KV, D).to(dtype), _randn(gen, 16 * bs, KV, D).to(dtype)
    bt = np.array([[5, 1, -1, -1], [-1, -1, -1, -1], [3, 7, 0, -1], [2, -1, 9, -1]], np.int32)
    rid = np.full(T, -1, np.int32)
    qp = np.zeros(T, np.int32)
    rid[:20], qp[:20] = 2, np.arange(14, 34)
    rid[20:23], qp[20:23] = [0, 3, 1], [20, 40, 5]
    q = _randn(gen, 1, T, H, D).to(dtype).transpose(1, 2)
    before = rpa.ragged_paged_attention.launches
    got = rpa.ragged_paged_attention(q, kc_, vc_, bt, rid, qp, block_size=bs, k_scale=0.5,
                                     v_scale=2.0)
    assert rpa.ragged_paged_attention.launches == before + 1
    want = rpa.ragged_paged_attention_plain(q, kc_, vc_, bt, rid, qp, block_size=bs,
                                            k_scale=0.5, v_scale=2.0)
    assert (got.float() - want.float()).abs().max().item() <= tol
    assert torch.all(got[:, :, 22:] == 0)  # slot 1 sees nothing; the tail is padding


def test_ragged_raises_on_too_many_rows(gen):
    """96 rows run on the split path (its direct tiles hold one row each)
    and match the plain version: a 130-token chunk of row 80, then one
    decode token of each other row; the one-kernel design
    (``ragged_plan(split=False)``, a 64-bit row mask per tile) still raises
    above 64 rows."""
    R, T, H, KV, D, bs, NB = 96, 256, 32, 8, 64, 128, 4
    rows = [(80, 200, 130)] + [(r, 5 + 4 * r, 1) for r in range(R) if r != 80]
    bt, rid, qp = _ragged_stream(rows, T, R, NB, bs, gen)
    kc_, vc_ = (_randn(gen, R * NB * bs, KV, D).to(torch.bfloat16) for _ in range(2))
    q = _randn(gen, 1, T, H, D).to(torch.bfloat16).transpose(1, 2)
    plan = rpa.ragged_plan(rid, qp, R, NB * bs, KV)
    assert plan.split and plan.n_direct > 0 and plan.n_items > 0
    got = rpa.ragged_paged_attention(q, kc_, vc_, bt, rid, qp, block_size=bs, plan=plan)
    want = rpa.ragged_paged_attention_plain(q, kc_, vc_, bt, rid, qp, block_size=bs)
    assert _max_err(got, want) <= 2e-2
    assert torch.all(got[:, :, torch.from_numpy(rid < 0).cuda()] == 0)
    assert torch.equal(rpa.ragged_paged_attention(q, kc_, vc_, bt, rid, qp, block_size=bs,
                                                  plan=plan), got)
    with pytest.raises(ValueError, match="rows"):
        rpa.ragged_plan(rid, qp, R, NB * bs, KV, split=False)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, TOL), (torch.bfloat16, 2e-2)])
def test_qkv_and_mlp_kernels(gen, dtype, tol):
    """Both entries of each kernel at a ragged M, the stacked ones at a
    middle layer, against the plain versions; every activation."""
    M, H, T, I, L = 37, 64, 96, 128, 3
    x = _randn(gen, M, H).to(dtype)
    w = (_randn(gen, L, H, T) * 0.1).to(dtype)
    b = (_randn(gen, L, T) * 0.1).to(dtype)
    before = fp.qkv_matmul.launches
    got = fp.qkv_matmul_stacked(x, w, 1, b)
    assert fp.qkv_matmul.launches == before + 1
    assert (got.float() - fp.qkv_matmul_plain(x, w[1], b[1]).float()).abs().max() <= tol
    g, u = (_randn(gen, L, H, I) * 0.1).to(dtype), (_randn(gen, L, H, I) * 0.1).to(dtype)
    d = (_randn(gen, L, I, H) * 0.1).to(dtype)
    for act in fp.KERNEL_ACTS:
        before = fp.fused_mlp.launches
        got = fp.fused_mlp_stacked(x, g, u, d, 2, act=act)
        assert fp.fused_mlp.launches == before + 1
        want = fp.fused_mlp_plain(x, g[2], u[2], d[2], act)
        assert (got.float() - want.float()).abs().max() <= tol, act
    assert torch.equal(fp.fused_mlp(x, g[0], u[0], d[0]), fp.fused_mlp_stacked(x, g, u, d, 0))


def test_projection_kernels_raise_on_ineligible_shapes(gen):
    x = _randn(gen, 4, 12)
    with pytest.raises(ValueError, match="multiples of 8"):
        fp.qkv_matmul(x, _randn(gen, 12, 20))
    with pytest.raises(ValueError, match="multiples of 8"):
        fp.fused_mlp(_randn(gen, 4, 16), _randn(gen, 16, 12), _randn(gen, 16, 12),
                     _randn(gen, 12, 16))


# the rows the GEMM bodies must take: around the stream/wgmma switch (64/65),
# the 16/32/64 row tiles and the 128-row wgmma tile, and the mixed engine's
# packed steps (520 = a 512-token chunk + 8 decode rows; the 1032 bucket)
GEMM_MS = [1, 2, 7, 8, 16, 63, 64, 65, 127, 128, 129, 520, 1032]
GEMM_TOL = 5e-2  # bf16: one output ulp at 2-4 (the outputs here reach ~4), as chip_smoke.py


def _bf(gen, scale, *shape):
    return (_randn(gen, *shape) * scale).to(torch.bfloat16)


def _max_err(a, b):
    return (a.float() - b.float()).abs().max().item()


@pytest.mark.parametrize("M", GEMM_MS)
def test_gemm_bodies_at_llama_widths(gen, M):
    """QKV (2048 -> 3072) and the silu MLP (2048 -> 8192 -> 2048) in bf16
    at M, through the body gemm_plan picks, the stacked entries at a middle
    layer: against the plain versions, and bitwise-equal on a second call
    (the split-K reduction is ordered, no atomics)."""
    L, li, H, T, I = 3, 1, 2048, 3072, 8192
    x = _bf(gen, 1.0, M, H)
    w = _bf(gen, 0.02, L, H, T)
    got = fp.qkv_matmul_stacked(x, w, li)
    assert _max_err(got, fp.qkv_matmul_plain(x, w[li])) <= GEMM_TOL
    assert torch.equal(fp.qkv_matmul_stacked(x, w, li), got)
    assert torch.equal(fp.qkv_matmul(x, w[li]), got)
    del w
    g, u, d = _bf(gen, 0.02, L, H, I), _bf(gen, 0.02, L, H, I), _bf(gen, 0.02, L, I, H)
    before = fp.fused_mlp.launches
    got = fp.fused_mlp_stacked(x, g, u, d, li)
    assert fp.fused_mlp.launches == before + 1
    assert _max_err(got, fp.fused_mlp_plain(x, g[li], u[li], d[li])) <= GEMM_TOL
    assert torch.equal(fp.fused_mlp_stacked(x, g, u, d, li), got)
    assert torch.equal(fp.fused_mlp(x, g[li], u[li], d[li]), got)


@pytest.mark.parametrize("K,N", [(72, 40), (200, 136)])
@pytest.mark.parametrize("M", GEMM_MS)
def test_gemm_bodies_at_ragged_widths(gen, M, K, N):
    """Widths that are multiples of 8 but of no tile (boxes and tiles past
    the edges), every activation, the stacked entries at a middle layer."""
    L, li = 3, 1
    sk, sn = K ** -0.5, N ** -0.5  # outputs of about unit scale
    x = _bf(gen, 1.0, M, K)
    w = _bf(gen, sk, L, K, N)
    got = fp.qkv_matmul_stacked(x, w, li)
    assert _max_err(got, fp.qkv_matmul_plain(x, w[li])) <= GEMM_TOL
    assert torch.equal(fp.qkv_matmul_stacked(x, w, li), got)
    g, u, d = _bf(gen, sk, L, K, N), _bf(gen, sk, L, K, N), _bf(gen, sn, L, N, K)
    for act in fp.KERNEL_ACTS:
        got = fp.fused_mlp_stacked(x, g, u, d, li, act=act)
        assert _max_err(got, fp.fused_mlp_plain(x, g[li], u[li], d[li], act)) <= GEMM_TOL, act
        assert torch.equal(fp.fused_mlp_stacked(x, g, u, d, li, act=act), got), act


@pytest.mark.parametrize("forced", [("stream", 64, 128), ("wgmma", 128, 128),
                                    ("wgmma", 128, 256)])
@pytest.mark.parametrize("M", [2, 65, 520])
def test_gemm_forced_plans(gen, monkeypatch, M, forced):
    """Every body and wgmma tile width the kernels take (what
    scripts/bench_gemm_plans.py measures: the default plan with the body and
    tiles replaced, its K split kept), against the plain versions."""
    body, bm, width = forced
    default = fp._plan

    def plan(M_, N_, K_, dual, x):
        bn = width // (2 if dual else 1)  # the dual pair's output tiles are half the B tile
        return dataclasses.replace(default(M_, N_, K_, dual, x), body=body, bm=bm, bn=bn,
                                   m_tiles=-(-M_ // bm), n_tiles=-(-N_ // bn))

    monkeypatch.setattr(fp, "_plan", plan)
    H, T, I = 512, 512, 1024
    x, w = _bf(gen, 1.0, M, H), _bf(gen, H ** -0.5, H, T)
    got = fp.qkv_matmul(x, w)
    assert _max_err(got, fp.qkv_matmul_plain(x, w)) <= GEMM_TOL
    assert torch.equal(fp.qkv_matmul(x, w), got)
    g, u, d = _bf(gen, H ** -0.5, H, I), _bf(gen, H ** -0.5, H, I), _bf(gen, I ** -0.5, I, H)
    got = fp.fused_mlp(x, g, u, d)
    assert _max_err(got, fp.fused_mlp_plain(x, g, u, d)) <= GEMM_TOL
    assert torch.equal(fp.fused_mlp(x, g, u, d), got)


# the TMA + wgmma prefill body: bf16 within chip_smoke.py's prefill
# tolerance (one output ulp near 0.5 and the P rounding)
PREFILL_BF16_TOL = 8e-3


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("case", ["ragged_edges", "offset_starts", "window", "chunk", "padded"])
def test_wgmma_prefill_body(gen, D, case):
    """The TMA + wgmma body against the plain version in the model's
    layout: Sq and Sk not multiples of 128, Sk longer than Sq with offset
    starts, sliding-window and chunk masks, right-padded rows; a second call
    gives the same bits."""
    B, H, KV = 2, 8, 2
    Sq, Sk, win, chk = {"ragged_edges": (300, 300, None, None),
                        "offset_starts": (200, 333, None, None),
                        "window": (260, 260, 100, None),
                        "chunk": (260, 260, None, 96),
                        "padded": (256, 256, None, None)}[case]

    def bf(*shape):
        return _randn(gen, *shape).to(torch.bfloat16)

    q = bf(B, Sq, H, D).transpose(1, 2)
    k, v = bf(B, Sk, KV, D).transpose(1, 2), bf(B, Sk, KV, D).transpose(1, 2)
    if case == "offset_starts":  # the chunk's queries sit after Sk - Sq cached keys
        q_pos = (Sk - Sq + torch.arange(Sq, dtype=torch.int32))[None].expand(B, Sq) + \
            torch.tensor([[0], [5]], dtype=torch.int32)
        kv_pos = torch.arange(Sk, dtype=torch.int32)[None].expand(B, Sk) + \
            torch.tensor([[0], [5]], dtype=torch.int32)
    else:  # every row runs 0.. (a right-padded batch's pad lanes included) or starts at 37
        q_pos = torch.arange(Sq, dtype=torch.int32)[None].expand(B, Sq) + \
            torch.tensor([[0], [0 if case == "padded" else 37]], dtype=torch.int32)
        kv_pos = q_pos
    q_pos, kv_pos = q_pos.cuda(), kv_pos.cuda()
    assert fa.prefill_body(q, k, v) == "wgmma"
    got = fa.flash_attention_prefill(q, k, v, q_pos, kv_pos, sliding_window=win, chunk_size=chk)
    want = fa.flash_attention_prefill_plain(q, k, v, q_pos, kv_pos, sliding_window=win,
                                            chunk_size=chk)
    assert _max_err(got, want) <= PREFILL_BF16_TOL
    assert torch.equal(fa.flash_attention_prefill(q, k, v, q_pos, kv_pos, sliding_window=win,
                                                  chunk_size=chk), got)


def _ragged_stream(rows, T, R, NB, bs, gen):
    """rows: (slot, first position, tokens) in packing order; each slot's
    blocks drawn from a permutation of a pool of R * NB blocks; the rest of
    the T tokens padding."""
    perm = torch.randperm(R * NB, generator=torch.Generator().manual_seed(7)).tolist()
    bt = np.full((R, NB), -1, np.int32)
    rid = np.full(T, -1, np.int32)
    qp = np.zeros(T, np.int32)
    t, nxt = 0, 0
    for slot, start, n in rows:
        rid[t:t + n], qp[t:t + n] = slot, np.arange(start, start + n)
        t += n
        nb = (start + n - 1) // bs + 1
        bt[slot, :nb] = perm[nxt:nxt + nb]
        nxt += nb
    return bt, rid, qp


RAGGED_STREAMS = {
    # decode-only at buckets 2, 8 and 64: one token per slot
    "decode2": (2, [(1, 700, 1), (0, 95, 1)]),
    "decode8": (8, [(s, 230 + 110 * s, 1) for s in range(8)]),
    "decode64": (64, [(s, 40 + 31 * s, 1) for s in (list(range(63, 30, -1)) + list(range(31)))]),
    # a prefill chunk's tiles beside a long decode row and a short one
    "chunk_and_long_decode": (160, [(2, 100, 130), (0, 1900, 1), (1, 7, 1)]),
}


@pytest.mark.parametrize("dtype,tol", [(torch.float32, TOL), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("stream", list(RAGGED_STREAMS))
def test_ragged_split_path(gen, stream, dtype, tol):
    """The split kernel and the combine (with direct tiles where a tile
    holds one row) against the plain version at block 128; the same bits on
    a second call; padding exactly 0."""
    T, rows = RAGGED_STREAMS[stream]
    H, KV, D, bs, NB = 32, 8, 64, 128, 16
    R = max(s for s, _, _ in rows) + 1
    bt, rid, qp = _ragged_stream(rows, T, R, NB, bs, gen)
    kc_, vc_ = (_randn(gen, R * NB * bs, KV, D).to(dtype) for _ in range(2))
    q = _randn(gen, 1, T, H, D).to(dtype).transpose(1, 2)
    plan = rpa.ragged_plan(rid, qp, R, NB * bs, KV)
    assert plan.n_items > 0
    got = rpa.ragged_paged_attention(q, kc_, vc_, bt, rid, qp, block_size=bs, plan=plan)
    want = rpa.ragged_paged_attention_plain(q, kc_, vc_, bt, rid, qp, block_size=bs)
    assert _max_err(got, want) <= tol
    assert torch.all(got[:, :, torch.from_numpy(rid < 0).cuda()] == 0)
    assert torch.equal(rpa.ragged_paged_attention(q, kc_, vc_, bt, rid, qp, block_size=bs,
                                                  plan=plan), got)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, TOL), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("stream", ["decode8", "chunk_and_long_decode"])
def test_ragged_at_group_71(gen, stream, dtype, tol):
    """Row 8 at Falcon-7B's group (71 query heads of 64 on one kv head),
    which its split items take 16 heads a pass: against the plain version,
    padding exactly 0."""
    T, rows = RAGGED_STREAMS[stream]
    H, KV, D, bs, NB = 71, 1, 64, 128, 16
    R = max(s for s, _, _ in rows) + 1
    bt, rid, qp = _ragged_stream(rows, T, R, NB, bs, gen)
    kc_, vc_ = (_randn(gen, R * NB * bs, KV, D).to(dtype) for _ in range(2))
    q = _randn(gen, 1, T, H, D).to(dtype).transpose(1, 2)
    plan = rpa.ragged_plan(rid, qp, R, NB * bs, KV)
    got = rpa.ragged_paged_attention(q, kc_, vc_, bt, rid, qp, block_size=bs, plan=plan)
    want = rpa.ragged_paged_attention_plain(q, kc_, vc_, bt, rid, qp, block_size=bs)
    assert _max_err(got, want) <= tol
    assert torch.all(got[:, :, torch.from_numpy(rid < 0).cuda()] == 0)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, TOL), (torch.bfloat16, 2e-2)])
def test_ragged_split_path_block16_holes_and_scales(gen, dtype, tol):
    """Block 16: holes inside two rows' ranges, a row whose blocks are all
    holes (its token writes 0), k/v scales, a multi-token run of a row in a
    shared tile; 128-key chunks, so rows take several."""
    T, R, NB, bs, H, KV, D = 48, 5, 64, 16, 8, 2, 64
    bt, rid, qp = _ragged_stream([(4, 300, 20), (3, 900, 1), (0, 511, 1), (1, 3, 1),
                                  (2, 60, 1)], T, R, NB, bs, gen)
    bt[3, 10] = bt[4, 2] = -1
    bt[2, :] = -1
    kc_, vc_ = (_randn(gen, R * NB * bs, KV, D).to(dtype) for _ in range(2))
    q = _randn(gen, 1, T, H, D).to(dtype).transpose(1, 2)
    plan = rpa.ragged_plan(rid, qp, R, NB * bs, KV)
    assert plan.chunk == 128 and plan.n_slots > 0 and plan.n_direct == 0
    kw = dict(block_size=bs, k_scale=0.5, v_scale=2.0)
    got = rpa.ragged_paged_attention(q, kc_, vc_, bt, rid, qp, plan=plan, **kw)
    want = rpa.ragged_paged_attention_plain(q, kc_, vc_, bt, rid, qp, **kw)
    assert _max_err(got, want) <= tol
    assert torch.all(got[:, :, 23] == 0) and torch.all(got[:, :, 24:] == 0)
    assert torch.equal(rpa.ragged_paged_attention(q, kc_, vc_, bt, rid, qp, plan=plan, **kw), got)


# ---------------------------------------------------------------------------
# the decode kernel split across blocks (all three modes) and the paged
# prefill's TMA body
# ---------------------------------------------------------------------------


def _one_chunk(B, KV, kv_len, n_sm):
    return 1 << 30  # one chunk a row: the earlier design


def _decode_call(mode, gen, dtype, G, D, mask=None):
    """One decode call per mode over 700 positions (6 chunks of 128 at B 4,
    KV 2): rows at the end, at the start (fused: only the fresh row; window:
    a hole's poisoned start; paged: a table of holes only, so no visible
    key), in the middle with an offset start or a hole; returns (kernel
    call, plain call)."""
    B, KV, S, kv_len = 4, 2, 704, 700
    H = KV * G
    window, chunk = {None: (None, None), "window": (200, None), "chunk": (None, 256)}[mask]

    def r(*shape):
        return _randn(gen, *shape).to(dtype)

    q = r(B, 1, H, D).transpose(1, 2)  # the model's head-split layout
    if mode == "paged":
        bs, NB = 16, 44
        perm = torch.randperm(4 * NB, generator=torch.Generator().manual_seed(3))
        bt = perm.reshape(4, NB).to(torch.int32)
        bt[1] = -1
        bt[2, 9] = -1
        kc_, vc_ = r(4 * NB * bs, KV, D), r(4 * NB * bs, KV, D)
        qp = torch.tensor([[699], [300], [400], [17]], dtype=torch.int32)
        kw = dict(block_size=bs, k_scale=0.5, v_scale=2.0)
        return (lambda: fa.paged_attention_decode(q, kc_, vc_, bt, qp, **kw),
                lambda: fa.paged_attention_decode_plain(q, kc_, vc_, bt.cuda(), qp.cuda(), **kw))
    starts = torch.tensor([0, 2 ** 30 if mode == "window" else 0, 9, 3], dtype=torch.int32)
    kv_pos = (starts[:, None] + torch.arange(S, dtype=torch.int32)[None]).cuda()
    k, v = r(B, S, KV, D).transpose(1, 2), r(B, S, KV, D).transpose(1, 2)
    masks = dict(sliding_window=window, chunk_size=chunk)
    if mode == "window":
        qp = torch.tensor([[699], [20], [500], [130]], dtype=torch.int32).cuda()
        return (lambda: fa.flash_attention_decode(q, k[:, :, :kv_len], v[:, :, :kv_len], qp,
                                                  kv_pos[:, :kv_len], **masks),
                lambda: fa.flash_attention_decode_plain(q, k[:, :, :kv_len], v[:, :, :kv_len],
                                                        qp, kv_pos[:, :kv_len], **masks))
    kn, vn = r(B, 1, KV, D).transpose(1, 2), r(B, 1, KV, D).transpose(1, 2)
    qp = torch.tensor([[703], [0], [500], [130]], dtype=torch.int32).cuda()
    return (lambda: fa.flash_attention_decode_fused(q, k, v, kn, vn, qp, kv_pos, kv_len=kv_len,
                                                    **masks),
            lambda: fa.flash_attention_decode_fused_plain(q, k, v, kn, vn, qp, kv_pos[:, 0],
                                                          kv_len=kv_len, **masks))


DECODE_LAUNCHES = {"fused": "flash_attention_decode_fused", "window": "flash_attention_decode",
                   "paged": "paged_attention_decode"}


@pytest.mark.parametrize("dtype,tol", [(torch.float32, TOL), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("D", [32, 40, 64, 128])
@pytest.mark.parametrize("G", [1, 4, 16, 24, 71])
@pytest.mark.parametrize("mode", ["fused", "window", "paged"])
def test_decode_split(gen, monkeypatch, mode, G, D, dtype, tol):
    """The split kernel and the combine against the plain version, one
    launch counted per call, the same bits on a second call, and one chunk
    a row (the earlier design) against the same plain version. bf16 at D
    32, 64 and 128 runs the tensor-core tile, D 40 (not a multiple of 16)
    and f32 the CUDA-core tile; G 24 and 71 (Falcon-7B's group) run in head
    tiles of 16, the last one partial."""
    call, plain = _decode_call(mode, gen, dtype, G, D)
    counter = getattr(fa, DECODE_LAUNCHES[mode])
    assert -(-700 // fa.decode_chunk(4, 2, 704 if mode == "paged" else 700, 132)) > 1
    before = counter.launches
    got = call()
    assert counter.launches == before + 1
    want = plain()
    assert _max_err(got, want) <= tol
    assert torch.equal(call(), got)
    monkeypatch.setattr(fa, "decode_chunk", _one_chunk)
    one = call()
    assert _max_err(one, want) <= tol
    assert _max_err(one, got) <= tol


@pytest.mark.parametrize("dtype,tol", [(torch.float32, TOL), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("mask", ["window", "chunk"])
@pytest.mark.parametrize("mode", ["fused", "window"])
def test_decode_split_masks(gen, mode, mask, dtype, tol):
    """Sliding-window and chunk masks with offset starts, G 4, D 64."""
    call, plain = _decode_call(mode, gen, dtype, 4, 64, mask)
    got = call()
    assert _max_err(got, plain()) <= tol
    assert torch.equal(call(), got)


PAGED_PREFILL_BF16_TOL = 2e-2  # bf16 with v_scale 2: two output ulps near 1


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("bs", [8, 16, 64, 128, 256])
def test_paged_prefill_wgmma_body(gen, monkeypatch, D, bs):
    """The TMA + wgmma body's paged mode in the model's layout: a 300-token
    chunk (not a multiple of 128) after a 260-token prefix, and one from 0;
    a hole inside the prefix and a 128-position run of holes (a kv tile
    the body skips); k/v scales; against the plain version and the mma.sync
    body, the same bits on a second call."""
    B, H, KV, Sq = 2, 8, 2, 300
    NB = 640 // bs
    perm = torch.randperm(2 * NB, generator=torch.Generator().manual_seed(5))
    bt = perm.reshape(2, NB).to(torch.int32)
    bt[0, 40 // bs] = -1
    bt[0, 128 // bs:256 // bs] = -1  # positions 128-255 of row 0: tile 1, holes only
    kc_, vc_ = (_randn(gen, 2 * NB * bs, KV, D).to(torch.bfloat16) for _ in range(2))
    q = _randn(gen, B, Sq, H, D).to(torch.bfloat16).transpose(1, 2)
    qp = torch.tensor([[260], [0]], dtype=torch.int32) + torch.arange(Sq, dtype=torch.int32)
    qp = qp.cuda()
    kw = dict(block_size=bs, k_scale=0.5, v_scale=2.0)
    assert fa.paged_prefill_body(q, kc_, vc_, bs) == "wgmma"
    before = fa.paged_attention_prefill.launches
    got = fa.paged_attention_prefill(q, kc_, vc_, bt, qp, **kw)
    assert fa.paged_attention_prefill.launches == before + 1
    want = fa.paged_attention_prefill_plain(q, kc_, vc_, bt.cuda(), qp, **kw)
    assert _max_err(got, want) <= PAGED_PREFILL_BF16_TOL
    assert torch.equal(fa.paged_attention_prefill(q, kc_, vc_, bt, qp, **kw), got)
    monkeypatch.setattr(fa, "paged_prefill_body", lambda *a: "mma")
    assert _max_err(fa.paged_attention_prefill(q, kc_, vc_, bt, qp, **kw), want) <= \
        PAGED_PREFILL_BF16_TOL


# ---------------------------------------------------------------------------
# the ragged launch sized from shapes (the mixed step's graph holds it)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("stream", list(RAGGED_STREAMS))
def test_ragged_shape_sized_launch_matches_per_call(gen, stream):
    """The plan padded to the bucket's capacity, launched at the capacity's
    sizes (counts read on the card), gives the per-call launch's bits."""
    T, rows = RAGGED_STREAMS[stream]
    H, KV, D, bs, NB = 32, 8, 64, 128, 16
    R = max(s for s, _, _ in rows) + 1
    bt, rid, qp = _ragged_stream(rows, T, R, NB, bs, gen)
    kc_, vc_ = (_randn(gen, R * NB * bs, KV, D).to(torch.bfloat16) for _ in range(2))
    q = _randn(gen, 1, T, H, D).to(torch.bfloat16).transpose(1, 2)
    plan = rpa.ragged_plan(rid, qp, R, NB * bs, KV)
    cap = rpa.ragged_capacity(T, R, NB * bs, KV)
    static = dataclasses.replace(cap, flat=torch.from_numpy(rpa.pad_plan(plan, cap)).cuda())
    want = rpa.ragged_paged_attention(q, kc_, vc_, bt, rid, qp, block_size=bs, plan=plan)
    got = rpa.ragged_paged_attention(q, kc_, vc_, bt, rid, qp, block_size=bs, plan=static)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# one CUDA graph per (submodel, bucket): replay against eager
# ---------------------------------------------------------------------------

# a 2-layer bf16 Llama at narrow widths (head dim 64: the wgmma bodies)
SMALL_LLAMA = dict(hidden_size=256, intermediate_size=512, num_attention_heads=4,
                   num_key_value_heads=2, head_dim=64, vocab_size=512, num_hidden_layers=2)


def _card_app(graphs, params=None, **tc):
    from nxdi_tpu_torch.config import OnDeviceSamplingConfig, TorchConfig
    from nxdi_tpu_torch.models import dense
    from nxdi_tpu_torch.models.llama import modeling_llama as ml
    from nxdi_tpu_torch.runtime.application import TorchModelForCausalLM

    kw = dict(tp_degree=1, dtype="bfloat16", on_device_sampling_config=OnDeviceSamplingConfig(),
              attn_kernel_enabled=True, attn_tkg_kernel_enabled=True, output_logits=True)
    kw.update(tc)
    cfg = ml.LlamaInferenceConfig(TorchConfig(**kw), **dict(ml.LLAMA_3_2_1B, **SMALL_LLAMA))
    arch = ml.build_arch(cfg)

    class App(TorchModelForCausalLM):
        def build_params(self):
            return params if params is not None else dense.random_params(arch, seed=0,
                                                                         device="cuda")

    app = App("<random>", cfg, model_family=ml, graphs=graphs)
    app.load()
    return app


STATIC = dict(batch_size=2, seq_len=256, max_context_length=64, enable_bucketing=True,
              context_encoding_buckets=[32, 64], token_generation_buckets=[64, 128, 256])
ENGINE = dict(batch_size=1, ctx_batch_size=1, tkg_batch_size=4, seq_len=512,
              max_context_length=256, enable_bucketing=True, is_block_kv_layout=True,
              pa_block_size=16, pa_num_blocks=64, is_prefix_caching=True,
              chunked_prefill_config={"chunk_size": 64}, attn_block_tkg_kernel_enabled=True)
MIXED = dict(ENGINE, mixed_dispatch=True, fused_qkv=True, qkv_kernel_enabled=True,
             mlp_kernel_enabled=True)


def _logged(app):
    log = []
    inner = app.forward

    def fwd(*a, **k):
        out = inner(*a, **k)
        log.append({key: v.clone() for key, v in out.items() if key != "next_inputs"})
        return out

    app.forward = fwd
    return log


def _counts():
    from nxdi_tpu_torch.ops.kernels import launch_counters

    return {fn.__name__: fn.launches for fn in launch_counters()}


def _drive(app, kind):
    """The static generate path (every bucket of both submodels), or the
    engine (prefix sharing, a chunked prompt, decode rows): per-dispatch
    outputs, the launch counts, and the tokens."""
    from nxdi_tpu_torch.generation.hf_adapter import HuggingFaceGenerationAdapter
    from nxdi_tpu_torch.ops.kernels import launch_counters
    from nxdi_tpu_torch.serving import InferenceEngine, SamplingParams, SchedulerConfig

    for fn in launch_counters():
        fn.launches = 0
    log = _logged(app)
    rng = np.random.default_rng(3)
    if kind == "static":
        ids = rng.integers(1, 512, (2, 40)).astype(np.int64)
        mask = np.ones_like(ids, dtype=np.int32)
        mask[1, 29:] = 0
        ids[1, 29:] = 0
        toks = HuggingFaceGenerationAdapter(app).generate(ids, attention_mask=mask,
                                                          max_new_tokens=120)
    else:
        eng = InferenceEngine(app, SchedulerConfig(prefix_cache=True,
                                                   cache_aware_admission=False))
        shared = rng.integers(1, 512, 48).tolist()
        prompts = [shared + rng.integers(1, 512, 20).tolist(), rng.integers(1, 512, 150).tolist(),
                   shared + rng.integers(1, 512, 7).tolist(), rng.integers(1, 512, 9).tolist()]
        reqs = [eng.add_request(p, SamplingParams(max_new_tokens=12)) for p in prompts[:2]]
        eng.step()
        reqs += [eng.add_request(p, SamplingParams(max_new_tokens=12)) for p in prompts[2:]]
        outs = {o.request_id: o.token_ids for o in eng.run()}
        toks = [outs[r.request_id] for r in reqs]
    torch.cuda.synchronize()
    return log, _counts(), toks


@pytest.mark.parametrize("kind", ["static", "engine", "mixed"])
def test_graph_replay_equals_eager(gen, kind):
    """Every dispatch of a graph app (each bucket captured at its first
    dispatch, replayed after) against an eager app with the same params:
    the same tokens, every output bit for bit, the same launch counts; every
    bucket the traffic reached ran as a graph."""
    tc = {"static": STATIC, "engine": ENGINE, "mixed": MIXED}[kind]
    graphs = _card_app(True, **tc)
    eager = _card_app(False, params=graphs.params, **tc)
    g_log, g_counts, g_toks = _drive(graphs, "static" if kind == "static" else "engine")
    e_log, e_counts, e_toks = _drive(eager, "static" if kind == "static" else "engine")
    assert np.array_equal(np.asarray(g_toks), np.asarray(e_toks))
    assert len(g_log) == len(e_log) > 0
    for i, (a, b) in enumerate(zip(g_log, e_log)):
        for key in a:
            assert torch.equal(a[key], b[key]), (i, key)
    assert g_counts == e_counts and sum(g_counts.values()) > 0
    for w in graphs.models.values():
        assert all(bg.graph is not None for bg in w.bucket_graphs.values())
        assert set(w.bucket_graphs) == set(w.buckets)  # warmup captured every bucket


@pytest.mark.parametrize("skip_warmup", [False, True])
def test_replay_after_restaging_and_other_buckets(gen, skip_warmup):
    """A token-generation bucket replayed after its staging buffer was
    refilled with other rows and another bucket (sharing its static inputs)
    ran in between: the same bits as its first replay and as eager. With
    skip_warmup each bucket is captured at its first dispatch."""
    graphs = _card_app(True, skip_warmup=skip_warmup, **STATIC)
    eager = _card_app(False, params=graphs.params, skip_warmup=skip_warmup, **STATIC)
    ids = np.array([[7], [11]], np.int32)
    a = dict(last_token_index=np.zeros(2, np.int32))
    outs = []
    for app in (graphs, eager):
        first = app.forward(ids, np.array([[10], [20]], np.int32), **a)["logits"].clone()
        app.forward(ids[::-1].copy(), np.array([[100], [90]], np.int32), **a)  # bucket 128
        again = app.forward(ids, np.array([[10], [20]], np.int32), **a)["logits"].clone()
        assert torch.equal(first, again)
        outs.append(again)
    assert torch.equal(*outs)
    assert graphs.models["token_generation_model"].last_bucket == 64


def test_async_on_the_card_equals_sync(gen):
    """async_mode's device-resident loop through the graphs: the sync
    loop's tokens, and no H2D copy after the first step (the graph writes
    its next inputs into the shared static inputs)."""
    from nxdi_tpu_torch.generation.hf_adapter import HuggingFaceGenerationAdapter

    sync = _card_app(True, **STATIC)
    asyn = _card_app(True, params=sync.params, async_mode=True, **STATIC)
    assert asyn.async_supported
    ids = np.random.default_rng(5).integers(1, 512, (2, 33)).astype(np.int64)
    outs = [HuggingFaceGenerationAdapter(app).generate(ids, max_new_tokens=100)
            for app in (sync, asyn)]
    assert np.array_equal(*outs)


def test_failing_capture_names_submodel_and_bucket(gen, monkeypatch):
    """A forward that cannot be captured (it syncs) raises, naming the
    submodel and the bucket; nothing runs it eagerly instead."""
    from nxdi_tpu_torch.runtime import model_wrapper as mw

    inner = mw.base.causal_lm_forward

    def syncing(*a, **k):
        if torch.cuda.is_current_stream_capturing():
            torch.cuda.synchronize()
        return inner(*a, **k)

    monkeypatch.setattr(mw.base, "causal_lm_forward", syncing)
    with pytest.raises(RuntimeError, match="context_encoding_model bucket 64: CUDA graph capture"):
        _card_app(True, **STATIC)


# --- the device-resident decode family (contiguous continuous batching) ---


@pytest.mark.parametrize("dtype,tol", [(torch.float32, TOL), (torch.bfloat16, 2e-2)])
def test_decode_with_cache_lines(gen, dtype, tol):
    """The fused decode's line operand: row b reads cache line lines[b] of a
    cache with more lines than rows (one line twice, one out of range and
    clipped, as the JAX package's gather), against the plain version over
    the gathered lines; one launch."""
    L, Bc, B, H, KV, S, D = 3, 5, 4, 8, 2, 300, 64
    ks, vs = _randn(gen, L, Bc, KV, S, D).to(dtype), _randn(gen, L, Bc, KV, S, D).to(dtype)
    q = _randn(gen, B, H, 1, D).to(dtype)
    kn, vn = _randn(gen, B, KV, 1, D).to(dtype), _randn(gen, B, KV, 1, D).to(dtype)
    q_pos = torch.tensor([[17], [250], [0], [299]], dtype=torch.int32, device="cuda")
    lines = torch.tensor([4, 4, 0, 9], dtype=torch.int32, device="cuda")
    before = fa.flash_attention_decode_fused.launches
    got = fa.flash_attention_decode_fused_stacked(q, ks, vs, kn, vn, q_pos, 1, lines=lines)
    assert fa.flash_attention_decode_fused.launches == before + 1
    sel = lines.long().clamp(0, Bc - 1)
    want = fa.flash_attention_decode_fused_plain(q, ks[1][sel], vs[1][sel], kn, vn, q_pos)
    assert (got.float() - want.float()).abs().max().item() <= tol
    with pytest.raises(ValueError, match="no cache lines"):
        fa.flash_attention_decode_fused_stacked(q, ks, vs, kn, vn, q_pos, 1)


def test_commit_with_frozen_and_duplicate_lanes(gen):
    """The commit of a K-step / loop body: rows routed to cache lines, a
    frozen lane (slot -1) and a padding lane repeating row 0 (its line, its
    slot, its rows) land exactly as the plain version's."""
    L, Bc, B, KV, S, D = 2, 4, 5, 2, 64, 16
    for dtype in (torch.float32, torch.bfloat16):
        k, v = _randn(gen, L, Bc, KV, S, D).to(dtype), _randn(gen, L, Bc, KV, S, D).to(dtype)
        kr, vr = _randn(gen, L, B, KV, 1, D).to(dtype), _randn(gen, L, B, KV, 1, D).to(dtype)
        kr[:, 4], vr[:, 4] = kr[:, 0], vr[:, 0]
        slots = torch.tensor([[10], [3], [-1], [63], [10]], dtype=torch.int32, device="cuda")
        lines = torch.tensor([2, 0, 1, 3, 2], dtype=torch.int32, device="cuda")
        k_ref, v_ref = k.clone(), v.clone()
        kc.kv_commit_rows_plain(k_ref, v_ref, kr, vr, slots, lines)
        kc.kv_commit_rows(k, v, kr, vr, slots, lines)
        torch.cuda.synchronize()
        assert torch.equal(k, k_ref) and torch.equal(v, v_ref)


def test_sampler_under_graph_capture(gen):
    """The sampler captured in a CUDA graph: one replay per key gives fresh
    draws that a replay with the same key repeats, and the CPU's tokens."""
    from nxdi_tpu_torch.ops import sampling as so

    logits = _randn(gen, 8, 1000) * 3
    sp = torch.tensor([[50, 0.9, 0.8]] * 8, device="cuda")
    key = torch.tensor([7, 1], device="cuda")
    out = so.sample(logits, sp, rng=key, do_sample=True)  # eager first
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = so.sample(logits, sp, rng=key, do_sample=True)
    seen = []
    for c in (1, 2, 3, 1):
        key.copy_(torch.tensor([7, c]))
        g.replay()
        torch.cuda.synchronize()
        seen.append(out.clone())
        want = so.sample(logits.cpu(), sp.cpu(), rng=torch.tensor([7, c]), do_sample=True)
        assert torch.equal(out.cpu(), want)
    assert torch.equal(seen[0], seen[3])
    assert not torch.equal(seen[0], seen[1]) and not torch.equal(seen[1], seen[2])


def test_loop_window_graph_capture(gen):
    """The device loop's window graph: one captured iteration behind IF
    nodes, the loop state updated in place, the kernels launched on
    PyTorch's current stream captured into the IF bodies. Budgets 3 and 12
    (cap 16, windows of 8): two windows, twelve iterations, the skipped
    bodies launching nothing (the launch counters add one iteration's
    launches per iteration), and the loop's tokens equal to the eager
    loop's."""
    from nxdi_tpu_torch.ops.kernels import launch_counters

    tc = dict(CB, device_loop=True)
    graphs = _card_app(True, **tc)
    eager = _card_app(False, params=graphs.params, **tc)
    w = graphs.models["tkg_device_loop"]
    assert w.loop_graphs  # warmup built a window graph per (cap, bucket)
    outs = []
    for app in (graphs, eager):
        first = _cb_prefill(app)
        for fn in launch_counters():
            fn.launches = 0
        out = app.token_gen_device_loop(dict(
            input_ids=first[:, None], position_ids=np.array([[20], [33]], np.int32),
            last_token_index=np.zeros(2, np.int32), seq_ids=np.array([1, 0], np.int32),
            budget_steps=np.array([3, 12], np.int32)))
        assert int(out["loop_iters"]) == 12
        outs.append((out["tokens"][:, :12].cpu().clone(), _counts()))
    assert torch.equal(outs[0][0], outs[1][0])
    assert outs[0][1] == outs[1][1]
    assert outs[0][1]["flash_attention_decode_fused"] == 12 * 2  # 2 layers
    assert outs[0][1]["kv_commit_rows"] == 12
    assert w._windows_run == [0, 1]
    ring = w.drain_outfeed()
    assert [e[0] for e in ring] == list(range(12))
    assert all(np.array_equal(e[1][:2], outs[0][0][:, e[0]].numpy()) for e in ring)


def _cb_prefill(app):
    rng = np.random.default_rng(2)
    first = []
    for n, line in ((20, 1), (33, 0)):
        out = app.forward(rng.integers(1, 512, (1, n)).astype(np.int32),
                          np.arange(n, dtype=np.int32)[None],
                          last_token_index=np.array([n - 1], np.int32),
                          seq_ids=np.array([line], np.int32))
        first.append(int(out["tokens"][0, 0]))
    return np.array(first, np.int32)


CB = dict(batch_size=2, seq_len=256, max_context_length=64, enable_bucketing=True,
          context_encoding_buckets=[32, 64], token_generation_buckets=[64, 128, 256],
          is_continuous_batching=True, device_loop_fence=16, device_loop_outfeed=True)


@pytest.mark.parametrize("mode", ["K-step", "loop"])
def test_contiguous_engine_graphs_equal_eager_and_one_step(gen, mode):
    """The contiguous engine on the card, K-step windows (ladder 2, 4) or the
    loop (fence 16), through the graphs: the streams of the same app eager and
    of the 1-step engine, with interleaved arrivals and length finishes."""
    from nxdi_tpu_torch.serving import InferenceEngine, SamplingParams

    extra = dict(decode_steps_per_dispatch=4) if mode == "K-step" else dict(device_loop=True)
    one = _card_app(True, **CB)
    apps = [_card_app(g, params=one.params, **CB, **extra) for g in (True, False)]
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, 512, n).tolist() for n in (30, 50, 12)]
    streams = []
    for app in (one, *apps):
        eng = InferenceEngine(app)
        reqs = [eng.add_request(p, SamplingParams(max_new_tokens=m))
                for p, m in zip(prompts[:2], (9, 14))]
        outs = eng.step()
        reqs.append(eng.add_request(prompts[2], SamplingParams(max_new_tokens=6)))
        outs += eng.run()
        got = {o.request_id: o.token_ids for o in outs}
        streams.append([got[r.request_id] for r in reqs])
    assert streams[0] == streams[1] == streams[2]
    assert [len(s) for s in streams[0]] == [9, 14, 6]


# ---------------------------------------------------------------------------
# one-byte KV stores (a quantized cache): the commit, the paged decode and
# prefill, and the ragged kernels read or write float8_e4m3fn, float8_e5m2
# and int8 pools, converting K/V to q's dtype as tiles land
# ---------------------------------------------------------------------------

ONE_BYTE = {"e4m3": torch.float8_e4m3fn, "e5m2": torch.float8_e5m2, "int8": torch.int8}
# the scales that bring each store's values back near 1 (k_scale folds into
# the softmax scale, v_scale into the output)
ONE_BYTE_SCALES = {"e4m3": dict(k_scale=0.5, v_scale=0.5), "e5m2": dict(k_scale=0.5, v_scale=0.5),
                   "int8": dict(k_scale=0.05, v_scale=0.05)}
# max |kernel - plain|: the one-byte values are exact in bf16 and f32, so the
# kernels' own tolerances hold (bf16: a few output ulps; f32 with scores of
# ~10 against a float32 plain version)
ONE_BYTE_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _one_byte(gen, store, *shape):
    x = _randn(gen, *shape)
    if store == "int8":
        return (x * 20).round().clamp(-127, 127).to(torch.int8)
    return (x * 2).to(ONE_BYTE[store])


def _kernel_names(fn, calls=4):
    """The base names of the kernels ``fn`` launches, over ``calls``
    profiled calls (the card's machine now and then traces a call short of
    kernels, so one call may miss some)."""
    from torch.profiler import ProfilerActivity, profile

    names = set()
    for _ in range(calls):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            found = re.findall(r"[A-Za-z_]\w*_kernel\b", e.key)
            if found:
                names.add(found[0])
    return sorted(names)


@pytest.mark.parametrize("G", [4, 24])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bs", [16, 128])
@pytest.mark.parametrize("D", [16, 64, 128])
@pytest.mark.parametrize("store", list(ONE_BYTE))
def test_one_byte_paged_decode(gen, store, D, bs, dtype, G):
    """The paged decode over a one-byte pool (G 4, and G 24 in two head
    tiles of 16; 768 positions split in
    chunks of 128, a table of holes only, a hole mid-range, a row at
    position 0 and one at a chunk's first position): against the plain
    version, one launch a call, the same bits on a second call, only the
    split and combine kernels launched. With bf16 q (the raw tiles on the
    tensor-core body) the output equals, bit for bit, the bf16 pool's kernel
    on the pool up-cast to bf16 under the same scales."""
    B, KV = 4, 2
    NB = 768 // bs
    kc_, vc_ = (_one_byte(gen, store, B * NB * bs, KV, D) for _ in range(2))
    bt = torch.randperm(B * NB, generator=torch.Generator().manual_seed(3)).reshape(B, NB)
    bt = bt.to(torch.int32)
    bt[1, :] = -1
    bt[2, 112 // bs] = -1
    q = _randn(gen, B, 1, KV * G, D).to(dtype).transpose(1, 2)
    qp = torch.tensor([[767], [300], [384], [0]], dtype=torch.int32).cuda()
    kw = dict(block_size=bs, **ONE_BYTE_SCALES[store])
    assert fa.decode_chunk(B, KV, NB * bs, fa._sm_count(0)) == 128
    btc = bt.cuda()
    before = fa.paged_attention_decode.launches
    got = fa.paged_attention_decode(q, kc_, vc_, btc, qp, **kw)
    assert fa.paged_attention_decode.launches == before + 1
    want = fa.paged_attention_decode_plain(q, kc_, vc_, btc, qp, **kw)
    assert _max_err(got, want) <= ONE_BYTE_TOL[dtype]
    assert torch.all(got[1] == 0)
    assert torch.equal(fa.paged_attention_decode(q, kc_, vc_, btc, qp, **kw), got)
    assert _kernel_names(lambda: fa.paged_attention_decode(q, kc_, vc_, btc, qp, **kw)) == [
        "decode_combine_kernel", "decode_split_kernel"]
    if dtype == torch.bfloat16:
        up = fa.paged_attention_decode(q, kc_.to(dtype), vc_.to(dtype), btc, qp, **kw)
        assert torch.equal(got, up)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bs", [16, 128])
@pytest.mark.parametrize("store", list(ONE_BYTE))
def test_one_byte_paged_prefill(gen, store, bs, dtype):
    """The paged prefill over a one-byte pool runs the one-byte TMA + wgmma
    body (bf16, head dim 64) or the CUDA-core body (f32): a 300-token chunk
    after a 260-token prefix with a hole, and one from 0; against the plain
    version, the same bits on a second call."""
    B, H, KV, D, Sq = 2, 8, 2, 64, 300
    NB = 640 // bs
    bt = torch.randperm(2 * NB, generator=torch.Generator().manual_seed(5)).reshape(2, NB)
    bt = bt.to(torch.int32)
    bt[0, 40 // bs] = -1
    kc_, vc_ = (_one_byte(gen, store, 2 * NB * bs, KV, D) for _ in range(2))
    q = _randn(gen, B, Sq, H, D).to(dtype).transpose(1, 2)
    qp = (torch.tensor([[260], [0]], dtype=torch.int32) + torch.arange(Sq, dtype=torch.int32))
    qp = qp.cuda()
    kw = dict(block_size=bs, **ONE_BYTE_SCALES[store])
    assert fa.paged_prefill_body(q, kc_, vc_, bs) == ("wgmma" if dtype == torch.bfloat16
                                                      else "simt")
    before = fa.paged_attention_prefill.launches
    got = fa.paged_attention_prefill(q, kc_, vc_, bt, qp, **kw)
    assert fa.paged_attention_prefill.launches == before + 1
    want = fa.paged_attention_prefill_plain(q, kc_, vc_, bt.cuda(), qp, **kw)
    assert _max_err(got, want) <= ONE_BYTE_TOL[dtype]
    assert torch.equal(fa.paged_attention_prefill(q, kc_, vc_, bt, qp, **kw), got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stream", ["decode8", "chunk_and_long_decode"])
@pytest.mark.parametrize("store", list(ONE_BYTE))
def test_one_byte_ragged(gen, store, stream, dtype):
    """The ragged kernels (wgmma items or direct tiles, split, combine) over
    a one-byte pool: against the plain version, padding exactly 0, the same
    bits on a second call, the split kernel launched; with bf16 q the split
    items' tokens equal, bit for bit, the bf16 pool's kernels on the pool
    up-cast to bf16 (both run the tensor-core split); the graph-ready launch
    (the plan padded to the bucket's capacity, the split blocks striding
    over the items) eager and replayed from a CUDA graph equal to the
    per-call launch."""
    T, rows = RAGGED_STREAMS[stream]
    H, KV, D, bs, NB = 32, 8, 64, 128, 16
    R = max(s for s, _, _ in rows) + 1
    bt, rid, qp = _ragged_stream(rows, T, R, NB, bs, gen)
    kc_, vc_ = (_one_byte(gen, store, R * NB * bs, KV, D) for _ in range(2))
    q = _randn(gen, 1, T, H, D).to(dtype).transpose(1, 2)
    wgmma = rpa.ragged_direct_body(dtype, ONE_BYTE[store], D, bs) == "wgmma"
    assert wgmma == (dtype == torch.bfloat16)
    plan = rpa.ragged_plan(rid, qp, R, NB * bs, KV, wgmma=wgmma)
    assert plan.n_items > 0
    kw = dict(block_size=bs, **ONE_BYTE_SCALES[store])
    before = rpa.ragged_paged_attention.launches
    got = rpa.ragged_paged_attention(q, kc_, vc_, bt, rid, qp, plan=plan, **kw)
    assert rpa.ragged_paged_attention.launches == before + 1
    want = rpa.ragged_paged_attention_plain(q, kc_, vc_, bt, rid, qp, **kw)
    assert _max_err(got, want) <= ONE_BYTE_TOL[dtype]
    assert torch.all(got[:, :, torch.from_numpy(rid < 0).cuda()] == 0)
    assert torch.equal(rpa.ragged_paged_attention(q, kc_, vc_, bt, rid, qp, plan=plan, **kw), got)
    if dtype == torch.bfloat16:  # the split items equal the bf16 pool's on the up-cast pool
        toks = torch.from_numpy(np.unique(plan.items()[:, 0])).cuda()
        up = rpa.ragged_paged_attention(q, kc_.to(dtype), vc_.to(dtype), bt, rid, qp, **kw,
                                        plan=rpa.ragged_plan(rid, qp, R, NB * bs, KV))
        assert torch.equal(got[:, :, toks], up[:, :, toks])
    btc, ridc, qpc = (torch.from_numpy(x).cuda() for x in (bt, rid, qp))
    dev_plan = plan.to("cuda")
    assert "ragged_split_kernel" in _kernel_names(
        lambda: rpa.ragged_paged_attention(q, kc_, vc_, btc, ridc, qpc, plan=dev_plan, **kw))
    cap = rpa.ragged_capacity(T, R, NB * bs, KV, wgmma=wgmma)
    static = dataclasses.replace(cap, flat=torch.from_numpy(rpa.pad_plan(plan, cap)).cuda())
    eager = rpa.ragged_paged_attention(q, kc_, vc_, btc, ridc, qpc, plan=static, **kw)
    assert torch.equal(eager, got)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = rpa.ragged_paged_attention(q, kc_, vc_, btc, ridc, qpc, plan=static, **kw)
    out.zero_()
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, got)


@pytest.mark.parametrize("store", list(ONE_BYTE))
def test_one_byte_commit(gen, store):
    """The commit writes one-byte rows at their slots (a dropped slot, a
    routed line), bit for bit as the plain version."""
    L, B, KV, S, D = 3, 4, 2, 32, 16
    k_cache, v_cache = (_one_byte(gen, store, L, B, KV, S, D) for _ in range(2))
    k_rows, v_rows = (_one_byte(gen, store, L, B, KV, 1, D) for _ in range(2))
    slots = torch.tensor([[3], [-1], [31], [0]], dtype=torch.int32)
    lines = torch.tensor([2, 0, 3, 1], dtype=torch.int32)
    k_ref, v_ref = k_cache.clone(), v_cache.clone()
    kc.kv_commit_rows_plain(k_ref, v_ref, k_rows, v_rows, slots.cuda(), lines.cuda())
    before = kc.kv_commit_rows.launches
    kc.kv_commit_rows(k_cache, v_cache, k_rows, v_rows, slots, lines)
    assert kc.kv_commit_rows.launches == before + 1
    bits = (lambda t: t.view(torch.uint8))  # noqa: E731
    assert torch.equal(bits(k_cache), bits(k_ref)) and torch.equal(bits(v_cache), bits(v_ref))


@pytest.mark.parametrize("bs", [16, 64, 128])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("store", list(ONE_BYTE))
def test_one_byte_bf16_runs_are_unchanged(gen, store, D, bs):
    """A bf16 pool still takes the TMA + wgmma paged prefill, and so do the
    same values stored one byte an element: the one-byte body's output
    equals, bit for bit, the bf16 body's on the pool up-cast to bf16 with
    the same scales (the conversion in shared memory is exact). Two rows: a
    chunk of 300 after 260 cached with a hole, and one of 77 from 0."""
    B, H, KV, Sq = 2, 8, 2, 300
    NB = 640 // bs
    kc_, vc_ = (_one_byte(gen, store, 2 * NB * bs, KV, D) for _ in range(2))
    bt = torch.randperm(2 * NB, generator=torch.Generator().manual_seed(9)).reshape(2, NB)
    bt = bt.to(torch.int32)
    bt[0, 40 // bs] = -1
    bt[1, -(-77 // bs):] = -1
    q = _randn(gen, B, Sq, H, D).to(torch.bfloat16).transpose(1, 2)
    qp = (torch.tensor([[260], [0]], dtype=torch.int32) + torch.arange(Sq, dtype=torch.int32))
    qp = qp.cuda()
    kb, vb = kc_.to(torch.bfloat16), vc_.to(torch.bfloat16)
    kw = dict(block_size=bs, **ONE_BYTE_SCALES[store])
    assert fa.paged_prefill_body(q, kb, vb, bs) == "wgmma"
    assert fa.paged_prefill_body(q, kc_, vc_, bs) == "wgmma"
    one = fa.paged_attention_prefill(q, kc_, vc_, bt, qp, **kw)
    two = fa.paged_attention_prefill(q, kb, vb, bt, qp, **kw)
    assert torch.equal(one, two)
    want = fa.paged_attention_prefill_plain(q, kc_, vc_, bt.cuda(), qp, **kw)
    assert _max_err(one, want) <= ONE_BYTE_TOL[torch.bfloat16]


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("store", list(ONE_BYTE))
def test_one_byte_ragged_wgmma_items(gen, store, D):
    """The ragged kernel over a one-byte pool with bf16 q runs its one-row
    tiles as wgmma items: a 300-token chunk (tiles 0-3: two items of 128;
    its last 44 tokens share tile 4 and go to the split items), an 84-token
    chunk (its second tile alone: an item of 64) and a 70-token chunk whose
    positions jump in its first tile (that tile goes to the split items),
    beside decode rows and padding; against the plain version, padding
    exactly 0, the same bits on a second call, through the plan padded to
    the bucket's capacity, and replayed from a CUDA graph capture equal to
    the eager call."""
    T, H, KV, bs, NB = 520, 16, 4, 64, 12
    rows = [(2, 100, 300), (4, 10, 84), (3, 0, 70), (0, 500, 1), (1, 7, 1)]
    R = 5
    bt, rid, qp = _ragged_stream(rows, T, R, NB, bs, gen)
    qp[419:454] += 25  # slot 3: positions 0..34, then 60..94
    kc_, vc_ = (_one_byte(gen, store, R * NB * bs, KV, D) for _ in range(2))
    q = _randn(gen, 1, T, H, D).to(torch.bfloat16).transpose(1, 2)
    assert rpa.ragged_direct_body(torch.bfloat16, ONE_BYTE[store], D, bs) == "wgmma"
    plan = rpa.ragged_plan(rid, qp, R, NB * bs, KV, wgmma=True)
    assert plan.n_direct == 0
    assert plan.wgmma_items().tolist() == [[128, 128, 2, 228], [0, 128, 2, 100], [320, 64, 4, 30]]
    kw = dict(block_size=bs, **ONE_BYTE_SCALES[store])
    before = rpa.ragged_paged_attention.launches
    got = rpa.ragged_paged_attention(q, kc_, vc_, bt, rid, qp, plan=plan, **kw)
    assert rpa.ragged_paged_attention.launches == before + 1
    want = rpa.ragged_paged_attention_plain(q, kc_, vc_, bt, rid, qp, **kw)
    assert _max_err(got, want) <= ONE_BYTE_TOL[torch.bfloat16]
    assert torch.all(got[:, :, torch.from_numpy(rid < 0).cuda()] == 0)
    assert torch.equal(rpa.ragged_paged_attention(q, kc_, vc_, bt, rid, qp, plan=plan, **kw), got)
    # a plan without wgmma items is refused (no quiet fallback to mma.sync)
    with pytest.raises(ValueError, match="wgmma"):
        rpa.ragged_paged_attention(q, kc_, vc_, bt, rid, qp, **kw,
                                   plan=rpa.ragged_plan(rid, qp, R, NB * bs, KV))
    # the graph-ready launch, eager and captured
    cap = rpa.ragged_capacity(T, R, NB * bs, KV, wgmma=True)
    flat = torch.from_numpy(rpa.pad_plan(plan, cap)).cuda()
    static = dataclasses.replace(cap, flat=flat)
    btc, ridc, qpc = (torch.from_numpy(x).cuda() for x in (bt, rid, qp))
    eager = rpa.ragged_paged_attention(q, kc_, vc_, btc, ridc, qpc, plan=static, **kw)
    assert torch.equal(eager, got)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = rpa.ragged_paged_attention(q, kc_, vc_, btc, ridc, qpc, plan=static, **kw)
    out.zero_()
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, got)


def test_one_byte_wgmma_refuses_what_tma_cannot_take(gen):
    """An eligible one-byte call whose pool breaks TMA's rules (a base 8
    bytes off 16-byte alignment, rows 72 bytes apart) raises; nothing runs
    the mma.sync body in its place."""
    KV, D, bs = 2, 64, 16
    q = _randn(gen, 1, 40, 8, D).to(torch.bfloat16).transpose(1, 2)
    buf = torch.zeros(8 * bs * KV * D + 8, dtype=torch.uint8, device="cuda")
    off = buf[8:].view(torch.float8_e4m3fn).view(8 * bs, KV, D)
    wide = torch.zeros(8 * bs, KV, D + 8, dtype=torch.float8_e4m3fn, device="cuda")[..., :D]
    bt = torch.arange(8, dtype=torch.int32)[None]
    qp = torch.arange(40, dtype=torch.int32)[None].cuda()
    for pool in (off, wide):
        before = fa.paged_attention_prefill.launches
        with pytest.raises(ValueError):
            fa.paged_attention_prefill(q, pool, pool, bt, qp, block_size=bs)
        assert fa.paged_attention_prefill.launches == before


@pytest.mark.parametrize("M,K,N", [(1, 64, 48), (5, 60, 40), (17, 2048, 3072), (33, 24, 8)])
def test_int_mm_shape_rule(gen, M, K, N):
    """The int8 x int8 -> int32 product on the card (torch._int_mm on
    operands padded to its rule) equals the CPU's exact int32 product."""
    from nxdi_tpu_torch.ops import quantization as tq

    g = torch.Generator().manual_seed(M)
    a = torch.randint(-127, 128, (M, K), generator=g, dtype=torch.int8)
    b = torch.randint(-127, 128, (K, N), generator=g, dtype=torch.int8)
    got = tq.int8_matmul(a.cuda(), b.cuda())
    assert got.dtype == torch.int32 and got.shape == (M, N)
    assert torch.equal(got.cpu(), tq.int8_matmul(a, b))


@pytest.mark.parametrize("tc", ["static", "loop"])
def test_capture_with_garbage_graphs_and_an_eager_collector(gen, tc):
    """Another app's graphs left in a reference cycle (only the collector
    frees them) and the collector set to run at every allocation: every
    capture of a new app still succeeds, since the collector is paused while
    a stream captures (a collection inside a capture destroys the old
    graphs, which a capturing stream does not permit)."""
    import gc

    kw = STATIC if tc == "static" else dict(CB, device_loop=True)
    old = _card_app(True, **kw)
    old.cycle = old
    del old
    thresholds = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        app = _card_app(True, **kw)
    finally:
        gc.set_threshold(*thresholds)
    # (the device loop's graphs are its window graphs, not bucket graphs)
    assert all(bg.graph is not None for tag, w in app.models.items()
               if tag != "tkg_device_loop" for bg in w.bucket_graphs.values())
    if tc == "loop":
        assert app.models["tkg_device_loop"].loop_graphs


def test_fused_decode_over_a_quantized_contiguous_cache(gen):
    """A quantized contiguous cache leaves the stacked fused decode (it reads
    the cache in q's dtype; the JAX rule), and the same kernel runs per layer
    over the dequantized window: generate() through it, L launches per
    decode step, against the same app with the flag off (plain two-part
    attention over the same window): the same tokens, logits within 1e-3
    (float32; the kernel's online softmax against the plain one)."""
    kw = dict(STATIC, dtype="float32", kv_quant_config=dict(dtype="float8_e4m3"))
    app = _card_app(True, **kw)
    plain = _card_app(True, params=app.params, **dict(kw, attn_tkg_kernel_enabled=False))
    assert app.kv_cache["k"].dtype == torch.float8_e4m3fn
    log, counts, toks = _drive(app, "static")
    p_log, p_counts, p_toks = _drive(plain, "static")
    steps = len(log) - 1  # one context encoding, then the decode steps
    assert counts["flash_attention_decode_fused"] == SMALL_LLAMA["num_hidden_layers"] * steps > 0
    assert p_counts["flash_attention_decode_fused"] == 0
    assert counts["kv_commit_rows"] == p_counts["kv_commit_rows"] == steps
    assert np.array_equal(np.asarray(toks), np.asarray(p_toks))
    err = max((a["logits"] - b["logits"]).abs().max().item() for a, b in zip(log, p_log))
    assert err <= 1e-3, err


# --- speculation: the fused window and Medusa windows as CUDA graphs ---

SPEC = dict(batch_size=2, seq_len=256, max_context_length=64)
SPEC_LEN = 3


def _spec_app(kind, graphs, params=None, **tc):
    """A 2-layer bf16 fused app (a 1-layer draft at the same widths, seed 1),
    or a Medusa app (3 random heads, ``tree``: MC_TREE), on the card."""
    from nxdi_tpu_torch.config import OnDeviceSamplingConfig, TorchConfig
    from nxdi_tpu_torch.models import dense
    from nxdi_tpu_torch.models.llama import modeling_llama as ml
    from nxdi_tpu_torch.speculation import FusedSpecCausalLM, MedusaCausalLM

    kw = dict(tp_degree=1, dtype="bfloat16", on_device_sampling_config=OnDeviceSamplingConfig(),
              attn_kernel_enabled=True, attn_tkg_kernel_enabled=True, **SPEC)
    kw.update(tc)

    def cfg(layers, **extra):
        return ml.LlamaInferenceConfig(TorchConfig(**kw, **extra),
                                       **dict(ml.LLAMA_3_2_1B, **dict(SMALL_LLAMA,
                                                                     num_hidden_layers=layers)))

    if kind == "fused":
        tcfg = cfg(2, speculation_length=SPEC_LEN, enable_fused_speculation=True)
        dcfg = cfg(1)
        if params is None:
            params = {"target": dense.random_params(ml.build_arch(tcfg), seed=0, device="cuda"),
                      "draft": dense.random_params(ml.build_arch(dcfg), seed=1, device="cuda")}

        class Fused(FusedSpecCausalLM):
            def build_params(self):
                return params

        app = Fused("<t>", tcfg, "<d>", dcfg, model_family=ml, graphs=graphs)
    else:
        tree = [[0], [1], [0, 0], [0, 1], [1, 0], [0, 0, 0]] if kind == "tree" else None
        tcfg = cfg(2, is_medusa=True, num_medusa_heads=3, medusa_tree=tree)
        if params is None:
            arch = ml.build_arch(tcfg)
            params = dense.random_params(arch, seed=0, device="cuda")
            g = torch.Generator(device="cuda").manual_seed(5)
            Hd, V = arch.hidden_size, arch.vocab_size
            params["medusa_heads"] = {
                k: (torch.randn(shape, generator=g, device="cuda") * 0.05).to(torch.bfloat16)
                for k, shape in (("res_w", (3, Hd, Hd)), ("res_b", (3, Hd)),
                                 ("head", (3, Hd, V)))}

        class Medusa(MedusaCausalLM):
            def build_params(self):
                return params

        app = Medusa("<t>", tcfg, model_family=ml, graphs=graphs)
    app.load()
    return app


def _spec_windows(app, n_windows=None, new=40):
    """generate() on the spec app: (tokens, per-window (tokens, counts)
    copies, launch counts by kernel)."""
    from nxdi_tpu_torch.generation.hf_adapter import HuggingFaceGenerationAdapter
    from nxdi_tpu_torch.ops.kernels import launch_counters

    for fn in launch_counters():
        fn.launches = 0
    log = []
    inner = app.forward

    def fwd(ids, pos, **k):
        out = inner(ids, pos, **k)
        if ids.shape[1] == 1:
            log.append((out["tokens"].clone(), out["counts"].clone()))
        return out

    app.forward = fwd
    ids = np.random.default_rng(9).integers(1, 512, (2, 40)).astype(np.int64)
    mask = np.ones_like(ids, dtype=np.int32)
    ids[1, 31:], mask[1, 31:] = 0, 0
    toks = HuggingFaceGenerationAdapter(app).generate(ids, attention_mask=mask,
                                                      max_new_tokens=new)
    torch.cuda.synchronize()
    del app.forward
    return toks, log, _counts()


def _flat(cache):
    return {k: v for k, v in cache.items()} if "draft" not in cache else {
        f"{m}.{k}": v for m in ("draft", "target") for k, v in cache[m].items()}


@pytest.mark.parametrize("kind", ["fused", "chain", "tree"])
def test_spec_window_graph_replay_equals_eager(gen, kind):
    """A speculation window replayed from its CUDA graph (the fused draft
    steps, verify and acceptance; a Medusa chain or tree window with its
    in-place proposal and K/V fix-up) against the same app run eagerly:
    the same tokens, every window's tokens and counts, the caches (and the
    proposal buffer) bit for bit after the run; the window ran as a graph."""
    graphs = _spec_app(kind, True)
    eager = _spec_app(kind, False, params=graphs.params)
    g_toks, g_log, g_counts = _spec_windows(graphs)
    e_toks, e_log, e_counts = _spec_windows(eager)
    assert np.array_equal(g_toks, e_toks)
    assert len(g_log) == len(e_log) > 1
    for (gt, gc), (et, ec) in zip(g_log, e_log):
        assert torch.equal(gt, et) and torch.equal(gc, ec)
    g_cache, e_cache = _flat(graphs.kv_cache), _flat(eager.kv_cache)
    for key in g_cache:
        assert torch.equal(g_cache[key], e_cache[key]), key
    assert g_counts == e_counts
    tag = "fused_speculation_model" if kind == "fused" else "medusa_speculation_model"
    assert all(bg.graph is not None for bg in graphs.models[tag].bucket_graphs.values())


def test_fused_window_launches_are_exact(gen):
    """Per fused window: (spec_len + 1) draft steps of L_d stacked fused
    decodes and one commit each, the verify's one commit, no prefill; the
    context encoding: L_t + L_d prefills, no commit (a slice write)."""
    app = _spec_app("fused", True)
    _, log, counts = _spec_windows(app, new=24)
    W = SPEC_LEN + 1
    n = len(log)
    assert counts["flash_attention_prefill"] == 2 + 1
    assert counts["flash_attention_decode_fused"] == W * 1 * n
    assert counts["kv_commit_rows"] == (W + 1) * n
    assert app.models["fused_speculation_model"].attention_strategies[256] == (
        "tkg_fused_kernel_stacked", "tkg_two_part_xla")


def test_medusa_tree_second_window_on_one_graph(gen):
    """Two tree windows back to back on one captured graph (the best-path
    K/V gather and scatter, and the proposal buffer, updated in place at
    fixed addresses): the second replay gives the eager app's tokens and
    counts, and the caches match bit for bit after each."""
    graphs = _spec_app("tree", True)
    eager = _spec_app("tree", False, params=graphs.params)
    prompt = np.random.default_rng(4).integers(1, 512, (2, 40)).astype(np.int32)
    pos = np.tile(np.arange(40, dtype=np.int32), (2, 1))
    lti = np.full((2,), 39, np.int32)
    outs = {}
    for name, app in (("graphs", graphs), ("eager", eager)):
        out = app.forward(prompt, pos, last_token_index=lti)
        tok = out["tokens"].cpu().numpy()
        cur = np.full((2, 1), 40, np.int32)
        steps = []
        for _ in range(2):
            out = app.forward(tok.astype(np.int32), cur, last_token_index=np.zeros(2, np.int32))
            t, c = out["tokens"].cpu().numpy(), out["counts"].cpu().numpy()
            steps.append((t.copy(), c.copy(), {k: v.clone() for k, v in _flat(app.kv_cache).items()}))
            tok = t[np.arange(2), c - 1][:, None]
            cur = cur + c[:, None]
        outs[name] = steps
    w = graphs.models["medusa_speculation_model"]
    assert w.bucket_graphs[256].graph is not None
    for (gt, gc, gcache), (et, ec, ecache) in zip(outs["graphs"], outs["eager"]):
        assert np.array_equal(gt, et) and np.array_equal(gc, ec)
        for key in gcache:
            assert torch.equal(gcache[key], ecache[key]), key


# --- EAGLE: the chain, EAGLE3 and both trees as CUDA graphs ---

EAGLE_KINDS = {
    "chain": {},
    "eagle3": {"is_eagle3": True},
    "tree": {"token_tree_config": {"choices": [[0], [1], [0, 0], [0, 1], [1, 0], [0, 0, 0]]}},
    "dynamic": {"token_tree_config": {"dynamic": {"steps": 3, "branching_factor": 2,
                                                  "num_inputs": 2}}},
}


def _eagle_app(kind, graphs, params=None, **draft_width):
    """A 2-layer bf16 target at SMALL_LLAMA's widths (seed 0) with a random
    1-layer EAGLE draft (seed 1; EAGLE3: a 256-token draft vocab;
    ``draft_width`` overrides its widths), spec_len 3, on the card."""
    from nxdi_tpu_torch.config import OnDeviceSamplingConfig, TorchConfig
    from nxdi_tpu_torch.models import dense
    from nxdi_tpu_torch.models import llama_eagle as le
    from nxdi_tpu_torch.models.llama import modeling_llama as ml
    from nxdi_tpu_torch.speculation import EagleSpecCausalLM

    kw = dict(tp_degree=1, dtype="bfloat16", on_device_sampling_config=OnDeviceSamplingConfig(),
              attn_kernel_enabled=True, attn_tkg_kernel_enabled=True, **SPEC)
    extra = EAGLE_KINDS[kind]
    eagle3 = extra.get("is_eagle3", False)
    width = dict(ml.LLAMA_3_2_1B, **SMALL_LLAMA)
    tcfg = ml.LlamaInferenceConfig(
        TorchConfig(**kw, speculation_length=SPEC_LEN, enable_eagle_speculation=True, **extra),
        **width)
    dcfg = le.LlamaEagleInferenceConfig(
        TorchConfig(**kw, is_eagle3=eagle3),
        **dict(width, num_hidden_layers=1, vocab_size=256 if eagle3 else width["vocab_size"],
               **draft_width))
    if params is None:
        target = dense.random_params(ml.build_arch(tcfg), seed=0, device="cuda")
        params = {"target": target,
                  "draft": le.random_params(dcfg, target, target_num_layers=2, seed=1,
                                            device="cuda")}

    class Eagle(EagleSpecCausalLM):
        def build_params(self):
            return params

    app = Eagle("<t>", tcfg, "<d>", dcfg, model_family=ml, graphs=graphs)
    app.load()
    return app


def _flat_all(cache, prefix=""):
    out = {}
    for k, v in cache.items():
        if isinstance(v, dict):
            out.update(_flat_all(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("kind", list(EAGLE_KINDS))
def test_eagle_window_graph_replay_equals_eager(gen, kind):
    """An EAGLE window replayed from its CUDA graph (chain: the draft steps
    on the stacked fused decode and the commit; the trees' masked passes,
    top-k, verify and best-path moves) against the same app run eagerly:
    the same tokens, every window's tokens and counts, both caches and the
    features buffer bit for bit; exact launches: L_t + L_d prefills per
    context encoding, per chain window W decodes and W + 1 commits, per
    tree window (depth + 1) + L_t + 2 commits and no decode."""
    graphs = _eagle_app(kind, True)
    eager = _eagle_app(kind, False, params=graphs.params)
    g_toks, g_log, g_counts = _spec_windows(graphs)
    e_toks, e_log, e_counts = _spec_windows(eager)
    assert np.array_equal(g_toks, e_toks)
    assert len(g_log) == len(e_log) > 1
    for (gt, gc), (et, ec) in zip(g_log, e_log):
        assert torch.equal(gt, et) and torch.equal(gc, ec)
    g_cache, e_cache = _flat_all(graphs.kv_cache), _flat_all(eager.kv_cache)
    assert "features" in g_cache
    for key in g_cache:
        assert torch.equal(g_cache[key], e_cache[key]), key
    n, W = len(g_log), SPEC_LEN + 1
    tree = kind in ("tree", "dynamic")
    want = {"flash_attention_prefill": 2 + 1,
            "flash_attention_decode_fused": 0 if tree else W * n,
            "kv_commit_rows": n * ((SPEC_LEN + 1) + 2 + 2) if tree else n * (W + 1)}
    for counts in (g_counts, e_counts):
        assert {k: counts.get(k, 0) for k in want} == want
    w = graphs.models["fused_speculation_model"]
    assert all(bg.graph is not None for bg in w.bucket_graphs.values())


def test_eagle_window_raises_where_the_decode_kernel_is_not_eligible(gen):
    """No fallback: a draft whose head dim (36) is not a multiple of 8 is
    not eligible for the attention kernels, whose flags are on (the stacked
    fused decode among them), so its first dispatch (the warmup's) raises
    naming the condition. (A draft whose 32 query heads share one kv head
    runs: the decode kernels take a group above 16 in head tiles.)"""
    with pytest.raises(NotImplementedError, match="head_dim 36 is not a multiple of 8"):
        _eagle_app("chain", True, num_attention_heads=32, num_key_value_heads=1, head_dim=36)


def test_eagle_replay_checks_the_features_buffer(gen):
    """A window graph replays only over the tensors it captured: with the
    features buffer moved to another address the next window raises."""
    app = _eagle_app("chain", True)
    _spec_windows(app, new=8)
    app.kv_cache["features"] = app.kv_cache["features"].clone()
    with pytest.raises(RuntimeError, match="another KV cache"):
        _spec_windows(app, new=8)


@pytest.mark.parametrize("lines", [False, True])
def test_best_path_move_on_both_caches(gen, lines):
    """The shared best-path move on the card (a gather, landed by the commit
    kernel) against its plain version on the CPU, on a target-shaped
    (2 layers) and a draft-shaped (1 layer) bf16 cache: the same bits,
    sources past the cache clipped, destinations past it dropped."""
    from nxdi_tpu_torch.speculation import token_tree as tt

    src = torch.tensor([[3, 300, 7, 9], [100, 101, 102, 103]], device="cuda")
    dest = torch.tensor([[1, 2, 3, 4], [254, 255, 256, 257]], device="cuda")
    ln = torch.tensor([2, 0], device="cuda") if lines else None
    for L in (2, 1):
        cache = {k: _randn(gen, L, 3, 2, 256, 64).to(torch.bfloat16) for k in ("k", "v")}
        plain = {k: v.cpu() for k, v in cache.items()}
        tt.move_path_rows(cache, src, dest, ln)
        tt.move_path_rows(plain, src.cpu(), dest.cpu(), None if ln is None else ln.cpu())
        for k in cache:
            assert torch.equal(cache[k].cpu(), plain[k]), (L, k)


# --- mixture-of-experts and LoRA on the card ---

@pytest.mark.parametrize("case", ["E8K2", "E16K4"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_moe_block_grouped_product_on_the_card(gen, dtype, case):
    """moe_block's sparse dispatch on the card (bf16: torch._grouped_mm over
    the scatter-add offsets; f32: the per-expert product; E16K4 leaves some
    experts without rows) and its dense dispatch, each against the float32
    dense dispatch on the CPU over the same weights (bf16 within 6e-2, a few
    ulp of outputs ~1-3; f32 within 1e-4), and the sparse dispatch replayed
    from a CUDA graph equal to eager bit for bit."""
    from nxdi_tpu_torch.ops import moe

    E, K = (8, 2) if case == "E8K2" else (16, 4)
    H, I, T = 256, 512, 24
    p = {"router": {"w": _randn(gen, H, E) * 0.05},
         "experts": {"gate_proj": {"w": _randn(gen, E, H, I) * 0.05},
                     "up_proj": {"w": _randn(gen, E, H, I) * 0.05},
                     "down_proj": {"w": _randn(gen, E, I, H) * 0.05}}}
    p = {k: {kk: {"w": vv["w"].to(dtype)} if isinstance(vv, dict) else vv.to(dtype)
             for kk, vv in v.items()} for k, v in p.items()}
    x = _randn(gen, 2, T // 2, H).to(dtype)
    sparse = moe.MoEArch(num_experts=E, top_k=K, intermediate_size=I)
    dense = dataclasses.replace(sparse, dispatch="dense")
    want_product = "grouped_mm" if dtype == torch.bfloat16 else "per_expert"
    assert moe.moe_strategy(sparse, x) == f"moe_sparse_{want_product}"

    def cpu32(tree):
        return {k: cpu32(v) if isinstance(v, dict) else v.float().cpu() for k, v in tree.items()}

    ref = moe.moe_block(None, dense, cpu32(p), x.float().cpu())
    tol = 6e-2 if dtype == torch.bfloat16 else 1e-4
    got = moe.moe_block(None, sparse, p, x)
    for out in (got, moe.moe_block(None, dense, p, x)):
        assert (out.float().cpu() - ref).abs().max().item() <= tol
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        g_out = moe.moe_block(None, sparse, p, x)
    graph.replay()
    assert torch.equal(g_out, got)


SMALL_MIXTRAL = dict(hidden_size=256, intermediate_size=512, num_attention_heads=8,
                     num_key_value_heads=2, head_dim=128, vocab_size=512, num_hidden_layers=2,
                     num_local_experts=8, num_experts_per_tok=2, rope_theta=1e6,
                     rms_norm_eps=1e-5, sliding_window=None)


def _mixtral_app(graphs, params=None, **tc):
    from nxdi_tpu_torch.config import OnDeviceSamplingConfig, TorchConfig
    from nxdi_tpu_torch.models import dense
    from nxdi_tpu_torch.models.mixtral import modeling_mixtral as mx
    from nxdi_tpu_torch.runtime.application import TorchModelForCausalLM

    kw = dict(tp_degree=1, dtype="bfloat16", on_device_sampling_config=OnDeviceSamplingConfig(),
              attn_kernel_enabled=True, attn_tkg_kernel_enabled=True, output_logits=True)
    kw.update(tc)
    cfg = mx.MixtralInferenceConfig(TorchConfig(**kw), **SMALL_MIXTRAL)
    arch = mx.build_arch(cfg)

    class App(TorchModelForCausalLM):
        def build_params(self):
            return params if params is not None else dense.random_params(arch, seed=0,
                                                                         device="cuda")

    app = App("<random>", cfg, model_family=mx, graphs=graphs)
    app.load()
    return app


@pytest.mark.parametrize("dispatch", ["sparse", "dense"])
def test_moe_app_graph_replay_equals_eager(gen, dispatch):
    """A 2-layer bf16 Mixtral-shaped app (D 128, 4 query heads per kv head)
    through generate(): every dispatch replayed from its graph equals the
    eager app's bit for bit, the launches are the same, and every
    token-generation bucket recorded the MoE product it ran (the grouped
    GEMM inside the graphs in sparse dispatch)."""
    app = _mixtral_app(True, **STATIC, moe_dispatch=dispatch)
    eager = _mixtral_app(False, params=app.params, **STATIC, moe_dispatch=dispatch)
    log, counts, toks = _drive(app, "static")
    e_log, e_counts, e_toks = _drive(eager, "static")
    assert counts == e_counts and counts["flash_attention_decode_fused"] > 0
    assert np.array_equal(np.asarray(toks), np.asarray(e_toks))
    for a, b in zip(log, e_log):
        assert torch.equal(a["logits"], b["logits"])
    want = "moe_dense" if dispatch == "dense" else "moe_sparse_grouped_mm"
    strategies = app.models["token_generation_model"].attention_strategies
    assert strategies and all(want in s for s in strategies.values())
    assert all(bg.graph is not None for bg in app.models["token_generation_model"]
               .bucket_graphs.values())


LORA = dict(max_loras=1, max_lora_rank=8, lora_dtype="bfloat16", lora_alpha=16.0,
            target_modules=["q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
                            "down_proj"])


def _adapter(seed, std=0.05):
    """A random PEFT adapter for SMALL_LLAMA (rank 8, every projection)."""
    g = torch.Generator().manual_seed(seed)
    hs, inter, q, kv = 256, 512, 4 * 64, 2 * 64
    dims = {"q_proj": (hs, q), "k_proj": (hs, kv), "v_proj": (hs, kv), "o_proj": (q, hs),
            "gate_proj": (hs, inter), "up_proj": (hs, inter), "down_proj": (inter, hs)}
    sd = {}
    for i in range(SMALL_LLAMA["num_hidden_layers"]):
        for m, (fin, fout) in dims.items():
            scope = "mlp" if m.endswith(("gate_proj", "up_proj", "down_proj")) else "self_attn"
            pre = f"base_model.model.model.layers.{i}.{scope}.{m}"
            sd[pre + ".lora_A.weight"] = torch.randn(8, fin, generator=g) * std
            sd[pre + ".lora_B.weight"] = torch.randn(fout, 8, generator=g) * std
    return sd


def test_lora_swap_after_capture_is_seen_by_the_next_replay(gen):
    """An adapter written into its slot after the graphs were captured (the
    LRU evicting the first one into the same slot, in place) is what the
    next replays read: the tokens and logits equal the eager app's with the
    same swap, bit for bit, and differ from before the swap; the buffers
    keep their addresses and no graph is captured again."""
    from nxdi_tpu_torch.generation.hf_adapter import HuggingFaceGenerationAdapter
    from nxdi_tpu_torch.lora import lora_pointers

    apps = [_card_app(True, **STATIC, lora_config=LORA)]
    apps.append(_card_app(False, params=apps[0].params, **STATIC, lora_config=LORA))
    ids = np.random.default_rng(3).integers(1, 512, (2, 40)).astype(np.int64)
    outs = {}
    for name, seed in (("a", 1), ("b", 2)):
        for app in apps:
            assert app.set_lora_adapter(name, _adapter(seed), {"r": 8, "lora_alpha": 16.0}) == 1
        ptrs = lora_pointers(apps[0].params)
        graphs = {k: id(bg.graph) for k, bg in apps[0].models["token_generation_model"]
                  .bucket_graphs.items()}
        logs = [_logged(app) for app in apps]
        toks = [HuggingFaceGenerationAdapter(app).generate(ids, max_new_tokens=24,
                                                           adapter_ids=np.array([1, 0]))
                for app in apps]
        for app in apps:
            del app.forward
        assert np.array_equal(toks[0], toks[1])
        assert all(torch.equal(a["logits"], b["logits"]) for a, b in zip(*logs))
        assert lora_pointers(apps[0].params) == ptrs
        if name == "b":  # replays of the graphs captured while a was resident
            assert graphs == {k: id(bg.graph) for k, bg in apps[0].models[
                "token_generation_model"].bucket_graphs.items()}
        outs[name] = (toks[0], logs[0][0]["logits"])
    assert (outs["a"][1][0] - outs["b"][1][0]).abs().max().item() > 1e-2  # row 0: the adapter
    assert torch.equal(outs["a"][1][1], outs["b"][1][1])  # row 1: the base slot


def test_lora_replay_checks_the_buffers(gen):
    """A graph replays only over the LoRA buffers it captured: a buffer
    rebound to a new tensor makes the next replay raise."""
    from nxdi_tpu_torch.generation.hf_adapter import HuggingFaceGenerationAdapter

    app = _card_app(True, **STATIC, lora_config=LORA)
    ids = np.random.default_rng(3).integers(1, 512, (2, 40)).astype(np.int64)
    HuggingFaceGenerationAdapter(app).generate(ids, max_new_tokens=4)
    q = app.params["layers"]["attn"]["q_proj"]
    q["lora_A"] = q["lora_A"].clone()
    with pytest.raises(RuntimeError, match="other LoRA buffers"):
        HuggingFaceGenerationAdapter(app).generate(ids, max_new_tokens=4)


# ---------------------------------------------------------------------------
# Head dim 256 (Gemma), live sliding windows in captured graphs (Mistral),
# the tanh GELU at Gemma-2B's MLP
# ---------------------------------------------------------------------------

D256_TOL = {torch.float32: TOL, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("window", [None, 100])
@pytest.mark.parametrize("G", [1, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prefill_at_head_dim_256(gen, dtype, G, window):
    """Row 1 at head dim 256 (bf16: the mma.sync body reading Q's fragments
    from shared memory; f32: the CUDA-core body at 8 columns a lane) against
    the plain version: ragged edges (300 positions, not whole 64-row tiles),
    an offset start, with and without a window; a second call gives the
    same bits."""
    B, KV, S, D = 2, 1, 300, 256
    q = _randn(gen, B, S, KV * G, D).to(dtype).transpose(1, 2)
    k, v = (_randn(gen, B, S, KV, D).to(dtype).transpose(1, 2) for _ in range(2))
    pos = (torch.arange(S, dtype=torch.int32)[None] + torch.tensor([[0], [37]],
                                                                   dtype=torch.int32)).cuda()
    if dtype == torch.bfloat16:
        assert fa.prefill_body(q, k, v) == "mma"
    before = fa.flash_attention_prefill.launches
    got = fa.flash_attention_prefill(q, k, v, pos, pos, sliding_window=window)
    assert fa.flash_attention_prefill.launches == before + 1
    want = fa.flash_attention_prefill_plain(q, k, v, pos, pos, sliding_window=window)
    assert _max_err(got, want) <= D256_TOL[dtype]
    assert torch.equal(fa.flash_attention_prefill(q, k, v, pos, pos, sliding_window=window), got)


@pytest.mark.parametrize("mode,mask", [("fused", None), ("fused", "window"), ("window", None),
                                       ("window", "window"), ("paged", None)])
@pytest.mark.parametrize("G", [1, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_at_head_dim_256(gen, monkeypatch, mode, mask, G, dtype):
    """Rows 2/3 (fused), 5 (window) and 7 (paged) at head dim 256, split
    across blocks (6 chunks) and with one chunk a row, against the plain
    version: bf16 on the tensor-core tile (2 warps a block), f32 on the CUDA
    cores (1 warp), with and without a window; a second call gives the same
    bits."""
    call, plain = _decode_call(mode, gen, dtype, G, 256, mask)
    want = plain()
    got = call()
    assert _max_err(got, want) <= D256_TOL[dtype]
    assert torch.equal(call(), got)
    monkeypatch.setattr(fa, "decode_chunk", _one_chunk)
    assert _max_err(call(), want) <= D256_TOL[dtype]


def test_paged_kernels_refuse_head_dim_above_256(gen):
    """Rows 6, 7 and 8 take head dims up to 256 on the card, over a bf16
    pool and a one-byte store; 264 raises, naming the limit."""
    q = _randn(gen, 1, 2, 8, 264)
    pool = _randn(gen, 64, 1, 264)
    bt = torch.zeros((1, 4), dtype=torch.int32)
    pos = torch.arange(8, dtype=torch.int32)[None]
    with pytest.raises(ValueError, match="up to 256"):
        fa.paged_attention_prefill(q, pool, pool, bt, pos, block_size=16)
    with pytest.raises(ValueError, match="up to 256"):
        rpa.ragged_paged_attention(q, pool, pool, bt, torch.zeros(8, dtype=torch.int32),
                                   pos[0], block_size=16)
    one = pool.to(torch.float8_e4m3fn)
    with pytest.raises(ValueError, match="up to 256"):
        fa.paged_attention_decode(q[:, :, :1].to(torch.bfloat16), one, one, bt, pos[:, :1],
                                  block_size=16)


# Gemma-2B's attention: 8 query heads over 1 kv head of 256
GEMMA_H, GEMMA_KV, GEMMA_D = 8, 1, 256


def _pool_256(gen, store, dtype, n):
    """(k, v) pools of n slots at Gemma-2B's kv width: q's dtype, or a
    one-byte store."""
    if store is None:
        return tuple(_randn(gen, n, GEMMA_KV, GEMMA_D).to(dtype) for _ in range(2))
    return tuple(_one_byte(gen, store, n, GEMMA_KV, GEMMA_D) for _ in range(2))


@pytest.mark.parametrize("bs", [16, 128])
@pytest.mark.parametrize("store", [None] + list(ONE_BYTE))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_prefill_at_head_dim_256(gen, dtype, store, bs):
    """Row 6 at head dim 256 (bf16: the mma.sync body reading Q from shared
    memory, tiles through the block table; f32: the CUDA-core body at 8
    columns a lane), over a bf16 / f32 pool and each one-byte store (row
    6'): a 300-token chunk after a 260-token prefix with a hole, and one
    from 0, against the plain version; the same bits on a second call; the
    body that ran by name. With bf16 q over a one-byte pool the output
    equals the bf16 pool's kernel on the up-cast pool bit for bit (the
    tiles convert exactly as they land)."""
    B, Sq = 2, 300
    NB = 640 // bs
    bt = torch.randperm(2 * NB, generator=torch.Generator().manual_seed(5)).reshape(2, NB)
    bt = bt.to(torch.int32)
    bt[0, 40 // bs] = -1
    kc_, vc_ = _pool_256(gen, store, dtype, 2 * NB * bs)
    q = _randn(gen, B, Sq, GEMMA_H, GEMMA_D).to(dtype).transpose(1, 2)
    qp = (torch.tensor([[260], [0]], dtype=torch.int32) + torch.arange(Sq, dtype=torch.int32))
    qp = qp.cuda()
    kw = dict(block_size=bs, **(ONE_BYTE_SCALES[store] if store else {}))
    body = fa.paged_prefill_body(q, kc_, vc_, bs)
    assert body == ("mma" if dtype == torch.bfloat16 else "simt")
    before = fa.paged_attention_prefill.launches
    got = fa.paged_attention_prefill(q, kc_, vc_, bt, qp, **kw)
    assert fa.paged_attention_prefill.launches == before + 1
    want = fa.paged_attention_prefill_plain(q, kc_, vc_, bt.cuda(), qp, **kw)
    tol = ONE_BYTE_TOL[dtype] if store else D256_TOL[dtype]
    assert _max_err(got, want) <= tol
    assert torch.equal(fa.paged_attention_prefill(q, kc_, vc_, bt, qp, **kw), got)
    names = _kernel_names(lambda: fa.paged_attention_prefill(q, kc_, vc_, bt, qp, **kw))
    assert [n for n in names if "prefill" in n] == [
        "prefill_tc_kernel" if dtype == torch.bfloat16 else "prefill_kernel"]
    if store and dtype == torch.bfloat16:
        up = fa.paged_attention_prefill(q, kc_.to(dtype), vc_.to(dtype), bt, qp, **kw)
        assert torch.equal(got, up)


@pytest.mark.parametrize("bs", [16, 128])
@pytest.mark.parametrize("store", list(ONE_BYTE))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_one_byte_paged_decode_at_head_dim_256(gen, dtype, store, bs):
    """Row 7' at head dim 256: the paged decode over a one-byte pool, 768
    positions split in chunks, a table of holes only, a hole mid-range, a
    row at 0; against the plain version, the same bits on a second call,
    the split and combine kernels launched; with bf16 q (2 warps a block on
    the tensor cores, raw tiles converted in shared memory) equal bit for
    bit to the bf16 pool's kernel on the up-cast pool. Run alone, every
    case traces both kernels by name; late in the whole file's run the
    card's profiler has dropped the split kernel's records, so the names
    are held as a subset that holds the combine."""
    B = 4
    NB = 768 // bs
    kc_, vc_ = _pool_256(gen, store, dtype, B * NB * bs)
    bt = torch.randperm(B * NB, generator=torch.Generator().manual_seed(3)).reshape(B, NB)
    bt = bt.to(torch.int32)
    bt[1, :] = -1
    bt[2, 112 // bs] = -1
    btc = bt.cuda()
    q = _randn(gen, B, 1, GEMMA_H, GEMMA_D).to(dtype).transpose(1, 2)
    qp = torch.tensor([[767], [300], [384], [0]], dtype=torch.int32).cuda()
    kw = dict(block_size=bs, **ONE_BYTE_SCALES[store])
    before = fa.paged_attention_decode.launches
    got = fa.paged_attention_decode(q, kc_, vc_, btc, qp, **kw)
    assert fa.paged_attention_decode.launches == before + 1
    want = fa.paged_attention_decode_plain(q, kc_, vc_, btc, qp, **kw)
    assert _max_err(got, want) <= ONE_BYTE_TOL[dtype]
    assert torch.all(got[1] == 0)
    assert torch.equal(fa.paged_attention_decode(q, kc_, vc_, btc, qp, **kw), got)
    # the combine launches only after the split (C > 1)
    names = _kernel_names(lambda: fa.paged_attention_decode(q, kc_, vc_, btc, qp, **kw))
    assert "decode_combine_kernel" in names
    assert set(names) <= {"decode_combine_kernel", "decode_split_kernel"}
    if dtype == torch.bfloat16:
        up = fa.paged_attention_decode(q, kc_.to(dtype), vc_.to(dtype), btc, qp, **kw)
        assert torch.equal(got, up)


@pytest.mark.parametrize("store", [None] + list(ONE_BYTE))
@pytest.mark.parametrize("stream", ["decode8", "chunk_and_long_decode"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ragged_at_head_dim_256(gen, dtype, stream, store):
    """Row 8 at head dim 256 (Gemma-2B's heads) over a bf16 / f32 pool and
    each one-byte store (row 8'): direct tiles on the mma.sync or CUDA-core
    body, split items at 2 warps a block (bf16) or on the CUDA cores (f32),
    the combine over 256 columns, and no wgmma items; against the plain
    version, padding exactly 0, the same bits on a second call; the
    graph-ready launch, eager and replayed from a CUDA graph, equal to the
    per-call launch. With bf16 q over a one-byte pool the split items'
    tokens equal the bf16 pool's kernels on the up-cast pool bit for bit."""
    T, rows = RAGGED_STREAMS[stream]
    bs, NB = 128, 16
    R = max(s for s, _, _ in rows) + 1
    bt, rid, qp = _ragged_stream(rows, T, R, NB, bs, gen)
    kc_, vc_ = _pool_256(gen, store, dtype, R * NB * bs)
    q = _randn(gen, 1, T, GEMMA_H, GEMMA_D).to(dtype).transpose(1, 2)
    assert rpa.ragged_direct_body(dtype, kc_.dtype, GEMMA_D, bs) == (
        "mma" if dtype == torch.bfloat16 else "simt")
    plan = rpa.ragged_plan(rid, qp, R, NB * bs, GEMMA_KV)
    assert plan.n_items > 0 and plan.n_wg == 0
    kw = dict(block_size=bs, **(ONE_BYTE_SCALES[store] if store else {}))
    before = rpa.ragged_paged_attention.launches
    got = rpa.ragged_paged_attention(q, kc_, vc_, bt, rid, qp, plan=plan, **kw)
    assert rpa.ragged_paged_attention.launches == before + 1
    want = rpa.ragged_paged_attention_plain(q, kc_, vc_, bt, rid, qp, **kw)
    tol = ONE_BYTE_TOL[dtype] if store else D256_TOL[dtype]
    assert _max_err(got, want) <= tol
    assert torch.all(got[:, :, torch.from_numpy(rid < 0).cuda()] == 0)
    assert torch.equal(rpa.ragged_paged_attention(q, kc_, vc_, bt, rid, qp, plan=plan, **kw), got)
    if store and dtype == torch.bfloat16:
        toks = torch.from_numpy(np.unique(plan.items()[:, 0])).cuda()
        up = rpa.ragged_paged_attention(q, kc_.to(dtype), vc_.to(dtype), bt, rid, qp, plan=plan,
                                        **kw)
        assert torch.equal(got[:, :, toks], up[:, :, toks])
    btc, ridc, qpc = (torch.from_numpy(x).cuda() for x in (bt, rid, qp))
    cap = rpa.ragged_capacity(T, R, NB * bs, GEMMA_KV)
    static = dataclasses.replace(cap, flat=torch.from_numpy(rpa.pad_plan(plan, cap)).cuda())
    assert torch.equal(rpa.ragged_paged_attention(q, kc_, vc_, btc, ridc, qpc, plan=static,
                                                  **kw), got)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = rpa.ragged_paged_attention(q, kc_, vc_, btc, ridc, qpc, plan=static, **kw)
    out.zero_()
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, got)


@pytest.mark.parametrize("M", [8, 520])
def test_fused_mlp_tanh_gelu_at_gemma_2b_widths(gen, M):
    """Rows 9/10 with gelu_pytorch_tanh at Gemma-2B's MLP (H 2048, I 16384),
    bf16, the stacked entry at layer 1, against the plain version (GEMM_TOL,
    as the Llama widths' test)."""
    H, I = 2048, 16384
    x = _bf(gen, 1.0, M, H)
    g, u = _bf(gen, 0.02, 2, H, I), _bf(gen, 0.02, 2, H, I)
    d = _bf(gen, 0.02, 2, I, H)
    before = fp.fused_mlp.launches
    got = fp.fused_mlp_stacked(x, g, u, d, 1, act="gelu_pytorch_tanh")
    assert fp.fused_mlp.launches == before + 1
    want = fp.fused_mlp_plain(x, g[1], u[1], d[1], "gelu_pytorch_tanh")
    assert _max_err(got, want) <= GEMM_TOL
    assert torch.equal(fp.fused_mlp_stacked(x, g, u, d, 1, act="gelu_pytorch_tanh"), got)


def _family_card_app(family, widths, graphs, params=None, **tc):
    """A bf16 app of ``family`` at ``widths`` (random weights from seed 0)
    with the attention kernels on."""
    from nxdi_tpu_torch.config import OnDeviceSamplingConfig, TorchConfig
    from nxdi_tpu_torch.models import dense
    from nxdi_tpu_torch.runtime.application import TorchModelForCausalLM

    kw = dict(tp_degree=1, dtype="bfloat16", on_device_sampling_config=OnDeviceSamplingConfig(),
              attn_kernel_enabled=True, attn_tkg_kernel_enabled=True, output_logits=True)
    kw.update(tc)
    # the family's own config class, not the base class it imports
    cfg_cls = next(v for k, v in vars(family).items()
                   if k.endswith("InferenceConfig") and v.__module__ == family.__name__)
    cfg = cfg_cls(TorchConfig(**kw), **widths)
    arch = family.build_arch(cfg)

    class App(TorchModelForCausalLM):
        def build_params(self):
            if params is not None:
                return params
            if hasattr(family, "random_params"):  # the families with per-layer flags
                return family.random_params(cfg, seed=0, device="cuda")
            return dense.random_params(arch, seed=0, device="cuda")

    app = App("<random>", cfg, model_family=family, graphs=graphs)
    app.load()
    return app


def _family_widths(name):
    from nxdi_tpu_torch.models.gemma import modeling_gemma as tg
    from nxdi_tpu_torch.models.mistral import modeling_mistral as tm

    if name == "mistral":  # a live window of 16 under 40-token prompts
        return tm, dict(tm.MISTRAL_7B_V01, hidden_size=256, intermediate_size=512,
                        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                        head_dim=64, vocab_size=512, sliding_window=16)
    return tg, dict(tg.GEMMA_2B, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
                    num_attention_heads=8, num_key_value_heads=1, head_dim=256, vocab_size=512)


@pytest.mark.parametrize("name", ["mistral", "gemma"])
def test_family_graph_replay_equals_eager(gen, name):
    """Rows 1, 3 and 4 with a live window (Mistral) and at head dim 256
    (Gemma, G 8, with the fused MLP's tanh GELU) inside captured graphs:
    every dispatch bit for bit against an eager app on the same params, the
    same launch counts, every bucket a graph."""
    family, widths = _family_widths(name)
    tc = dict(STATIC)
    if name == "gemma":
        tc.update(mlp_kernel_enabled=True)
    graphs = _family_card_app(family, widths, True, **tc)
    eager = _family_card_app(family, widths, False, params=graphs.params, **tc)
    g_log, g_counts, g_toks = _drive(graphs, "static")
    e_log, e_counts, e_toks = _drive(eager, "static")
    assert np.array_equal(np.asarray(g_toks), np.asarray(e_toks))
    assert len(g_log) == len(e_log) > 0
    for i, (a, b) in enumerate(zip(g_log, e_log)):
        for key in a:
            assert torch.equal(a[key], b[key]), (i, key)
    assert g_counts == e_counts
    for kernel in ("flash_attention_prefill", "flash_attention_decode_fused", "kv_commit_rows"):
        assert g_counts[kernel] > 0, kernel
    if name == "gemma":
        assert g_counts["fused_mlp"] > 0
    for w in graphs.models.values():
        assert all(bg.graph is not None for bg in w.bucket_graphs.values())


RING_TOL = {torch.float32: TOL, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("window", [None, 600])
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("mode", ["fused", "window"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_decode_modes_match_plain(gen, monkeypatch, dtype, mode, D, window):
    """Rows 3 (the stacked fused decode, layer 1 of a ring stack) and 5 (the
    window decode) in ring mode over a 1000-slot ring (8 chunks at B 4, KV
    2, G 4): rows wrapped twice, at the ring's last slot, before the ring
    fills and at position 0, with and without a window inside the ring;
    split across blocks and one chunk a row, against the plain version; a
    second call gives the same bits; one launch counted."""
    B, KV, G, W = 4, 2, 4, 1000
    H = KV * G

    def r(*shape):
        return _randn(gen, *shape).to(dtype)

    q = r(B, 1, H, D).transpose(1, 2)
    kn, vn = r(B, 1, KV, D).transpose(1, 2), r(B, 1, KV, D).transpose(1, 2)
    ks, vs = r(2, B, KV, W, D), r(2, B, KV, W, D)
    qp = torch.tensor([[2537], [999], [300], [0]], dtype=torch.int32).cuda()
    kv_pos = torch.zeros((B, W), dtype=torch.int32, device="cuda")  # unread on a ring
    if mode == "fused":
        def call():
            return fa.flash_attention_decode_fused_stacked(q, ks, vs, kn, vn, qp, 1,
                                                           sliding_window=window, ring=W)
        want = fa.flash_attention_decode_fused_plain(q, ks[1], vs[1], kn, vn, qp,
                                                     sliding_window=window, ring=W)
        counter = fa.flash_attention_decode_fused
    else:
        def call():
            return fa.flash_attention_decode(q, ks[1], vs[1], qp, kv_pos, sliding_window=window,
                                             ring=W)
        want = fa.flash_attention_decode_plain(q, ks[1], vs[1], qp, kv_pos,
                                               sliding_window=window, ring=W)
        counter = fa.flash_attention_decode
    before = counter.launches
    got = call()
    assert counter.launches == before + 1
    assert _max_err(got, want) <= RING_TOL[dtype]
    assert torch.equal(call(), got)
    monkeypatch.setattr(fa, "decode_chunk", _one_chunk)
    assert _max_err(call(), want) <= RING_TOL[dtype]


@pytest.mark.parametrize("routed", [False, True])
def test_ring_writes_land_at_slot_mod_w(gen, routed):
    """Row 4 into the ring (kvcache WindowKVLayout): a 40-token prefill over
    a 24-slot ring (only each row's last 24 real tokens; row 1's padding
    lanes dropped) and a deferred commit of 3 layers' rows at p % W (a -1
    write position drops), on the card bit for bit against the plain
    version on the CPU, lines routed by seq_ids or not; one launch each."""
    from nxdi_tpu_torch.kvcache.kv_cache import KVCacheSpec, WindowKVLayout

    L, Bc, KV, W, D, S = 3, 4, 2, 24, 64, 40
    lay = WindowKVLayout(window=W, route_by_seq_id=routed)
    spec = KVCacheSpec(L, Bc, KV, W, D, dtype="bfloat16")
    cache = {k: _bf(gen, 1.0, L, Bc, KV, W, D) for k in ("k", "v")}
    ref = {k: t.cpu().clone() for k, t in cache.items()}
    kn, vn = _bf(gen, 1.0, 2, KV, S, D), _bf(gen, 1.0, 2, KV, S, D)
    ci = {"position_ids": torch.arange(S, dtype=torch.int32)[None].repeat(2, 1),
          "last_token_index": torch.tensor([S - 1, 17], dtype=torch.int32)}
    if routed:
        ci["seq_ids"] = torch.tensor([3, 1], dtype=torch.int32)
    before = kc.kv_commit_rows.launches
    lay.update(cache["k"][1], cache["v"][1], kn, vn, {k: v.cuda() for k, v in ci.items()}, spec)
    assert kc.kv_commit_rows.launches == before + 1
    lay.update(ref["k"][1], ref["v"][1], kn.cpu(), vn.cpu(), ci, spec)
    kr, vr = _bf(gen, 1.0, L, 2, KV, 1, D), _bf(gen, 1.0, L, 2, KV, 1, D)
    cc = {"position_ids": torch.tensor([[61], [17]], dtype=torch.int32),
          "write_positions": torch.tensor([[61], [-1]], dtype=torch.int32),
          **({"seq_ids": ci["seq_ids"]} if routed else {})}
    lay.commit_rows(cache, kr, vr, {k: v.cuda() for k, v in cc.items()}, spec)
    lay.commit_rows(ref, kr.cpu(), vr.cpu(), cc, spec)
    for k in ("k", "v"):
        assert torch.equal(cache[k].cpu(), ref[k]), k
    line = 3 if routed else 0
    assert torch.equal(cache["k"][:, line, :, 61 % W].cpu(), kr[:, 0, :, 0].cpu())


def _ring_widths(name):
    from nxdi_tpu_torch.models.gemma3 import modeling_gemma3 as tg3

    if name == "mistral":
        return _family_widths("mistral")
    return tg3, dict(tg3.GEMMA_3_27B, hidden_size=256, intermediate_size=512,
                     num_hidden_layers=2, sliding_window_pattern=2, num_attention_heads=4,
                     num_key_value_heads=2, head_dim=64, vocab_size=512, sliding_window=16,
                     query_pre_attn_scalar=64)


@pytest.mark.parametrize("name", ["mistral", "gemma3_text"])
def test_ring_graph_replay_equals_eager(gen, name):
    """The ring inside captured graphs, 120 tokens past 40-token prompts
    over a 16-slot ring: Mistral's homogeneous ring (row 4 per layer, row
    5's ring mode) and Gemma-3's interleaved one (row 3's ring mode over the
    ring stack beside the full one, the ring's commit): every dispatch bit
    for bit against an eager app on the same params, the same launch
    counts, every bucket a graph."""
    family, widths = _ring_widths(name)
    tc = dict(STATIC, window_sized_kv=True, sliding_window=16)
    graphs = _family_card_app(family, widths, True, **tc)
    eager = _family_card_app(family, widths, False, params=graphs.params, **tc)
    assert graphs.kv_cache["k" if name == "mistral" else "k_win"].shape[3] == 16
    g_log, g_counts, g_toks = _drive(graphs, "static")
    e_log, e_counts, e_toks = _drive(eager, "static")
    assert np.array_equal(np.asarray(g_toks), np.asarray(e_toks))
    assert len(g_log) == len(e_log) > 0
    for i, (a, b) in enumerate(zip(g_log, e_log)):
        for key in a:
            assert torch.equal(a[key], b[key]), (i, key)
    assert g_counts == e_counts
    ring_kernel = ("flash_attention_decode" if name == "mistral"
                   else "flash_attention_decode_fused")
    for kernel in ("flash_attention_prefill", ring_kernel, "kv_commit_rows"):
        assert g_counts[kernel] > 0, kernel
    for w in graphs.models.values():
        assert all(bg.graph is not None for bg in w.bucket_graphs.values())


def test_ring_kernel_refusals(gen):
    """On the card an attention kernel flag on a softcapped model raises,
    naming the softcap, and a ring operand over a cache of another slot
    count raises."""
    from nxdi_tpu_torch.models.gemma2 import modeling_gemma2 as tg2

    widths = dict(tg2.GEMMA_2_9B, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
                  num_attention_heads=4, num_key_value_heads=2, head_dim=64, vocab_size=512)
    with pytest.raises(NotImplementedError, match="attention logit softcap"):
        _family_card_app(tg2, widths, False, **STATIC)  # its warmup runs the forward
    q = _randn(gen, 1, 2, 1, 64)
    k = _randn(gen, 1, 1, 32, 64)
    with pytest.raises(ValueError, match="a ring of 16 slots over a cache of 32"):
        fa.flash_attention_decode(q, k, k, torch.zeros((1, 1), dtype=torch.int32),
                                  torch.zeros((1, 32), dtype=torch.int32), ring=16)


CHUNK_TOL = {torch.float32: TOL, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prefill_chunk_mode_at_group_5(gen, dtype, D):
    """Row 1 in chunk mode at Llama-4-Scout's group (40 over 8 heads: G 5,
    here 10 over 2) against the plain version: 300 positions under chunks of
    128, one row from 0 and one from 37 (so a chunk boundary cuts a 128-row
    q tile); bf16 runs the wgmma body; a second call gives the same bits."""
    B, KV, S = 2, 2, 300
    q = _randn(gen, B, S, 5 * KV, D).to(dtype).transpose(1, 2)
    k, v = (_randn(gen, B, S, KV, D).to(dtype).transpose(1, 2) for _ in range(2))
    pos = (torch.arange(S, dtype=torch.int32)[None] + torch.tensor([[0], [37]],
                                                                   dtype=torch.int32)).cuda()
    if dtype == torch.bfloat16:
        assert fa.prefill_body(q, k, v) == "wgmma"
    before = fa.flash_attention_prefill.launches
    got = fa.flash_attention_prefill(q, k, v, pos, pos, chunk_size=128)
    assert fa.flash_attention_prefill.launches == before + 1
    want = fa.flash_attention_prefill_plain(q, k, v, pos, pos, chunk_size=128)
    assert _max_err(got, want) <= CHUNK_TOL[dtype]
    assert _max_err(fa.flash_attention_prefill_plain(q, k, v, pos, pos), want) > 1e-2
    assert torch.equal(fa.flash_attention_prefill(q, k, v, pos, pos, chunk_size=128), got)


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stacked_decode_chunk_mode_at_group_5(gen, monkeypatch, dtype, D):
    """Row 3 (the stacked fused decode, layer 1 of 3) in chunk mode at G 5
    over 700 slots under chunks of 256, split across blocks and with one
    chunk a row, against the plain version: a row past two boundaries, a row
    exactly at a chunk's start (its fresh row alone is visible), a row in the
    first chunk and a row one past a boundary; a second call gives the same
    bits."""
    B, KV, S, L = 4, 2, 700, 3
    H = 5 * KV

    def r(*shape):
        return _randn(gen, *shape).to(dtype)

    q = r(B, 1, H, D).transpose(1, 2)
    ks, vs = r(L, B, KV, S, D), r(L, B, KV, S, D)
    kn, vn = r(B, 1, KV, D).transpose(1, 2), r(B, 1, KV, D).transpose(1, 2)
    qp = torch.tensor([[690], [512], [100], [257]], dtype=torch.int32, device="cuda")

    def call():
        return fa.flash_attention_decode_fused_stacked(q, ks, vs, kn, vn, qp, 1, chunk_size=256)

    want = fa.flash_attention_decode_fused_plain(q, ks[1], vs[1], kn, vn, qp, chunk_size=256)
    before = fa.flash_attention_decode_fused.launches
    got = call()
    assert fa.flash_attention_decode_fused.launches == before + 1
    assert _max_err(got, want) <= CHUNK_TOL[dtype]
    assert torch.equal(call(), got)
    causal = fa.flash_attention_decode_fused_plain(q, ks[1], vs[1], kn, vn, qp)
    assert _max_err(causal, want) > 1e-2
    monkeypatch.setattr(fa, "decode_chunk", _one_chunk)
    assert _max_err(call(), want) <= CHUNK_TOL[dtype]


def _nope_widths(name):
    from nxdi_tpu_torch.models.cohere2 import modeling_cohere2 as tc2
    from nxdi_tpu_torch.models.llama4 import modeling_llama4 as tl4

    if name == "llama4":  # G 5, chunks of 16 under 40-token prompts, layer 1 NoPE
        return tl4, dict(tl4.LLAMA_4_SCOUT, hidden_size=256, intermediate_size=256,
                         num_hidden_layers=2, num_attention_heads=10, num_key_value_heads=2,
                         head_dim=64, vocab_size=512, num_local_experts=4,
                         attention_chunk_size=16, no_rope_layers=[1, 0])
    return tc2, dict(tc2.COMMAND_R7B, hidden_size=256, intermediate_size=512,
                     num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                     head_dim=64, vocab_size=512, sliding_window=16, sliding_window_pattern=2)


@pytest.mark.parametrize("name", ["llama4", "cohere2"])
def test_nope_family_graph_replay_equals_eager(gen, name):
    """Llama 4 (rows 1 and 3 in chunk mode on its rope layer, unchunked on
    its NoPE layer, the L2 norm and the temperature from device tensors)
    and Command R7B (the window on its rope layer, its NoPE global layer,
    the parallel block) inside captured graphs, 120 tokens past 40-token
    prompts: every dispatch bit for bit against an eager app on the same
    params, the same launch counts, every bucket a graph."""
    family, widths = _nope_widths(name)
    graphs = _family_card_app(family, widths, True, **STATIC)
    eager = _family_card_app(family, widths, False, params=graphs.params, **STATIC)
    g_log, g_counts, g_toks = _drive(graphs, "static")
    e_log, e_counts, e_toks = _drive(eager, "static")
    assert np.array_equal(np.asarray(g_toks), np.asarray(e_toks))
    assert len(g_log) == len(e_log) > 0
    for i, (a, b) in enumerate(zip(g_log, e_log)):
        for key in a:
            assert torch.equal(a[key], b[key]), (i, key)
    assert g_counts == e_counts
    for kernel in ("flash_attention_prefill", "flash_attention_decode_fused", "kv_commit_rows"):
        assert g_counts[kernel] > 0, kernel
    for w in graphs.models.values():
        assert all(bg.graph is not None for bg in w.bucket_graphs.values())


def test_chunked_paged_engine_refuses_the_kernel_flags(gen):
    """The paged and ragged kernels take no chunk (the JAX rule): on the card
    a chunked model's paged engine under the prefill kernel flag raises,
    naming the chunk."""
    family, widths = _nope_widths("llama4")
    with pytest.raises(NotImplementedError, match="chunk_size 16"):
        _family_card_app(family, widths, False, **dict(ENGINE, attn_block_tkg_kernel_enabled=False))


def _fused_ring_app(family, widths, graphs, params=None, dtype="float32"):
    """A fused speculation app on the ring (16 slots + spec_len 3 + 1) with
    the target's own weights as a full-cache draft, the attention kernels
    on."""
    from nxdi_tpu_torch.config import OnDeviceSamplingConfig, TorchConfig
    from nxdi_tpu_torch.models import dense
    from nxdi_tpu_torch.speculation import FusedSpecCausalLM

    base = dict(tp_degree=1, dtype=dtype, on_device_sampling_config=OnDeviceSamplingConfig(),
                attn_kernel_enabled=True, attn_tkg_kernel_enabled=True, **STATIC)
    cfg_cls = next(v for k, v in vars(family).items()
                   if k.endswith("InferenceConfig") and v.__module__ == family.__name__)
    tcfg = cfg_cls(TorchConfig(window_sized_kv=True, sliding_window=16, speculation_length=3,
                               enable_fused_speculation=True, **base), **widths)
    dcfg = cfg_cls(TorchConfig(**base), **widths)
    if params is None:
        arch = family.build_arch(dcfg)
        params = (family.random_params(dcfg, seed=0, device="cuda")
                  if hasattr(family, "random_params")
                  else dense.random_params(arch, seed=0, device="cuda"))
    pair = {"target": params, "draft": params}

    class App(FusedSpecCausalLM):
        def build_params(self):
            return pair

    app = App("<t>", tcfg, "<d>", dcfg, model_family=family, graphs=graphs)
    app.load()
    return app


@pytest.mark.parametrize("name", ["mistral", "gemma3_text"])
def test_ring_fused_window_graph_replay_equals_eager(gen, name):
    """The fused speculation window over a target's ring (Mistral's
    homogeneous ring, Gemma-3's ``k_win`` stack beside its full layers) and
    a full-cache draft of the target's weights, in float32, 60 tokens past
    40-token prompts: every window accepted whole but the last, every
    dispatch of the graphs bit for bit against eager, the same launch
    counts (row 1 on both prefills, row 3 in the draft's steps, row 4 into
    both caches), the tokens those of target-only generate() on the ring."""
    from nxdi_tpu_torch.generation.hf_adapter import HuggingFaceGenerationAdapter

    family, widths = _ring_widths(name)
    graphs = _fused_ring_app(family, widths, True)
    eager = _fused_ring_app(family, widths, False, params=graphs.params["target"])
    ring = graphs.kv_cache["target"]["k" if name == "mistral" else "k_win"]
    assert ring.shape[3] == 16 + 3 + 1 and "k_win" not in graphs.kv_cache["draft"]
    outs = {}
    for app in (graphs, eager):
        from nxdi_tpu_torch.ops.kernels import launch_counters

        for fn in launch_counters():
            fn.launches = 0
        log = _logged(app)
        rng = np.random.default_rng(3)
        ids = rng.integers(1, 512, (2, 40)).astype(np.int64)
        mask = np.ones_like(ids, dtype=np.int32)
        mask[1, 29:] = 0
        ids[1, 29:] = 0
        toks = HuggingFaceGenerationAdapter(app).generate(ids, attention_mask=mask,
                                                          max_new_tokens=60)
        torch.cuda.synchronize()
        outs[app.graphs] = (log, _counts(), toks)
    (g_log, g_counts, g_toks), (e_log, e_counts, e_toks) = outs[True], outs[False]
    assert np.array_equal(np.asarray(g_toks), np.asarray(e_toks))
    assert len(g_log) == len(e_log) > 0
    for i, (a, b) in enumerate(zip(g_log, e_log)):
        for key in a:
            assert torch.equal(a[key], b[key]), (i, key)
    assert all(int(c.min()) == 4 for c in (d["counts"] for d in g_log[1:-1]))
    assert g_counts == e_counts
    for kernel in ("flash_attention_prefill", "flash_attention_decode_fused", "kv_commit_rows"):
        assert g_counts[kernel] > 0, kernel
    for w in graphs.models.values():
        assert all(bg.graph is not None for bg in w.bucket_graphs.values())
    target = _family_card_app(family, widths, True, params=graphs.params["target"],
                              dtype="float32", window_sized_kv=True, sliding_window=16,
                              **STATIC)
    want = HuggingFaceGenerationAdapter(target).generate(ids, attention_mask=mask,
                                                         max_new_tokens=60)
    assert np.array_equal(np.asarray(g_toks), np.asarray(want))


def test_falcon_mixed_step_at_group_71(gen):
    """Falcon at its published attention (71 query heads of 64 on one kv
    head, LayerNorm, the parallel block), 2 layers, float32, on the mixed
    engine: the ragged kernel at G 71 and the fused QKV kernel (no MLP
    kernel: Falcon's MLP is not gated), every dispatch of the graphs bit for
    bit against eager, the same launch counts, and the streams those of the
    split engine on the same weights."""
    from nxdi_tpu_torch.models.falcon import modeling_falcon as tf

    widths = dict(tf.FALCON_7B, num_hidden_layers=2, ffn_hidden_size=1024, vocab_size=512)
    mixed = dict(MIXED, mlp_kernel_enabled=False, dtype="float32")
    graphs = _family_card_app(tf, widths, True, **mixed)
    eager = _family_card_app(tf, widths, False, params=graphs.params, **mixed)
    g_log, g_counts, g_toks = _drive(graphs, "engine")
    e_log, e_counts, e_toks = _drive(eager, "engine")
    assert np.array_equal(np.asarray(g_toks), np.asarray(e_toks))
    assert len(g_log) == len(e_log) > 0
    for i, (a, b) in enumerate(zip(g_log, e_log)):
        for key in a:
            assert torch.equal(a[key], b[key]), (i, key)
    assert g_counts == e_counts
    assert g_counts["ragged_paged_attention"] > 0 and g_counts["qkv_matmul"] > 0
    assert g_counts["fused_mlp"] == 0
    split = _family_card_app(tf, widths, True, params=graphs.params,
                             **dict(ENGINE, dtype="float32", fused_qkv=True,
                                    qkv_kernel_enabled=True))
    _, s_counts, s_toks = _drive(split, "engine")
    assert s_counts["ragged_paged_attention"] == 0
    assert np.array_equal(np.asarray(g_toks), np.asarray(s_toks))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_commit_at_mimo_widths(gen, dtype):
    """Row 4 at MiMo-V2-Flash's K 192 / V 128 (its full stack's 4 kv heads),
    B 8: a decode step's rows into the stack and a routed prefill into
    shuffled lines (a dropped position, a dropped line), bit for bit
    against the plain version, one launch each."""
    L, B, KV, S, Dk, Dv = 2, 8, 4, 256, 192, 128
    k, v = _randn(gen, L, B, KV, S, Dk).to(dtype), _randn(gen, L, B, KV, S, Dv).to(dtype)
    cases = [(_randn(gen, L, B, KV, 1, Dk).to(dtype), _randn(gen, L, B, KV, 1, Dv).to(dtype),
              torch.tensor([[7 * b + 3] for b in range(B)], dtype=torch.int32, device="cuda"),
              None)]
    slots = torch.arange(40, dtype=torch.int32, device="cuda")[None].repeat(3, 1)
    slots[0, -1] = -1
    cases.append((_randn(gen, L, 3, KV, 40, Dk).to(dtype), _randn(gen, L, 3, KV, 40, Dv).to(dtype),
                  slots, torch.tensor([6, 1, 8], dtype=torch.int32, device="cuda")))
    for kr, vr, sl, lines in cases:
        k_ref, v_ref = k.clone(), v.clone()
        kc.kv_commit_rows_plain(k_ref, v_ref, kr, vr, sl, lines)
        before = kc.kv_commit_rows.launches
        kc.kv_commit_rows(k, v, kr, vr, sl, lines)
        assert kc.kv_commit_rows.launches == before + 1
        assert torch.equal(k, k_ref) and torch.equal(v, v_ref)


def _hybrid_card_app(model_type, graphs, params=None, **tc):
    """A bf16 app of a hybrid family at narrow widths over its published
    constant (2 layers; MiMo: q / k 48 against v 32, the fused MLP on its
    dense layer), its own application class, random weights from seed 0."""
    from nxdi_tpu_torch.config import OnDeviceSamplingConfig, TorchConfig
    from nxdi_tpu_torch.models import registry

    module, cfg_cls = registry.get_family(model_type)
    if model_type == "mimo_v2":
        widths = dict(module.MIMO_V2_FLASH, hidden_size=256, num_hidden_layers=2,
                      hybrid_layer_pattern=[0, 1], moe_layer_freq=[0, 1], num_attention_heads=4,
                      num_key_value_heads=2, swa_num_attention_heads=4,
                      swa_num_key_value_heads=2, head_dim=48, v_head_dim=32, swa_head_dim=48,
                      swa_v_head_dim=32, sliding_window=16, n_routed_experts=8,
                      moe_intermediate_size=64, intermediate_size=512, vocab_size=512)
        tc = dict(mlp_kernel_enabled=True, **tc)
    else:
        widths = dict(module.LFM2_1_2B, hidden_size=256, intermediate_size=768,
                      num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                      vocab_size=512, layer_types=["conv", "full_attention"])
    cfg = cfg_cls(TorchConfig(tp_degree=1, dtype="bfloat16", output_logits=True,
                              on_device_sampling_config=OnDeviceSamplingConfig(), **tc), **widths)

    class App(module.APPLICATION_CLS):
        def build_params(self):
            return params if params is not None else module.random_params(cfg, seed=0,
                                                                           device="cuda")

    app = App("<random>", cfg, graphs=graphs)
    app.load()
    return app


@pytest.mark.parametrize("model_type", ["mimo_v2", "lfm2"])
def test_hybrid_graph_replay_equals_eager(gen, model_type):
    """MiMo-V2 (two attention stacks, values narrower than q / k) and LFM2
    (conv tails beside attention) inside captured graphs: generate() and
    then two requests on shuffled cache lines, every dispatch bit for bit
    against an eager app on the same params, the same launch counts, the
    commit (and MiMo's fused MLP) launched, every bucket a graph."""
    cb = dict(is_continuous_batching=True, ctx_batch_size=1, tkg_batch_size=2,
              kv_cache_batch_size=4)
    runs = []
    params = None
    for graphs in (True, False):
        out = []
        for tc in (STATIC, dict(STATIC, **cb)):
            app = _hybrid_card_app(model_type, graphs, params=params, **tc)
            params = app.params
            if "is_continuous_batching" in tc:
                for fn in _launch_counters():
                    fn.launches = 0
                log = _logged(app)
                rng = np.random.default_rng(4)
                toks = []
                for line, n in ((3, 30), (1, 17)):
                    p = rng.integers(1, 512, n)
                    o = app.forward(p[None].astype(np.int32), np.arange(n, dtype=np.int32)[None],
                                    last_token_index=np.array([n - 1], np.int32),
                                    seq_ids=np.array([line], np.int32))
                    toks.append([int(o["tokens"][0, 0])])
                pos = [30, 17]
                for _ in range(10):
                    o = app.forward(np.array([[t[-1]] for t in toks], np.int32),
                                    np.array([[p_] for p_ in pos], np.int32),
                                    seq_ids=np.array([3, 1], np.int32))
                    for t, x in zip(toks, o["tokens"][:, 0].tolist()):
                        t.append(x)
                    pos = [p_ + 1 for p_ in pos]
                torch.cuda.synchronize()
                out.append((log, _counts(), toks))
            else:
                out.append(_drive(app, "static"))
            if graphs:
                for w in app.models.values():
                    assert all(bg.graph is not None for bg in w.bucket_graphs.values())
        runs.append(out)
    for (g_log, g_counts, g_toks), (e_log, e_counts, e_toks) in zip(*runs):
        assert np.array_equal(np.asarray(g_toks), np.asarray(e_toks))
        assert len(g_log) == len(e_log) > 0
        for i, (a, b) in enumerate(zip(g_log, e_log)):
            for key in a:
                assert torch.equal(a[key], b[key]), (i, key)
        assert g_counts == e_counts
        assert g_counts["kv_commit_rows"] > 0
        assert g_counts["flash_attention_prefill"] == g_counts["flash_attention_decode_fused"] == 0
        if model_type == "mimo_v2":
            assert g_counts["fused_mlp"] > 0


def _launch_counters():
    from nxdi_tpu_torch.ops.kernels import launch_counters

    return launch_counters()
