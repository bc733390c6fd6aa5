"""The GEMM plan of the fused projections (``fused_proj.gemm_plan``): which
body, tiles and K split the CUDA kernels get for each M the mixed engine
dispatches, checked without a card.

Products at Llama-3.2-1B's widths: the fused QKV (2048 -> 3072), the MLP's
gate/up pair (2048 -> 8192, dual) and its down product (8192 -> 2048). M runs
over the mixed engine's packed-token ladder (2 ... 1032).

The split-K order the kernels follow (per-slice partials in f32, summed in
slice order, then the epilogue and one rounding) is emulated here in
PyTorch and held against the plain versions. Tolerance: the two differ only
in the order of f32 sums, which can move a bfloat16 rounding by one ulp,
at most 2^-7 of the value (rtol); the MLP's intermediate can move by one ulp
too, which reaches the output through 0.02-scale weights (atol 1e-4).
"""

import math

import numpy as np
import pytest
import torch

from nxdi_tpu_torch.ops.kernels import _build
from nxdi_tpu_torch.ops.kernels import fused_proj as fp
from nxdi_tpu_torch.runtime.autobucketing import generate_buckets

LADDER = generate_buckets(2, 1024 + 8)  # mixed_token_buckets at max_context_length 1024, 8 slots
PRODUCTS = {  # name: (N, K, dual)
    "qkv": (3072, 2048, False),
    "gate_up": (8192, 2048, True),
    "down": (2048, 8192, False),
}
SMS = 132


def _ranges(n, tile, count):
    return [(i * tile, min(n, (i + 1) * tile)) for i in range(count)]


def _blocks(plan, M, N, K):
    """(rows, cols, k range) of every block, as the kernels map them."""
    for m in _ranges(M, plan.bm, plan.m_tiles):
        for n in _ranges(N, plan.bn, plan.n_tiles):
            for k in _ranges(K, plan.k_slice, plan.splits):
                yield m, n, k


def _partitions(ranges, n):
    ranges = sorted(ranges)
    return (all(a < b for a, b in ranges) and ranges[0][0] == 0 and ranges[-1][1] == n
            and all(ranges[i][1] == ranges[i + 1][0] for i in range(len(ranges) - 1)))


def test_ladder_is_the_mixed_engines():
    assert LADDER == [2, 4, 8, 16, 32, 64, 128, 256, 512, 1032]


@pytest.mark.parametrize("product", PRODUCTS)
@pytest.mark.parametrize("M", LADDER)
def test_plan_covers_every_output_tile_once(M, product):
    N, K, dual = PRODUCTS[product]
    plan = fp.gemm_plan(M, N, K, dual, SMS)
    blocks = list(_blocks(plan, M, N, K))
    assert len(blocks) == plan.blocks
    tiles = {}
    for m, n, k in blocks:
        tiles.setdefault((m, n), []).append(k)
    assert _partitions({m for m, _ in tiles}, M)
    assert _partitions({n for _, n in tiles}, N)
    assert len(tiles) == plan.m_tiles * plan.n_tiles
    for ks in tiles.values():  # each output tile: every K element exactly once
        assert len(ks) == plan.splits and _partitions(ks, K)


@pytest.mark.parametrize("product", PRODUCTS)
@pytest.mark.parametrize("M", LADDER)
def test_plan_k_slices_are_whole_tiles(M, product):
    N, K, dual = PRODUCTS[product]
    plan = fp.gemm_plan(M, N, K, dual, SMS)
    assert plan.bk == fp.GEMM_BK and plan.k_slice % plan.bk == 0
    slices = _ranges(K, plan.k_slice, plan.splits)
    assert all(b - a == plan.k_slice for a, b in slices[:-1])
    last = slices[-1]
    assert 0 < last[1] - last[0] <= plan.k_slice and last[1] == K


@pytest.mark.parametrize("product", PRODUCTS)
@pytest.mark.parametrize("M", LADDER)
def test_plan_workspace_and_body(M, product):
    N, K, dual = PRODUCTS[product]
    plan = fp.gemm_plan(M, N, K, dual, SMS)
    want = plan.splits * M * N * 4 * (2 if dual else 1) if plan.splits > 1 else 0
    assert plan.workspace_bytes == want
    if M <= fp.STREAM_MAX_M:
        # the weight-streaming body: one 64-row tile, 128-column B tiles,
        # a block on every SM (two fit)
        assert plan.body == "stream" and plan.bm == 64 and plan.m_tiles == 1
        assert plan.bn == (64 if dual else 128)
        assert plan.blocks >= fp.STREAM_BLOCKS_PER_SM * SMS >= SMS
    else:
        assert plan.body == "wgmma" and plan.bm == 128
        assert plan.bn in ((64, 128) if dual else (128, 256))
        assert plan.splits <= 8 and plan.k_slice >= 4 * plan.bk


def test_plan_at_the_packed_steps():
    """At 520 rows the down product's tiles fill under one wave of 132 SMs
    (80 narrow or 40 wide), so K is split; the QKV's 120 narrow tiles and
    the gate/up pair's 320 wide ones keep K whole. At 1032 rows the QKV
    takes wide tiles (108, one wave, where 216 narrow ones take two)."""
    down = fp.gemm_plan(520, 2048, 8192, False, SMS)
    assert down.splits > 1 and down.blocks <= 2 * SMS
    qkv = fp.gemm_plan(520, 3072, 2048, False, SMS)
    assert qkv.splits == 1 and qkv.bn == 128 and qkv.blocks == 120
    gate_up = fp.gemm_plan(520, 8192, 2048, True, SMS)
    assert gate_up.splits == 1 and gate_up.bn == 128
    assert fp.gemm_plan(1032, 3072, 2048, False, SMS).bn == 256


def test_plan_of_float32_is_the_cuda_core_body():
    for M in (8, 520):
        plan = fp.gemm_plan(M, 3072, 2048, False, SMS, torch.float32)
        assert plan.body == "simt" and plan.splits == 1 and plan.workspace_bytes == 0
        assert plan.args[0] == fp.GEMM_BODIES["simt"]


@pytest.mark.parametrize("product", PRODUCTS)
@pytest.mark.parametrize("M", LADDER)
def test_plan_args_match_the_c_entry_points(M, product):
    """The plan's arguments, in the order and number the C entry points
    take them (once for QKV, twice for the MLP: gate/up, then down)."""
    N, K, dual = PRODUCTS[product]
    plan = fp.gemm_plan(M, N, K, dual, SMS)
    assert plan.args == (fp.GEMM_BODIES[plan.body], plan.bm, plan.bn, plan.splits, plan.k_slice)
    # the leading operands and sizes, the plan(s), the workspace, the stream
    assert len(_build.SIGNATURES["nxdi_qkv_matmul"]) == 9 + len(plan.args) + 2
    assert len(_build.SIGNATURES["nxdi_fused_mlp"]) == 13 + 2 * len(plan.args) + 2
    if M == 8 and product == "qkv":
        assert plan.args == (fp.GEMM_BODIES["stream"], 64, 128, plan.splits, plan.k_slice)


@pytest.mark.parametrize("M", [1, 7, 63, 65, 129])
def test_plan_at_ragged_small_widths(M):
    """Widths that are multiples of 8 but not of any tile."""
    for N, K in ((40, 72), (136, 200)):
        plan = fp.gemm_plan(M, N, K, False, SMS)
        assert plan.m_tiles * plan.bm >= M > (plan.m_tiles - 1) * plan.bm
        assert plan.n_tiles * plan.bn >= N > (plan.n_tiles - 1) * plan.bn
        assert plan.splits * plan.k_slice >= K > (plan.splits - 1) * plan.k_slice


# ---------------------------------------------------------------------------
# The split-K order, emulated, against the plain versions
# ---------------------------------------------------------------------------


def _split_sum(a, w, plan):
    """sum over K slices (in slice order) of the f32 partial a[:, slice] @ w[slice]."""
    K = a.shape[1]
    acc = None
    for k0, k1 in _ranges(K, plan.k_slice, plan.splits):
        part = a[:, k0:k1].float() @ w[k0:k1].float()
        acc = part if acc is None else acc + part
    return acc


def _bf16(shape, seed, scale):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * scale
    return torch.from_numpy(x).to(torch.bfloat16)


@pytest.mark.parametrize("M", [2, 8, 64, 128, 520])
def test_split_k_order_matches_plain_qkv(M):
    x, w = _bf16((M, 2048), M, 0.5), _bf16((2048, 3072), 1, 0.02)
    plan = fp.gemm_plan(M, 3072, 2048, False, SMS)
    got = _split_sum(x, w, plan).to(torch.bfloat16)
    want = fp.qkv_matmul_plain(x, w)
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), rtol=2 ** -7,
                               atol=1e-5)


@pytest.mark.parametrize("M", [8, 128, 520])
def test_split_k_order_matches_plain_mlp(M):
    H, I = 2048, 8192
    x = _bf16((M, H), M, 0.5)
    g, u, d = _bf16((H, I), 2, 0.02), _bf16((H, I), 3, 0.02), _bf16((I, H), 4, 0.02)
    gu, dn = fp.gemm_plan(M, I, H, True, SMS), fp.gemm_plan(M, H, I, False, SMS)
    a = (fp._act(_split_sum(x, g, gu), "silu") * _split_sum(x, u, gu)).to(torch.bfloat16)
    got = _split_sum(a, d, dn).to(torch.bfloat16)
    want = fp.fused_mlp_plain(x, g, u, d, "silu")
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), rtol=2 ** -7,
                               atol=1e-4)
    assert math.isfinite(float(got.float().abs().max()))
