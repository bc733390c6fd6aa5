"""The plain version of the port's ragged paged-attention kernel (what its
wrapper runs on CPU tensors) held against the JAX package's Pallas kernel
``ragged_paged_attention`` in interpret mode, in the geometries of
``tests/unit/test_ragged_paged_attention.py`` — a mixed batch, a row ending
at the bucket edge, all decode rows, an empty padded tail, per-tensor scales
— plus slots that do not ascend along the stream (the mixed engine packs
prefill chunks first and decode rows after them), G in {1, 4} and block
sizes 8 and 16.

Held to a tolerance, not bit for bit: float32 1e-5 (the plain version takes
one softmax over the whole window, the Pallas kernel an online softmax over
blocks). Padding tokens must be exactly 0.

The CUDA kernel itself runs only on the card: ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` hold it against this plain version there."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nxdi_tpu.ops.kernels import ragged_paged_attention as jax_ragged  # the function
from nxdi_tpu_torch.ops.kernels import ragged_paged_attention as tra
from test_torch_slice import fresh_jax_compiles

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _fresh_jax_compiles():
    # the Pallas references compile without a persistent cache an earlier
    # test on this worker left on (ROADMAP Queue 3)
    with fresh_jax_compiles():
        yield


def _pool(rng, total_slots, KV, D):
    return (rng.standard_normal((total_slots, KV, D)).astype(np.float32),
            rng.standard_normal((total_slots, KV, D)).astype(np.float32))


def _pack(T, H, D, rows, rng, slots=None):
    """rows: (positions, table) per row; ``slots`` gives each row's slot (the
    table's row index), default 0..n-1. Returns q, row_ids, q_pos, tables and
    the packed indices of the real tokens."""
    slots = list(range(len(rows))) if slots is None else slots
    q = rng.standard_normal((1, H, T, D)).astype(np.float32)
    row_ids = np.full(T, -1, np.int32)
    q_pos = np.zeros(T, np.int32)
    R = max(slots) + 1
    NB = len(rows[0][1])
    bt = np.full((R, NB), -1, np.int32)
    t = 0
    for slot, (positions, table) in zip(slots, rows):
        bt[slot] = table
        for p in positions:
            row_ids[t], q_pos[t] = slot, p
            t += 1
    assert t <= T
    return q, row_ids, q_pos, bt, t


def _both(q, k, v, bt, rid, qp, bs, **kw):
    want = jax_ragged(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bt), jnp.asarray(rid),
        jnp.asarray(qp), block_size=bs, block_q=8, **kw)
    tra.ragged_paged_attention.launches = 0
    got = tra.ragged_paged_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), bt, rid, qp,
        block_size=bs, **kw)
    assert tra.ragged_paged_attention.launches == 0  # CPU tensors: the plain version
    return got.numpy(), np.asarray(want)


def _check(got, want, n_real):
    np.testing.assert_allclose(got[:, :, :n_real], want[:, :, :n_real], atol=TOL, rtol=0)
    assert np.all(np.isfinite(got)) and np.all(got[:, :, n_real:] == 0.0)


@pytest.mark.parametrize("H,KV", [(4, 4), (8, 2)])
def test_ragged_mixed_batch(H, KV):
    """A prefill chunk after a 1-block prefix, a decode step deep in its row,
    a fresh short prefill and a padded tail in one launch."""
    rng = np.random.default_rng(0)
    T, D, bs = 16, 16, 8
    k, v = _pool(rng, 96, KV, D)
    rows = [(list(range(8, 14)), [3, 5, -1, -1]), ([21], [7, 2, 9, -1]),
            (list(range(0, 5)), [1, -1, -1, -1])]
    q, rid, qp, bt, n = _pack(T, H, D, rows, rng)
    assert tra.ragged_paged_kernel_supported(q.shape, k.shape, bs)
    _check(*_both(q, k, v, bt, rid, qp, bs), n)


def test_ragged_row_at_bucket_edge():
    rng = np.random.default_rng(1)
    H, KV, T, D, bs = 4, 2, 8, 8, 8
    k, v = _pool(rng, 64, KV, D)
    q, rid, qp, bt, n = _pack(T, H, D, [(list(range(8, 16)), [2, 6, -1])], rng)
    assert n == T
    _check(*_both(q, k, v, bt, rid, qp, bs), n)


def test_ragged_all_decode_rows():
    rng = np.random.default_rng(2)
    H, KV, T, D, bs = 8, 2, 8, 16, 8
    k, v = _pool(rng, 64, KV, D)
    rows = [([5], [4, -1]), ([11], [0, 3]), ([0], [7, -1])]
    q, rid, qp, bt, n = _pack(T, H, D, rows, rng)
    _check(*_both(q, k, v, bt, rid, qp, bs), n)


def test_ragged_empty_tail_is_inert():
    """2 real tokens of 16: the whole tail is exactly 0."""
    rng = np.random.default_rng(3)
    H, KV, T, D, bs = 4, 4, 16, 8, 8
    k, v = _pool(rng, 32, KV, D)
    q, rid, qp, bt, n = _pack(T, H, D, [([9], [1, 0]), ([3], [2, -1])], rng)
    _check(*_both(q, k, v, bt, rid, qp, bs), n)


def test_ragged_scale_folding():
    """k/v per-tensor scales fold into the softmax scale and the output."""
    rng = np.random.default_rng(4)
    H, KV, T, D, bs = 4, 2, 8, 8, 8
    k, v = _pool(rng, 32, KV, D)
    q, rid, qp, bt, n = _pack(T, H, D, [(list(range(0, 6)), [2, -1]), ([8], [3, 0])], rng)
    got, want = _both(q, k, v, bt, rid, qp, bs, k_scale=2.0, v_scale=0.5)
    _check(got, want, n)
    unscaled, _ = _both(q, k * 2.0, v * 0.5, bt, rid, qp, bs)
    np.testing.assert_allclose(got, unscaled, atol=2e-5, rtol=0)


@pytest.mark.parametrize("bs", [8, 16])
@pytest.mark.parametrize("H,KV", [(4, 4), (8, 2)])
def test_ragged_slots_not_ascending(bs, H, KV):
    """The engine's packing: a prefill chunk of slot 2 first, then decode
    tokens of slots 3, 0 and 1, a hole in one decode row's table, padding."""
    rng = np.random.default_rng(5)
    T, D, NB = 24, 16, 4
    k, v = _pool(rng, 12 * bs, KV, D)
    rows = [
        (list(range(bs - 3, bs + 6)), [4, 7, -1, -1]),          # slot 2: chunk after a prefix
        ([2 * bs + 1], [1, -1, 9, -1]),                         # slot 3: decode, a hole before it
        ([bs + 2], [0, 5, -1, -1]),                             # slot 0: decode
        ([3], [11, -1, -1, -1]),                                # slot 1: decode, early
    ]
    q, rid, qp, bt, n = _pack(T, H, D, rows, rng, slots=[2, 3, 0, 1])
    _check(*_both(q, k, v, bt, rid, qp, bs), n)


def test_ragged_token_with_no_visible_key_is_zero():
    """A decode token whose every block is a hole sees nothing: exactly 0."""
    rng = np.random.default_rng(6)
    H, KV, T, D, bs = 4, 2, 8, 8, 8
    k, v = _pool(rng, 32, KV, D)
    q, rid, qp, bt, n = _pack(T, H, D, [(list(range(0, 4)), [1, -1]), ([6], [-1, -1])], rng)
    got, want = _both(q, k, v, bt, rid, qp, bs)
    _check(got, want, n)
    assert np.all(got[:, :, 4] == 0.0)
