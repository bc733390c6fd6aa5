"""The plain versions of the port's window-decode, paged-decode and
paged-prefill kernels (what their wrappers run on CPU tensors) held against
the JAX package's Pallas kernels, which run in interpret mode off the TPU.
Same numpy inputs to both. The paged layout around them (slot scatter,
block-table gather, block copy) is held against the JAX package's bit for
bit.

Tolerances: float32 1e-5. bfloat16 2e-2: both sides round the probabilities
to bfloat16 before P.V, the Pallas kernel against its running maximum and
the plain version against the final one, and both round the output to
bfloat16 (one ulp is 3.9e-3 at 0.5-1); the largest difference measured on
these inputs is 7.8e-3 (two ulps of outputs scaled by v_scale 2).

The CUDA kernels themselves run only on the card: ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` hold them against these plain versions there."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nxdi_tpu.ops.kernels import flash_attention as jfa
from nxdi_tpu_torch.ops.kernels import flash_attention as tfa

from test_torch_slice import one_torch_thread


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with one_torch_thread():
        yield


TOL = {"float32": 1e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _jax(x, dtype="float32"):
    x = np.asarray(x)
    return jnp.asarray(x, JDT[dtype]) if x.dtype == np.float32 else jnp.asarray(x)


def _torch(x, dtype="float32"):
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t.to(TDT[dtype]) if t.dtype == torch.float32 else t


def _close(port, ref, dtype):
    np.testing.assert_allclose(port.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               atol=TOL[dtype], rtol=0)


@pytest.fixture
def launch_counts():
    """The new wrappers' launch counters, reset; CPU tensors must leave them 0."""
    fns = (tfa.flash_attention_decode, tfa.paged_attention_decode, tfa.paged_attention_prefill)
    for fn in fns:
        fn.launches = 0
    yield lambda: [fn.launches for fn in fns]


# ---------------------------------------------------------------------------
# window decode (tkg_kernel)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("window,chunk", [(None, None), (8, None), (None, 8)])
def test_window_decode_matches_pallas(dtype, G, window, chunk, launch_counts):
    B, KV, Sk, D = 3, 2, 40, 16
    q, k, v = _rand((B, KV * G, 1, D), 0), _rand((B, KV, Sk, D), 1), _rand((B, KV, Sk, D), 2)
    q_pos = np.array([[13], [0], [39]], np.int32)
    kv_pos = np.tile(np.arange(Sk, dtype=np.int32), (B, 1))
    args = (q, k, v, q_pos, kv_pos)
    ref = jfa.flash_attention_decode(*(_jax(x, dtype) for x in args), sliding_window=window,
                                     chunk_size=chunk, block_k=8)
    got = tfa.flash_attention_decode(*(_torch(x, dtype) for x in args), sliding_window=window,
                                     chunk_size=chunk)
    _close(got, ref, dtype)
    assert launch_counts() == [0, 0, 0]


def test_window_decode_offset_start_and_no_visible_key():
    """Row 0's window starts at position 5; row 1's first position is the
    poisoned 2**30 of a hole, so no key is visible and the output is 0."""
    B, H, KV, Sk, D = 2, 4, 2, 24, 8
    q, k, v = _rand((B, H, 1, D), 3), _rand((B, KV, Sk, D), 4), _rand((B, KV, Sk, D), 5)
    q_pos = np.array([[20], [20]], np.int32)
    kv_pos = np.stack([np.arange(5, 5 + Sk), np.full(Sk, 2 ** 30)]).astype(np.int32)
    args = (q, k, v, q_pos, kv_pos)
    ref = jfa.flash_attention_decode(*(_jax(x) for x in args), block_k=8)
    got = tfa.flash_attention_decode(*(_torch(x) for x in args))
    _close(got, ref, "float32")
    assert torch.equal(got[1], torch.zeros_like(got[1]))


# ---------------------------------------------------------------------------
# paged decode (tkg_paged_kernel) and paged prefill (cte_paged_kernel)
# ---------------------------------------------------------------------------


def _pool(num_blocks, bs, KV, D, seed):
    return _rand((num_blocks * bs, KV, D), seed), _rand((num_blocks * bs, KV, D), seed + 1)


def _tables(bs):
    """Four rows: dense, a hole in the middle, right-padded with holes, and
    all holes (no visible key)."""
    NB = 48 // bs
    rng = np.random.default_rng(bs)
    perm = rng.permutation(2 * NB).astype(np.int32)
    bt = np.stack([perm[:NB], perm[NB:], perm[:NB], np.full(NB, -1, np.int32)])
    bt[1, 1] = -1
    bt[2, NB // 2:] = -1
    return bt, 2 * NB


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bs", [8, 16])
@pytest.mark.parametrize("G", [1, 4])
def test_paged_decode_matches_pallas(dtype, bs, G, launch_counts):
    KV, D = 2, 16
    bt, nblk = _tables(bs)
    B = bt.shape[0]
    kc, vc = _pool(nblk, bs, KV, D, 10)
    q = _rand((B, KV * G, 1, D), 12)
    q_pos = np.array([[47], [20], [9], [30]], np.int32)
    scales = dict(k_scale=0.5, v_scale=2.0)
    args = (q, kc, vc, bt, q_pos)
    ref = jfa.paged_attention_decode(*(_jax(x, dtype) for x in args), block_size=bs, **scales)
    got = tfa.paged_attention_decode(*(_torch(x, dtype) for x in args), block_size=bs,
                                     **scales)
    _close(got, ref, dtype)
    assert torch.equal(got[3], torch.zeros_like(got[3]))
    assert launch_counts() == [0, 0, 0]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bs", [8, 16])
@pytest.mark.parametrize("G", [1, 4])
def test_paged_prefill_matches_pallas(dtype, bs, G, launch_counts):
    """A 12-token chunk (not a multiple of 8) per row, starting at positions
    that put it across block boundaries, mid-table and at the start."""
    KV, D, Sq = 2, 16, 12
    bt, nblk = _tables(bs)
    B = bt.shape[0]
    kc, vc = _pool(nblk, bs, KV, D, 20)
    q = _rand((B, KV * G, Sq, D), 22)
    q_pos = np.array([30, 0, 13, 5], np.int32)[:, None] + np.arange(Sq, dtype=np.int32)
    scales = dict(k_scale=1.5, v_scale=0.25)
    args = (q, kc, vc, bt, q_pos)
    ref = jfa.paged_attention_prefill(*(_jax(x, dtype) for x in args), block_size=bs, **scales)
    got = tfa.paged_attention_prefill(*(_torch(x, dtype) for x in args), block_size=bs,
                                      **scales)
    _close(got, ref, dtype)
    assert torch.equal(got[3], torch.zeros_like(got[3]))
    assert launch_counts() == [0, 0, 0]


def test_paged_wrappers_reject_bad_shapes():
    q = torch.zeros((1, 4, 1, 16))
    pool = torch.zeros((40, 2, 16))
    with pytest.raises(ValueError, match="whole blocks"):
        tfa.paged_attention_decode(q, pool, pool, torch.zeros((1, 4), dtype=torch.int32),
                                   torch.zeros((1, 1)), block_size=16)
    with pytest.raises(ValueError, match="one query position"):
        tfa.paged_attention_decode(torch.zeros((1, 4, 2, 16)), pool, pool,
                                   torch.zeros((1, 4), dtype=torch.int32), torch.zeros((1, 2)),
                                   block_size=8)
    with pytest.raises(ValueError, match="bad shapes"):
        tfa.paged_attention_prefill(torch.zeros((1, 3, 4, 16)), pool, pool,
                                    torch.zeros((1, 4), dtype=torch.int32), torch.zeros((1, 4)),
                                    block_size=8)
    with pytest.raises(TypeError):
        tfa.flash_attention_decode(q.half(), torch.zeros((1, 2, 8, 16)).half(),
                                   torch.zeros((1, 2, 8, 16)).half(), torch.zeros((1, 1)),
                                   torch.zeros((1, 8)))


# ---------------------------------------------------------------------------
# the paged layout around the kernels
# ---------------------------------------------------------------------------


def test_block_layout_and_block_copy_match_jax():
    """BlockKVLayout.update (slot scatter through scatter_indices, which
    drops negative slots), .read (block-table gather with poisoned holes)
    and copy_kv_blocks against the JAX package's."""
    from nxdi_tpu.kvcache import kv_cache as jkv
    from nxdi_tpu_torch.kvcache import kv_cache as tkv

    bs, nblk, KV, D = 4, 6, 2, 8
    pool_k, pool_v = _rand((nblk * bs, KV, D), 30), _rand((nblk * bs, KV, D), 31)
    k_new, v_new = _rand((2, KV, 3, D), 32), _rand((2, KV, 3, D), 33)
    slots = np.array([[5, 6, -1], [17, 18, 19]], np.int32)
    bt = np.array([[1, 3, -1], [4, 0, 5]], np.int32)
    jspec = jkv.BlockKVCacheSpec(1, nblk, bs, KV, D, dtype="float32")
    tspec = tkv.BlockKVCacheSpec(1, nblk, bs, KV, D, dtype="float32")
    jl, tl = jkv.BlockKVLayout(block_size=bs), tkv.BlockKVLayout(block_size=bs)

    ref_k, ref_v = jl.update(jnp.asarray(pool_k), jnp.asarray(pool_v), jnp.asarray(k_new),
                             jnp.asarray(v_new), {"slot_mapping": jnp.asarray(slots)}, jspec)
    ci = {k: torch.from_numpy(v) for k, v in tkv.scatter_indices(slots).items()}
    assert ci["write_slots"].tolist() == [5, 6, 17, 18, 19]
    tk, tv = _torch(pool_k), _torch(pool_v)
    tl.update(tk, tv, _torch(k_new), _torch(v_new), ci, tspec)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(ref_k))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(ref_v))

    jr = jl.read(ref_k, ref_v, {"block_table": jnp.asarray(bt)}, jspec)
    tr = tl.read(tk, tv, {"block_table": torch.from_numpy(bt)}, tspec)
    for got, ref in zip(tr, jr):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))

    cache = {"k": jnp.asarray(pool_k)[None], "v": jnp.asarray(pool_v)[None]}
    ref = jkv.copy_kv_blocks(cache, [1, 4], [2, 0], bs)
    tcache = {"k": _torch(pool_k)[None].clone(), "v": _torch(pool_v)[None].clone()}
    assert tkv.copy_kv_blocks(tcache, [1, 4], [2, 0], bs) is tcache  # in place
    for key in ("k", "v"):
        np.testing.assert_array_equal(tcache[key].numpy(), np.asarray(ref[key]))
