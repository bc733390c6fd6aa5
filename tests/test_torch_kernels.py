"""The port's kernel wrappers on CPU tensors (their plain versions) held
against the JAX package's Pallas kernels, which run in interpret mode off
the TPU. Same numpy inputs to both; f32 tolerance 1e-5, commit exact.

The CUDA kernels themselves run only on the card: ``chip_smoke.py`` holds
each against its plain version there."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nxdi_tpu.ops.kernels import flash_attention as jfa
from nxdi_tpu.ops.kernels import kv_commit as jkc
from nxdi_tpu_torch.ops.kernels import flash_attention as tfa
from nxdi_tpu_torch.ops.kernels import kv_commit as tkc

from test_torch_slice import one_torch_thread


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with one_torch_thread():
        yield


TOL = 1e-5


def _rand(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _close(port, ref):
    np.testing.assert_allclose(port.float().numpy(), np.asarray(ref, np.float32), atol=TOL, rtol=TOL)


@pytest.fixture
def launch_counts():
    """The wrappers' launch counters, reset; CPU tensors must leave them 0."""
    fns = (tfa.flash_attention_prefill, tfa.flash_attention_decode_fused, tkc.kv_commit_rows)
    for fn in fns:
        fn.launches = 0
    yield lambda: [fn.launches for fn in fns]


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("window,chunk", [(None, None), (6, None), (None, 8)])
def test_prefill_matches_pallas(G, window, chunk, launch_counts):
    B, KV, S, D = 2, 2, 32, 16
    H = KV * G
    q, k, v = _rand((B, H, S, D), 0), _rand((B, KV, S, D), 1), _rand((B, KV, S, D), 2)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    ref = jfa.flash_attention_prefill(
        *(jnp.asarray(x) for x in (q, k, v, pos, pos)),
        sliding_window=window, chunk_size=chunk, block_q=8, block_k=8,
    )
    got = tfa.flash_attention_prefill(
        *(torch.from_numpy(x) for x in (q, k, v, pos, pos)),
        sliding_window=window, chunk_size=chunk,
    )
    _close(got, ref)
    assert launch_counts() == [0, 0, 0]


def test_prefill_right_padded_positions():
    """Pad lanes carry positions past the true length (the JAX package's
    right-padded positions case)."""
    B, H, KV, S, D = 1, 4, 2, 16, 8
    q, k, v = _rand((B, H, S, D), 0), _rand((B, KV, S, D), 1), _rand((B, KV, S, D), 2)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    ref = jfa.flash_attention_prefill(*(jnp.asarray(x) for x in (q, k, v, pos, pos)),
                                      block_q=4, block_k=4)
    _close(tfa.flash_attention_prefill(*(torch.from_numpy(x) for x in (q, k, v, pos, pos))), ref)


def test_prefill_offset_starts():
    """Per-row affine positions with different starts for q and kv."""
    B, H, KV, Sq, Sk, D = 2, 4, 2, 8, 24, 16
    q, k, v = _rand((B, H, Sq, D), 3), _rand((B, KV, Sk, D), 4), _rand((B, KV, Sk, D), 5)
    q_pos = np.array([16, 10], np.int32)[:, None] + np.arange(Sq, dtype=np.int32)[None]
    kv_pos = np.tile(np.arange(Sk, dtype=np.int32), (B, 1))
    ref = jfa.flash_attention_prefill(*(jnp.asarray(x) for x in (q, k, v, q_pos, kv_pos)),
                                      block_q=8, block_k=8)
    _close(tfa.flash_attention_prefill(*(torch.from_numpy(x) for x in (q, k, v, q_pos, kv_pos))), ref)


# ---------------------------------------------------------------------------
# fused decode
# ---------------------------------------------------------------------------


def _decode_inputs(B, H, KV, W, D, seed=0):
    return (_rand((B, H, 1, D), seed), _rand((B, KV, W, D), seed + 1), _rand((B, KV, W, D), seed + 2),
            _rand((B, KV, 1, D), seed + 3), _rand((B, KV, 1, D), seed + 4))


@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("window,chunk", [(None, None), (8, None), (None, 8)])
def test_fused_decode_matches_pallas(G, window, chunk, launch_counts):
    B, KV, W, D = 2, 2, 32, 16
    q, kk, vv, kn, vn = _decode_inputs(B, KV * G, KV, W, D)
    q_pos = np.array([[13], [7]], np.int32)
    kv_pos = np.tile(np.arange(W, dtype=np.int32), (B, 1))
    args = (q, kk, vv, kn, vn, q_pos, kv_pos)
    ref = jfa.flash_attention_decode_fused(*(jnp.asarray(x) for x in args),
                                           sliding_window=window, chunk_size=chunk, block_k=8)
    got = tfa.flash_attention_decode_fused(*(torch.from_numpy(x) for x in args),
                                           sliding_window=window, chunk_size=chunk)
    _close(got, ref)
    assert launch_counts() == [0, 0, 0]


@pytest.mark.parametrize("case", ["kv_len", "position_zero"])
def test_fused_decode_edges(case):
    B, H, KV, W, D = 1, 4, 2, 32, 8
    q, kk, vv, kn, vn = _decode_inputs(B, H, KV, W, D, seed=10)
    q_pos = np.array([[9]] if case == "kv_len" else [[0]], np.int32)
    kv_len = 16 if case == "kv_len" else None
    kv_pos = np.tile(np.arange(W, dtype=np.int32), (B, 1))
    args = (q, kk, vv, kn, vn, q_pos, kv_pos)
    ref = jfa.flash_attention_decode_fused(*(jnp.asarray(x) for x in args), block_k=8, kv_len=kv_len)
    got = tfa.flash_attention_decode_fused(*(torch.from_numpy(x) for x in args), kv_len=kv_len)
    _close(got, ref)


@pytest.mark.parametrize("layer_idx", [0, 2])
def test_fused_decode_stacked_matches_pallas(layer_idx):
    L, B, KV, G, S, D = 3, 2, 4, 2, 64, 16
    H = KV * G
    ks, vs = _rand((L, B, KV, S, D), 20) * 0.3, _rand((L, B, KV, S, D), 21) * 0.3
    q, kn, vn = _rand((B, H, 1, D), 22), _rand((B, KV, 1, D), 23), _rand((B, KV, 1, D), 24)
    q_pos = np.array([[17], [40]], np.int32)
    ref = jfa.flash_attention_decode_fused_stacked(
        *(jnp.asarray(x) for x in (q, ks, vs, kn, vn, q_pos)),
        jnp.asarray([layer_idx], jnp.int32), kv_len=48,
    )
    got = tfa.flash_attention_decode_fused_stacked(
        *(torch.from_numpy(x) for x in (q, ks, vs, kn, vn, q_pos)), layer_idx, kv_len=48,
    )
    _close(got, ref)


# ---------------------------------------------------------------------------
# commit
# ---------------------------------------------------------------------------

L_, B_, KV_, S_, D_ = 3, 4, 2, 128, 16


def _commit_case(seed, pos_override=None, seq_ids=None):
    rng = np.random.default_rng(seed)
    kc, vc = rng.standard_normal((2, L_, B_, KV_, S_, D_)).astype(np.float32)
    kr, vr = rng.standard_normal((2, L_, B_, KV_, 1, D_)).astype(np.float32)
    pos = rng.integers(0, S_, size=(B_, 1)).astype(np.int32)
    if pos_override is not None:
        pos_override(pos)
    ref_k, ref_v = jkc.kv_commit_rows(
        *(jnp.asarray(x, jnp.bfloat16) for x in (kc, vc, kr, vr)), jnp.asarray(pos),
        None if seq_ids is None else jnp.asarray(seq_ids),
    )
    tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (kc, vc))
    kc_t, vc_t = tk.clone(), tv.clone()
    out = tkc.kv_commit_rows(
        kc_t, vc_t, *(torch.from_numpy(x).to(torch.bfloat16) for x in (kr, vr)),
        torch.from_numpy(pos), None if seq_ids is None else torch.from_numpy(seq_ids),
    )
    assert out[0] is kc_t and out[1] is vc_t  # in place
    for got, ref in ((kc_t, ref_k), (vc_t, ref_v)):
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref.astype(jnp.float32)))
    return tk, kc_t


def test_commit_matches_pallas(launch_counts):
    _commit_case(0)
    assert launch_counts() == [0, 0, 0]


def test_commit_negative_slot_drops():
    before, after = _commit_case(1, pos_override=lambda p: p.__setitem__((1, 0), -1))
    assert torch.equal(after[:, 1], before[:, 1])


def test_commit_seq_id_routing():
    _commit_case(2, seq_ids=np.array([2, 0, 3, 1], np.int32))


def test_commit_out_of_range_line_drops():
    before, after = _commit_case(4, seq_ids=np.array([2, -1, B_ + 3, 1], np.int32))
    assert torch.equal(after[:, 0], before[:, 0]) and torch.equal(after[:, 3], before[:, 3])


def test_commit_multi_row_window():
    """T > 1 rows per line (a departure from the TPU kernel, which takes
    T == 1 only): matches the JAX package's scatter semantics."""
    rng = np.random.default_rng(5)
    kc = torch.from_numpy(rng.standard_normal((L_, B_, KV_, S_, D_)).astype(np.float32))
    vc = kc.clone()
    kr = torch.from_numpy(rng.standard_normal((L_, B_, KV_, 3, D_)).astype(np.float32))
    slots = torch.tensor([[5, 6, 7], [0, -1, 127], [9, 10, 200], [1, 2, 3]], dtype=torch.int32)
    want = kc.clone()
    for b in range(B_):
        for t in range(3):
            s = int(slots[b, t])
            if 0 <= s < S_:
                want[:, b, :, s] = kr[:, b, :, t]
    tkc.kv_commit_rows(kc, vc, kr, kr, slots)
    assert torch.equal(kc, want) and torch.equal(vc, want)


# ---------------------------------------------------------------------------
# wrapper contract on the CPU
# ---------------------------------------------------------------------------


def test_wrappers_raise_on_unsupported_dtype_and_shape():
    q, k = torch.zeros((1, 4, 8, 16), dtype=torch.float16), torch.zeros((1, 2, 8, 16), dtype=torch.float16)
    with pytest.raises(TypeError):
        tfa.flash_attention_prefill(q, k, k, torch.zeros((1, 8)), torch.zeros((1, 8)))
    with pytest.raises(ValueError):  # head_dim not a multiple of 8
        qd = torch.zeros((1, 4, 8, 12))
        kd = torch.zeros((1, 2, 8, 12))
        tfa.flash_attention_prefill(qd, kd, kd, torch.zeros((1, 8)), torch.zeros((1, 8)))
    with pytest.raises(ValueError):  # heads not divisible by kv heads
        tfa.flash_attention_prefill(torch.zeros((1, 3, 8, 16)), torch.zeros((1, 2, 8, 16)),
                                    torch.zeros((1, 2, 8, 16)), torch.zeros((1, 8)), torch.zeros((1, 8)))
    with pytest.raises(ValueError):  # decode takes one query position
        tfa.flash_attention_decode_fused(torch.zeros((1, 4, 2, 16)), torch.zeros((1, 2, 8, 16)),
                                         torch.zeros((1, 2, 8, 16)), torch.zeros((1, 2, 1, 16)),
                                         torch.zeros((1, 2, 1, 16)), torch.zeros((1, 1)), torch.zeros((1, 8)))
    cache = torch.zeros((2, 2, 2, 8, 16), dtype=torch.float16)
    with pytest.raises(TypeError):
        tkc.kv_commit_rows(cache, cache, cache[:, :, :, :1], cache[:, :, :, :1],
                           torch.zeros((2, 1), dtype=torch.int32))
    with pytest.raises(ValueError):  # rows whose kv-head count disagrees with the cache
        c32 = cache.float()
        tkc.kv_commit_rows(c32, c32, c32[:, :, :1, :1], c32[:, :, :1, :1],
                           torch.zeros((2, 1), dtype=torch.int32))
