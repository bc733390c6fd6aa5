"""The PyTorch port's plain ops held against the JAX package's, f32 on the
CPU: the same numpy inputs go through both, tolerance 1e-5."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nxdi_tpu.ops import attention as jattn
from nxdi_tpu.ops import norms as jnorms
from nxdi_tpu.ops import rope as jrope
from nxdi_tpu_torch.ops import attention as tattn
from nxdi_tpu_torch.ops import norms as tnorms
from nxdi_tpu_torch.ops import rope as trope

from test_torch_slice import one_torch_thread


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with one_torch_thread():
        yield


TOL = 1e-5


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), atol=tol, rtol=tol)


def test_rms_norm():
    x, w = _rand((2, 5, 64), 0), _rand((64,), 1)
    _close(tnorms.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5),
           jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))


@pytest.mark.parametrize("scaling", [
    None,
    {"rope_type": "llama3", "factor": 32.0, "low_freq_factor": 1.0, "high_freq_factor": 4.0,
     "original_max_position_embeddings": 8192},
])
def test_inv_freq_builders(scaling):
    port = trope.inv_freq_from_hf_config(64, 500000.0, scaling)
    ref = jrope.inv_freq_from_hf_config(64, 500000.0, scaling)
    np.testing.assert_array_equal(port, ref)
    np.testing.assert_array_equal(trope.default_inv_freq(16, 1e4), jrope.default_inv_freq(16, 1e4))
    np.testing.assert_array_equal(
        trope.llama3_scaled_inv_freq(128, 5e5, 8.0), jrope.llama3_scaled_inv_freq(128, 5e5, 8.0)
    )


def test_rope_cos_sin_and_rotation():
    inv = trope.llama3_scaled_inv_freq(16, 500000.0, factor=32.0)
    pos = np.tile(np.arange(0, 300, 23, dtype=np.int32), (2, 1))
    cos_t, sin_t = trope.rope_cos_sin(torch.from_numpy(pos), inv)
    cos_j, sin_j = jrope.rope_cos_sin(jnp.asarray(pos), inv)
    _close(cos_t, cos_j)
    _close(sin_t, sin_j)
    q, k = _rand((2, 4, pos.shape[1], 16), 2), _rand((2, 2, pos.shape[1], 16), 3)
    qt, kt = trope.apply_rotary_pos_emb(torch.from_numpy(q), torch.from_numpy(k), cos_t, sin_t)
    qj, kj = jrope.apply_rotary_pos_emb(jnp.asarray(q), jnp.asarray(k), cos_j, sin_j)
    _close(qt, qj)
    _close(kt, kj)


def test_masks():
    q_pos = np.array([[3, 4, 5], [10, 11, 12]], np.int32)
    kv_pos = np.tile(np.arange(14, dtype=np.int32), (2, 1))
    qt, kt, qj, kj = torch.from_numpy(q_pos), torch.from_numpy(kv_pos), jnp.asarray(q_pos), jnp.asarray(kv_pos)
    np.testing.assert_array_equal(tattn.causal_mask_from_positions(qt, kt).numpy(),
                                  jattn.causal_mask_from_positions(qj, kj))
    np.testing.assert_array_equal(tattn.sliding_window_mask_from_positions(qt, kt, 4).numpy(),
                                  jattn.sliding_window_mask_from_positions(qj, kj, 4))
    np.testing.assert_array_equal(tattn.chunked_attention_mask_from_positions(qt, kt, 4).numpy(),
                                  jattn.chunked_attention_mask_from_positions(qj, kj, 4))


@pytest.mark.parametrize("H,KV", [(4, 4), (8, 2)])
def test_grouped_attention(H, KV):
    B, Sq, Skv, D = 2, 5, 9, 16
    q, k, v = _rand((B, H, Sq, D), 4), _rand((B, KV, Skv, D), 5), _rand((B, KV, Skv, D), 6)
    mask = np.random.default_rng(7).random((B, Sq, Skv)) > 0.3
    _close(tattn.grouped_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                   torch.from_numpy(mask)),
           jattn.grouped_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask)))


@pytest.mark.parametrize("window,chunk", [(None, None), (6, None), (None, 8)])
def test_attention_with_positions(window, chunk):
    B, H, KV, S, D = 2, 8, 2, 24, 16
    q, k, v = _rand((B, H, S, D), 8), _rand((B, KV, S, D), 9), _rand((B, KV, S, D), 10)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    t = [torch.from_numpy(x) for x in (q, k, v, pos)]
    j = [jnp.asarray(x) for x in (q, k, v, pos)]
    _close(tattn.attention_with_positions(t[0], t[1], t[2], t[3], t[3],
                                          sliding_window=window, chunk_size=chunk),
           jattn.attention_with_positions(j[0], j[1], j[2], j[3], j[3],
                                          sliding_window=window, chunk_size=chunk))


@pytest.mark.parametrize("window", [None, 8])
def test_attention_two_part(window):
    B, H, KV, W, D = 2, 8, 2, 32, 16
    q, kk, vv = _rand((B, H, 1, D), 11), _rand((B, KV, W, D), 12), _rand((B, KV, W, D), 13)
    k2, v2 = _rand((B, KV, 1, D), 14), _rand((B, KV, 1, D), 15)
    q_pos = np.array([[13], [20]], np.int32)
    kv_pos = np.tile(np.arange(W, dtype=np.int32), (B, 1))
    kv_pos = np.where(kv_pos == q_pos, 2 ** 30, kv_pos).astype(np.int32)  # poisoned write slot
    args = (q, kk, vv, k2, v2, q_pos, kv_pos, q_pos)
    _close(tattn.attention_two_part(*[torch.from_numpy(a) for a in args], sliding_window=window),
           jattn.attention_two_part(*[jnp.asarray(a) for a in args], sliding_window=window))
