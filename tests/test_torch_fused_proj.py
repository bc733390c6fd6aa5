"""The plain versions of the port's fused-projection kernels (what their
wrappers run on CPU tensors) held against the JAX package's Pallas kernels
``fused_mlp``, ``fused_mlp_stacked``, ``qkv_matmul`` and
``qkv_matmul_stacked``, which run in interpret mode off the TPU. Same numpy
inputs to both; ``fuse_qkv_weights`` / ``fuse_qkv_biases`` against the JAX
functions bit for bit.

Tolerances: float32 1e-5 (sums in another order). bfloat16 2e-2: both sides
accumulate in f32 and round the MLP's act(g) * u and the output to bfloat16
at the same points, so they differ by the order of f32 sums, which can move a
rounding by one bfloat16 ulp (3.9e-3 at 0.5-1, 7.8e-3 at 1-2); the outputs
here stay below 2 in magnitude.

The CUDA kernels themselves run only on the card: ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` hold them against these plain versions there."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nxdi_tpu.models import dense as jdense
from nxdi_tpu.ops.kernels import fused_proj as jfp
from nxdi_tpu_torch.models import dense as tdense
from nxdi_tpu_torch.ops.kernels import fused_proj as tfp
from test_torch_slice import fresh_jax_compiles

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True, scope="module")
def _fresh_jax_compiles():
    # the Pallas references compile without a persistent cache an earlier
    # test on this worker left on (ROADMAP Queue 3)
    with fresh_jax_compiles():
        yield


def _rand(shape, seed, scale=0.1):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _close(port, ref, dtype):
    np.testing.assert_allclose(port.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               atol=TOL[dtype], rtol=0)


@pytest.fixture
def launch_counts():
    """The wrappers' launch counters, reset; CPU tensors must leave them 0."""
    fns = (tfp.fused_mlp, tfp.qkv_matmul)
    for fn in fns:
        fn.launches = 0
    yield lambda: [fn.launches for fn in fns]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", list(tfp.KERNEL_ACTS))
@pytest.mark.parametrize("m", [8, 13, 40])
def test_fused_mlp(m, act, dtype, launch_counts):
    H, I = 64, 256
    x, g, u, d = _rand((m, H), 0, 1.0), _rand((H, I), 1), _rand((H, I), 2), _rand((I, H), 3)
    want = jfp.fused_mlp(*(jnp.asarray(a, JDT[dtype]) for a in (x, g, u, d)), act=act,
                         block_m=m, block_i=64)
    got = tfp.fused_mlp(*(torch.from_numpy(a).to(TDT[dtype]) for a in (x, g, u, d)), act=act)
    assert got.dtype == TDT[dtype] and got.shape == (m, H)
    _close(got, want, dtype)
    assert launch_counts() == [0, 0]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_mlp_stacked_middle_layer(dtype, launch_counts):
    L, M, H, I, li = 5, 12, 64, 128, 2
    x = _rand((M, H), 4, 1.0)
    gs, us, ds = _rand((L, H, I), 5), _rand((L, H, I), 6), _rand((L, I, H), 7)
    want = jfp.fused_mlp_stacked(*(jnp.asarray(a, JDT[dtype]) for a in (x, gs, us, ds)),
                                 jnp.array([li], jnp.int32), block_m=M, block_i=64)
    tx, tg, tu, td = (torch.from_numpy(a).to(TDT[dtype]) for a in (x, gs, us, ds))
    got = tfp.fused_mlp_stacked(tx, tg, tu, td, li)
    _close(got, want, dtype)
    # the stacked entry is the plain entry on the layer's slice, bit for bit
    assert torch.equal(got, tfp.fused_mlp(tx, tg[li], tu[li], td[li]))
    assert launch_counts() == [0, 0]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("m", [16, 7])
def test_qkv_matmul(m, bias, dtype, launch_counts):
    H, T = 64, 192
    x, w = _rand((m, H), 8, 1.0), _rand((H, T), 9)
    b = _rand((T,), 10) if bias else None
    jb = jnp.asarray(b, JDT[dtype]) if bias else None
    want = jfp.qkv_matmul(jnp.asarray(x, JDT[dtype]), jnp.asarray(w, JDT[dtype]), jb,
                          block_m=m, block_n=64)
    tb = torch.from_numpy(b).to(TDT[dtype]) if bias else None
    got = tfp.qkv_matmul(torch.from_numpy(x).to(TDT[dtype]), torch.from_numpy(w).to(TDT[dtype]),
                         tb)
    assert got.dtype == TDT[dtype]
    _close(got, want, dtype)
    assert launch_counts() == [0, 0]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias", [False, True])
def test_qkv_matmul_stacked_middle_layer(bias, dtype, launch_counts):
    L, M, H, T, li = 3, 11, 64, 192, 1
    x, ws = _rand((M, H), 11, 1.0), _rand((L, H, T), 12)
    bs = _rand((L, T), 13) if bias else None
    want = jfp.qkv_matmul_stacked(
        jnp.asarray(x, JDT[dtype]), jnp.asarray(ws, JDT[dtype]), jnp.array([li], jnp.int32),
        jnp.asarray(bs, JDT[dtype]) if bias else None, block_m=M, block_n=64)
    got = tfp.qkv_matmul_stacked(
        torch.from_numpy(x).to(TDT[dtype]), torch.from_numpy(ws).to(TDT[dtype]), li,
        torch.from_numpy(bs).to(TDT[dtype]) if bias else None)
    _close(got, want, dtype)
    assert launch_counts() == [0, 0]


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_fuse_qkv_weights_match_jax(tp):
    """The interleave equals the JAX package's bit for bit, and the port's
    rank-block regroup (models/base.py) undoes it."""
    Hin, Tq, Tk, Tv = 32, 64, 16, 16
    q, k, v = _rand((Hin, Tq), 14), _rand((Hin, Tk), 15), _rand((Hin, Tv), 16)
    fused = tdense.fuse_qkv_weights([q, k, v], tp)
    np.testing.assert_array_equal(fused, jdense.fuse_qkv_weights([q, k, v], tp))
    fb = tdense.fuse_qkv_biases([q[0].copy(), k[0].copy(), v[0].copy()], tp)
    np.testing.assert_array_equal(fb, jdense.fuse_qkv_biases([q[0], k[0], v[0]], tp))
    x = _rand((2, 3, Hin), 17, 1.0)
    t = (x @ fused).reshape(2, 3, tp, (Tq + Tk + Tv) // tp)
    np.testing.assert_allclose(t[..., : Tq // tp].reshape(2, 3, Tq), x @ q, atol=1e-5)
    np.testing.assert_allclose(t[..., Tq // tp: (Tq + Tk) // tp].reshape(2, 3, Tk), x @ k,
                               atol=1e-5)
    np.testing.assert_allclose(t[..., (Tq + Tk) // tp:].reshape(2, 3, Tv), x @ v, atol=1e-5)


def test_unsupported_activation_raises():
    x = torch.zeros((4, 8))
    w = torch.zeros((8, 16))
    with pytest.raises(NotImplementedError, match="activation"):
        tfp.fused_mlp(x, w, w, w.t(), act="swish_beta")
