"""The last dense families of the port, part 2: GLM-4, StableLM, Persimmon,
Apertus and Orion, each held to the JAX package's family and HF as
``test_torch_dense_tier3.py`` describes (that file holds the cases and the
checks), and the ops they add (xIELU, the per-head biased q / k LayerNorm)
to the JAX functions."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nxdi_tpu.models import base as jbase
from nxdi_tpu_torch.models import base as tbase
from nxdi_tpu_torch.models.apertus import modeling_apertus as tap

from test_torch_dense_tier3 import check_converter, check_family, fresh_jax_compiles

PART_2 = ["glm4", "stablelm", "persimmon", "apertus", "orion"]


@pytest.fixture(autouse=True, scope="module")
def _fresh_jax_compiles():
    with fresh_jax_compiles():
        yield


@pytest.mark.parametrize("case", PART_2)
def test_family_matches_jax_and_hf(case):
    check_family(case)


@pytest.mark.parametrize("case", PART_2)
def test_converter_matches_jax(case):
    check_converter(case)


def test_xielu_matches_jax():
    """xIELU against the JAX function on both sides of zero (and inside the
    bf16-rounded eps), f32 and bf16, with scalars baked from HF's raw bf16
    learnables the way both converters bake them."""
    from nxdi_tpu.models.apertus import modeling_apertus as jap

    rng = np.random.default_rng(5)
    x = np.concatenate([rng.standard_normal(256) * 4, [0.0, -1e-7, -1e-6, 1e-7]]).astype(
        np.float32)
    raw_p, raw_n = np.float32(0.3), np.float32(-0.7)
    ap, an = tap.xielu_scalars(torch.tensor([raw_p]), torch.tensor([raw_n])).values()
    jp = jap._softplus_bf16(np.array([raw_p]))
    assert ap.numpy().tolist() == jp.tolist()
    for dt, jdt, tol in ((torch.float32, jnp.float32, 1e-6), (torch.bfloat16, jnp.bfloat16, 0)):
        got = tbase.xielu(torch.from_numpy(x).to(dt), ap, an).float().numpy()
        want = np.asarray(jbase.xielu(jnp.asarray(x).astype(jdt), jnp.asarray(ap.numpy()),
                                      jnp.asarray(an.numpy())).astype(jnp.float32))
        np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
