"""The port's sampler (``nxdi_tpu_torch/ops/sampling.py``) against the JAX
package's (``nxdi_tpu/ops/sampling.py``) on the CPU.

Both take the same logits, sampling rows and uniforms: ``u`` is drawn with
``jax.random.uniform(key, (B, 1), float32)`` exactly as the JAX function
draws it, and fed to the port, so the tokens must be EQUAL — over 200+ keys,
over a grid of top_k / top_p / temperature, and with bf16-rounded logits
that tie, including ties at rank k. The port's own draws (a counter-based
hash of (seed, counter, row)) are checked for their distribution and their
key schedule."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nxdi_tpu.ops import sampling as js
from nxdi_tpu_torch.ops import sampling as ts

from test_torch_slice import one_torch_thread


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with one_torch_thread():
        yield


B, V = 8, 300


@functools.lru_cache(maxsize=None)
def _jax_sampler(global_topk, deterministic):
    return jax.jit(functools.partial(js.topk_topp_temperature_sample, global_topk=global_topk,
                                     deterministic=deterministic))


def _logits(seed, bf16=True, shape=(B, V), scale=3.0):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32) * scale
    if bf16:  # bf16 logits tie often
        x = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    return x


def _both(logits, sp, key, global_topk=256, deterministic=False):
    """(JAX tokens, port tokens) for one key, the port fed JAX's uniform."""
    want = np.asarray(_jax_sampler(global_topk, deterministic)(
        jnp.asarray(logits), jnp.asarray(sp), key))
    u = None if deterministic else torch.from_numpy(
        np.array(jax.random.uniform(key, (logits.shape[0], 1), dtype=jnp.float32)))
    got = ts.topk_topp_temperature_sample(
        torch.from_numpy(np.array(logits)), torch.from_numpy(np.array(sp)), u=u,
        global_topk=global_topk, deterministic=deterministic).numpy()
    return want, got


def test_sampler_matches_jax_over_keys():
    sp = js.prepare_sampling_params(B, [50], [0.9], [0.8])
    for k in range(240):
        want, got = _both(_logits(k, bf16=k % 2 == 0), sp, jax.random.PRNGKey(k))
        np.testing.assert_array_equal(got, want, err_msg=f"key {k}")


@pytest.mark.parametrize("top_k", [0, 1, 5, 50, 1000])
@pytest.mark.parametrize("top_p", [0.0, 0.5, 0.9, 1.0])
def test_sampler_grid_matches_jax(top_k, top_p):
    for temperature in (0.1, 0.7, 1.0, 2.0):
        sp = js.prepare_sampling_params(B, [top_k], [top_p], [temperature])
        for k in range(6):
            want, got = _both(_logits(100 + k), sp, jax.random.PRNGKey(1000 * top_k + k))
            np.testing.assert_array_equal(got, want, err_msg=f"T {temperature} key {k}")


def test_sampler_per_row_params_match_jax():
    sp = js.prepare_sampling_params(B, [0, 1, 5, 50, 1000, 3, 20, 2],
                                    [1.0, 0.5, 0.9, 0.0, 0.7, 1.0, 0.3, 0.95],
                                    [1.0, 0.1, 2.0, 0.7, 1.3, 0.5, 1.0, 0.9])
    for k in range(40):
        want, got = _both(_logits(500 + k), sp, jax.random.PRNGKey(k))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("global_topk", [8, 16, 64])
def test_top_k_ties_at_rank_k_match_jax(global_topk):
    """Few distinct values, so the k-th value is tied across many indices:
    the candidate set and its order are ``jax.lax.top_k``'s (lower index
    first), and so are the sampled tokens."""
    rng = np.random.default_rng(global_topk)
    for trial in range(20):
        x = rng.integers(-3, 4, size=(B, V)).astype(np.float32) * 0.5
        vals, idx = jax.lax.top_k(jnp.asarray(x), global_topk)
        pv, pi = ts.top_k_lower_index_first(torch.from_numpy(x), global_topk)
        np.testing.assert_array_equal(pv.numpy(), np.asarray(vals))
        np.testing.assert_array_equal(pi.numpy(), np.asarray(idx))
        sp = js.prepare_sampling_params(B, [global_topk // 2], [0.8], [1.0])
        want, got = _both(x, sp, jax.random.PRNGKey(trial), global_topk=global_topk)
        np.testing.assert_array_equal(got, want)


def test_deterministic_matches_jax():
    for top_k, top_p, t in ((50, 0.9, 0.8), (0, 1.0, 1.0), (5, 0.5, 2.0)):
        sp = js.prepare_sampling_params(B, [top_k], [top_p], [t])
        for k in range(20):
            want, got = _both(_logits(900 + k), sp, jax.random.PRNGKey(k), deterministic=True)
            np.testing.assert_array_equal(got, want)


def test_sample_greedy_rows_exact():
    """``sample()``: rows with top_k 1 are the argmax (first index on ties),
    the others the sampler's draw, as in the JAX package."""
    sp = js.prepare_sampling_params(B, [1, 50, 1, 0, 1, 5, 1, 20], [1.0], [0.7])
    for k in range(30):
        x = _logits(2000 + k)
        key = jax.random.PRNGKey(k)
        want = np.asarray(js.sample(jnp.asarray(x), jnp.asarray(sp), rng=key, do_sample=True))
        u = torch.from_numpy(np.array(jax.random.uniform(key, (B, 1), dtype=jnp.float32)))
        got = ts.sample(torch.from_numpy(x), torch.from_numpy(sp), do_sample=True, u=u).numpy()
        np.testing.assert_array_equal(got, want)
        greedy = sp[:, 0] == 1
        np.testing.assert_array_equal(got[greedy], x[greedy].argmax(-1))
        np.testing.assert_array_equal(
            ts.sample(torch.from_numpy(x), torch.from_numpy(sp)).numpy(), x.argmax(-1))


def _filtered_probs(logits, top_k, top_p, temperature):
    """The distribution the sampler draws from (numpy, float64)."""
    order = np.argsort(-logits, kind="stable")
    vals = logits[order].astype(np.float64)
    keep = np.arange(vals.size) < top_k if top_k > 0 else np.ones(vals.size, bool)
    v = np.where(keep, vals, -np.inf) / temperature
    p = np.exp(v - v.max())
    p /= p.sum()
    excl = np.cumsum(p) - p
    keep &= (excl < top_p) | (np.arange(vals.size) == 0)
    v = np.where(keep, v, -np.inf)
    q = np.exp(v - v.max())
    q /= q.sum()
    out = np.zeros(logits.size)
    out[order] = q
    return out


def test_own_draws_follow_the_filtered_distribution():
    """20000 rows of one logit row, one key: each row draws its own uniform,
    so the token frequencies estimate the filtered distribution. Bound: 0.015
    per token, about 4.3 standard deviations of a frequency at N = 20000."""
    N = 20000
    row = _logits(7, shape=(1, 40), scale=1.5)[0]
    for top_k, top_p, t in ((10, 0.9, 0.8), (0, 1.0, 1.0), (20, 0.6, 1.5)):
        sp = torch.tensor([[top_k, top_p, t]] * N, dtype=torch.float32)
        toks = ts.sample(torch.from_numpy(np.tile(row, (N, 1))), sp,
                         rng=torch.tensor([3, 41]), do_sample=True).numpy()
        freq = np.bincount(toks, minlength=row.size) / N
        want = _filtered_probs(row, top_k, top_p, t)
        assert np.abs(freq - want).max() < 0.015, (top_k, top_p, t)
        assert (freq[want == 0] == 0).all()


def test_key_schedule_determinism():
    u = ts.uniform_from_key
    k = torch.tensor([5, 9])
    assert torch.equal(u(k, 8), u(k.clone(), 8))
    a, b = u(k, 8)[:, 0], u(ts.next_step_rng(k), 8)[:, 0]
    assert torch.equal(ts.next_step_rng(k), torch.tensor([5, 10]))
    assert not torch.equal(a, b)  # another counter, other draws
    assert len(set(a.tolist())) == 8  # another row, another draw
    assert not torch.equal(u(torch.tensor([6, 9]), 8), u(k, 8))  # another seed
    many = u(torch.stack([torch.tensor([0, c]) for c in range(5000)]), 4).reshape(-1)
    assert ((many >= 0) & (many < 1)).all()
    assert abs(many.mean().item() - 0.5) < 0.01
    assert len(set(many.tolist())) > 0.99 * many.numel()
    # (seed, counter) pairs hash as their low 32 bits: the schedule's
    # counter can run past 2**32 without an overflow
    assert torch.equal(u(torch.tensor([5, 9 + 2 ** 32]), 8), u(k, 8))
    sched = ts.StepRngSchedule(7)
    first = [sched.next().tolist() for _ in range(3)]
    assert first == [[7, 1], [7, 2], [7, 3]]
    sched.advance(4)
    assert sched.next().tolist() == [7, 8]
    sched.advance(-1)  # a loop that ran one iteration advances nothing
    assert sched.next().tolist() == [7, 9]


def test_sampling_params_accept_do_sample():
    p = ts.SamplingParams(max_new_tokens=4, do_sample=True, top_k=50, top_p=0.9,
                          temperature=0.8)
    np.testing.assert_array_equal(p.tensor(2), js.SamplingParams(
        max_new_tokens=4, do_sample=True, top_k=50, top_p=0.9, temperature=0.8).tensor(2))
    assert ts.SamplingParams(top_k=50).row() == (1.0, 1.0, 1.0)
