"""``async_mode``: the port's device-resident decode loop, on the CPU, held
against the JAX package's ``async_mode`` loop and the port's own sync loop
on the tiny random llama (mirrors ``tests/integration/test_async_execution.py``).

Greedy tokens must be identical (batch 1 and 2, an EOS mid-run); the
forward's ``next_inputs`` must equal the JAX forward's exactly (ints, and
the same sampling params).
"""

import numpy as np
import pytest
import torch

import jax

from nxdi_tpu.generation.hf_adapter import HuggingFaceGenerationAdapter as JaxAdapter
from nxdi_tpu_torch.config import TorchConfig
from nxdi_tpu_torch.generation.hf_adapter import HuggingFaceGenerationAdapter
from test_torch_slice import PROMPT, fresh_jax_compiles, jax_app, port_app

# the inputs the async decode loop carries from one step to the next
NEXT_INPUT_KEYS = ("input_ids", "position_ids", "last_token_index", "sampling_params")


@pytest.fixture(autouse=True, scope="module")
def _fresh_jax_compiles():
    with fresh_jax_compiles():
        yield


def _batch2():
    prompt = np.zeros((2, 6), dtype=np.int64)
    prompt[0] = [5, 9, 3, 17, 2, 8]
    prompt[1, :3] = [7, 13, 21]
    return prompt, (prompt != 0).astype(np.int32)


def _three_ways(hf_model, hf_cfg, prompt, mask, batch, **gen):
    """(port async, JAX async, port sync) generate() outputs."""
    kw = dict(batch_size=batch, async_mode=True)
    tapp = port_app(hf_model, hf_cfg, **kw)
    assert tapp.async_supported
    japp = jax_app(hf_model, hf_cfg, **kw)
    assert japp.async_supported
    sync = port_app(hf_model, hf_cfg, params=tapp.params, batch_size=batch)
    assert not sync.async_supported
    calls = []
    inner = tapp.token_gen_device

    def counted(*a, **k):
        calls.append(a[1])
        return inner(*a, **k)

    tapp.token_gen_device = counted
    outs = [HuggingFaceGenerationAdapter(tapp).generate(prompt, attention_mask=mask, **gen),
            JaxAdapter(japp).generate(prompt, attention_mask=mask, **gen),
            HuggingFaceGenerationAdapter(sync).generate(prompt, attention_mask=mask, **gen)]
    assert calls, "the async loop never ran"
    return outs


@pytest.mark.parametrize("batch", [1, 2])
def test_async_matches_jax_async_and_sync(tiny_hf_llama, batch):
    hf_model, hf_cfg = tiny_hf_llama
    prompt, mask = (PROMPT, None) if batch == 1 else _batch2()
    port, ref, sync = _three_ways(hf_model, hf_cfg, prompt, mask, batch, max_new_tokens=12)
    np.testing.assert_array_equal(port, ref)
    np.testing.assert_array_equal(port, sync)


@pytest.mark.parametrize("batch", [1, 2])
def test_async_eos_mid_run(tiny_hf_llama, batch):
    """The 5th new token of row 0 is declared EOS: rows stop at their first
    EOS, later tokens are padding, and the output is as long as the sync
    loop's."""
    hf_model, hf_cfg = tiny_hf_llama
    prompt, mask = (PROMPT, None) if batch == 1 else _batch2()
    full = HuggingFaceGenerationAdapter(port_app(hf_model, hf_cfg, batch_size=batch)).generate(
        prompt, attention_mask=mask, max_new_tokens=16)
    n0 = int(prompt.shape[1] if mask is None else mask[0].sum())
    eos = int(full[0, n0 + 4])
    port, ref, sync = _three_ways(hf_model, hf_cfg, prompt, mask, batch, max_new_tokens=16,
                                  eos_token_id=eos, pad_token_id=0)
    np.testing.assert_array_equal(port, ref)
    np.testing.assert_array_equal(port, sync)
    got = port[0, n0:]
    np.testing.assert_array_equal(got[:5], full[0, n0:n0 + 5])
    assert np.all(got[5:] == 0), got


def _next_inputs(app, ids, pos, lti, sp):
    out = app.forward(ids, pos, last_token_index=lti, sampling_params=sp)
    nxt = out["next_inputs"]
    return {k: np.asarray(v.numpy() if isinstance(v, torch.Tensor) else jax.device_get(v))
            for k, v in nxt.items()}


def test_next_inputs_match_jax_forward(tiny_hf_llama):
    """Context encoding (rows of different lengths) and one token-generation
    step: the same next_inputs as the JAX forward, and the token-generation
    step's are its own (static) inputs, rewritten in place."""
    hf_model, hf_cfg = tiny_hf_llama
    prompt, mask = _batch2()
    kw = dict(batch_size=2, async_mode=True)
    tapp, japp = port_app(hf_model, hf_cfg, **kw), jax_app(hf_model, hf_cfg, **kw)
    ids = prompt.astype(np.int32)
    pos = np.tile(np.arange(6, dtype=np.int32), (2, 1))
    lti = (mask.sum(axis=1) - 1).astype(np.int32)
    sp = np.array([[1.0, 1.0, 1.0], [1.0, 0.5, 0.7]], np.float32)
    got, want = (_next_inputs(a, ids, pos, lti, sp) for a in (tapp, japp))
    assert set(got) == set(want) == set(NEXT_INPUT_KEYS)
    for k in NEXT_INPUT_KEYS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(got["position_ids"][:, 0], lti + 1)
    step = (got["input_ids"], got["position_ids"], got["last_token_index"],
            got["sampling_params"])
    got2, want2 = (_next_inputs(a, *step) for a in (tapp, japp))
    for k in NEXT_INPUT_KEYS:
        np.testing.assert_array_equal(got2[k], want2[k], err_msg=k)
    tkg = tapp.models["token_generation_model"]
    out = tkg.forward(tapp.params, tapp.kv_cache,
                      dict(zip(("input_ids", "position_ids", "last_token_index",
                                "sampling_params"), step)))[0]
    bound = tkg.bucket_graphs[tkg.last_bucket].bound
    assert all(out["next_inputs"][k] is bound[k] for k in NEXT_INPUT_KEYS)


def test_async_eager_equals_staged(tiny_hf_llama):
    """graphs=False (every dispatch from fresh inputs) runs the same async
    loop to the same tokens."""
    hf_model, hf_cfg = tiny_hf_llama
    prompt, mask = _batch2()
    staged = port_app(hf_model, hf_cfg, batch_size=2, async_mode=True)
    eager = port_app(hf_model, hf_cfg, params=staged.params, batch_size=2, async_mode=True)
    for w in eager.models.values():
        w.graphs = False
    outs = [HuggingFaceGenerationAdapter(a).generate(prompt, attention_mask=mask,
                                                     max_new_tokens=12)
            for a in (staged, eager)]
    np.testing.assert_array_equal(*outs)
    assert not eager.models["token_generation_model"].bucket_graphs


def test_async_mode_config():
    """The key is accepted (and kept through a config round trip); the
    paged layout refuses it (its steps need host-built block tables)."""
    assert TorchConfig(async_mode=True).async_mode is True
    assert TorchConfig.from_dict(TorchConfig(async_mode=True).to_dict()).async_mode is True
    with pytest.raises(NotImplementedError, match="async_mode"):
        TorchConfig(async_mode=True, is_block_kv_layout=True, pa_block_size=8)
