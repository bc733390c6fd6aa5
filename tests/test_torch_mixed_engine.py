"""The port's mixed-dispatch engine (one packed ``mixed_model`` forward per
step) on the CPU — the kernels' plain versions — held against the JAX
package's ``InferenceEngine`` with ``mixed_dispatch=True`` (Pallas kernels in
interpret mode) and HF greedy, on the tiny random llama.

Mirrors ``tests/integration/test_mixed_dispatch.py``: one dispatch for a
step that packs a prefill with a decode row, parity under interleaved
arrivals; identical streams with mixed dispatch on and off; parity across
forced and natural preemption; chunked prefill with no prefix-prefill
submodel. ``test_mixed_gauges_preseeded`` is not mirrored: it reads the
telemetry registry, which the port does not carry yet. Then
``tests/integration/test_fused_kernels.py::test_all_fused_flags_together`` at
tp = 1, through the mixed engine: fused QKV, the QKV and MLP kernels and the
ragged attention kernel together; streams token-identical to the JAX engine
and HF, the recorded strategies equal to the JAX app's."""

import numpy as np
import pytest

import jax

from nxdi_tpu_torch.models.convert import from_jax_params
from nxdi_tpu_torch.runtime.application import TAG_PREFIX_PREFILL
from nxdi_tpu_torch.runtime.model_wrapper import TAG_MIXED
from nxdi_tpu_torch.serving import InferenceEngine, SamplingParams, SchedulerConfig
from test_torch_engine import P0, P1, P2, _assert_same_tree, _both, _hf, _Pair, _streams
from test_torch_slice import fresh_jax_compiles

MIXED = dict(mixed_dispatch=True, pa_block_size=8, pa_num_blocks=32, ctx_batch_size=1,
             tkg_batch_size=3)
FUSED = dict(fused_qkv=True, qkv_kernel_enabled=True, mlp_kernel_enabled=True,
             attn_kernel_enabled=True)


@pytest.fixture(autouse=True, scope="module")
def _fresh_jax_compiles():
    # the JAX engine compiles without a persistent cache an earlier test left on
    with fresh_jax_compiles():
        yield


def _record_packs(app):
    """Wrap the mixed wrapper's forward: keeps, per dispatch, the number of
    tokens each row packed."""
    w = app.models[TAG_MIXED]
    inner = w.forward
    packs = []

    def fwd(params, cache, batch):
        rids = np.asarray(batch["mixed_row_ids"]).reshape(-1)
        packs.append(dict(zip(*np.unique(rids[rids >= 0], return_counts=True))))
        return inner(params, cache, batch)

    w.forward = fwd
    return packs


def _interleaved(tapp):
    """r0 prefills alone; r1 arrives and the next step packs r1's whole
    prefill with r0's decode token in ONE dispatch; r2 arrives later."""
    packs = _record_packs(tapp)

    def drive(eng, SP):
        assert eng.mixed
        r0 = eng.add_request(P0, SP(max_new_tokens=10))
        outs = eng.step()
        assert r0.prefill_done and len(r0.generated) == 1
        r1 = eng.add_request(P1, SP(max_new_tokens=12))
        if isinstance(eng, InferenceEngine):
            before = dict(eng.dispatches)
            outs += eng.step()
            delta = {k: v - before[k] for k, v in eng.dispatches.items() if v != before[k]}
            assert delta == {TAG_MIXED: 1}, delta
            assert packs[-1] == {r0.slot: 1, r1.slot: len(P1)}
        else:
            outs += eng.step()
        reqs = {0: r0, 1: r1, 2: eng.add_request(P2, SP(max_new_tokens=9))}
        return _streams(outs + eng.run(), reqs)

    return drive


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernels"])
def test_mixed_one_dispatch_and_parity_interleaved(tiny_hf_llama, kernels):
    hf_model, hf_cfg = tiny_hf_llama
    pair = _Pair(hf_model, hf_cfg, attn_kernel_enabled=kernels, **MIXED)
    assert pair.tapp.mixed_supported
    got, teng = _both(pair, _interleaved(pair.tapp), num_slots=3)
    assert got == {0: _hf(hf_model, P0, 10), 1: _hf(hf_model, P1, 12), 2: _hf(hf_model, P2, 9)}
    assert teng.dispatches[TAG_MIXED] == pair.jax_dispatches(TAG_MIXED)
    assert sum(teng.dispatches.values()) == teng.dispatches[TAG_MIXED]
    strategy = "mixed_ragged_kernel" if kernels else "mixed_ragged_xla"
    assert pair.strategies_match()[TAG_MIXED] == {strategy}


def test_mixed_on_off_identical_streams(tiny_hf_llama):
    """The same workload through the mixed engine and the split engine of
    the same paged geometry: identical streams."""
    hf_model, hf_cfg = tiny_hf_llama

    def run(mixed):
        kw = dict(MIXED, mixed_dispatch=mixed)
        pair = _Pair(hf_model, hf_cfg, **kw)
        eng = InferenceEngine(pair.tapp, SchedulerConfig(num_slots=3))
        assert eng.mixed is mixed
        reqs = {i: eng.add_request(p, SamplingParams(max_new_tokens=8))
                for i, p in enumerate((P0, P1, P2))}
        return _streams(eng.run(), reqs)

    on = run(True)
    assert on == run(False)
    assert on == {i: _hf(hf_model, p, 8) for i, p in enumerate((P0, P1, P2))}


@pytest.mark.parametrize("num_blocks", [16, 8], ids=["forced", "natural"])
def test_mixed_parity_across_preemption(tiny_hf_llama, num_blocks):
    """Forced eviction of the youngest request after one step (16 blocks),
    and a pool too small for both sequences (8 blocks): victims re-prefill
    prompt + generated through the packed forward."""
    hf_model, hf_cfg = tiny_hf_llama
    pair = _Pair(hf_model, hf_cfg, **dict(MIXED, pa_block_size=4, pa_num_blocks=num_blocks,
                                          tkg_batch_size=2))
    n = 10 if num_blocks == 16 else 12

    def drive(eng, SP):
        reqs = {0: eng.add_request(P0, SP(max_new_tokens=n)),
                1: eng.add_request(P1, SP(max_new_tokens=n))}
        outs = []
        if num_blocks == 16:
            outs = eng.step()
            victim = eng.preempt_youngest()
            assert victim is not None and victim.preemptions == 1
        outs += eng.run()
        assert sum(o.metrics["preemptions"] for o in outs) >= 1
        return _streams(outs, reqs)

    got, _ = _both(pair, drive, num_slots=2, watermark_blocks=1)
    assert got == {0: _hf(hf_model, P0, n), 1: _hf(hf_model, P1, n)}
    assert pair.strategies_match()[TAG_MIXED] == {"mixed_ragged_xla"}


def test_mixed_chunked_prefill_no_special_path(tiny_hf_llama):
    """chunk_size under mixed dispatch is packing policy: no prefix-prefill
    submodel is built, an 8-token prompt prefills in chunks of 3 across
    steps inside the packed forward, decodes interleave."""
    hf_model, hf_cfg = tiny_hf_llama
    pair = _Pair(hf_model, hf_cfg, **dict(MIXED, tkg_batch_size=2))
    assert TAG_PREFIX_PREFILL not in pair.tapp.models

    def drive(eng, SP):
        ra = eng.add_request(P0, SP(max_new_tokens=8))
        outs = eng.step()
        assert ra.num_prefilled == 3 and not ra.prefill_done
        reqs = {0: ra, 1: eng.add_request(P1, SP(max_new_tokens=6))}
        return _streams(outs + eng.run(), reqs)

    got, teng = _both(pair, drive, num_slots=2, chunk_size=3)
    assert got == {0: _hf(hf_model, P0, 8), 1: _hf(hf_model, P1, 6)}
    assert teng.dispatches[TAG_MIXED] == pair.jax_dispatches(TAG_MIXED)


def test_mixed_with_all_fused_flags(tiny_hf_llama):
    """Fused QKV with the QKV and MLP kernels and the ragged attention kernel
    in the mixed engine: the fused weight crosses packages leaf for leaf,
    streams equal the JAX engine and HF, strategies equal the JAX app's."""
    hf_model, hf_cfg = tiny_hf_llama
    pair = _Pair(hf_model, hf_cfg, **MIXED, **FUSED)
    _assert_same_tree(pair.tapp.params, from_jax_params(jax.device_get(pair.japp.params)))
    assert "qkv_proj" in pair.tapp.params["layers"]["attn"]
    got, teng = _both(pair, _interleaved(pair.tapp), num_slots=3)
    assert got == {0: _hf(hf_model, P0, 10), 1: _hf(hf_model, P1, 12), 2: _hf(hf_model, P2, 9)}
    assert pair.strategies_match()[TAG_MIXED] == {
        "qkv_fused_kernel", "mixed_ragged_kernel", "mlp_fused_kernel"}
