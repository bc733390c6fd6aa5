"""The port's open-loop arrival driver and goodput arithmetic
(``nxdi_tpu_torch/serving/workload.py``) and the engine's per-request
metrics, held against the JAX package's ``serving/workload.py`` and engine;
and ``padding_side``, which both packages validate and ``generate()``
accepts.

- ``goodput_summary`` (with and without an SLO), ``percentile_exact`` and
  ``breach_kinds`` give the JAX functions' results on the same outputs,
  exactly;
- each finished request carries ``ttft_s``, ``e2e_s`` and ``tpot_s`` by the
  JAX engine's rule (timed from ``arrival_s``), the same keys as the JAX
  engine's outputs;
- ``drive_arrivals`` drives a Poisson workload (seed 17) through the paged
  engine on the CPU to completion, with the closed-loop run's streams.
"""

import time

import numpy as np
import pytest

from nxdi_tpu.config import SloConfig as JaxSlo
from nxdi_tpu.config import TpuConfig
from nxdi_tpu.serving import SamplingParams as JaxSP
from nxdi_tpu.serving.request import RequestOutput as JaxOutput
from nxdi_tpu.serving.workload import goodput_summary as jax_goodput
from nxdi_tpu.telemetry.registry import percentile_exact as jax_percentile
from nxdi_tpu.telemetry.slo import breach_kinds as jax_breach
from nxdi_tpu_torch.config import TorchConfig
from nxdi_tpu_torch.generation.hf_adapter import HuggingFaceGenerationAdapter
from nxdi_tpu_torch.serving import RequestOutput, SamplingParams
from nxdi_tpu_torch.serving import workload as wl
from test_torch_engine import _Pair
from test_torch_slice import PROMPT, fresh_jax_compiles, port_app

PROMPTS = [[5, 9, 3, 17, 2, 8, 11, 42], [7, 13, 21, 4, 33], [9, 9, 2, 40, 17, 3],
           [12, 5, 88, 3, 7, 19, 44], [1, 2, 3]]


@pytest.fixture(autouse=True, scope="module")
def _fresh_jax_compiles():
    with fresh_jax_compiles():
        yield


def _outputs(cls, rng):
    outs = []
    for i in range(9):
        n = int(rng.integers(1, 6))
        metrics = {"preemptions": int(rng.integers(0, 2)), "ttft_s": float(rng.uniform(0, 1)),
                   "e2e_s": 2.0}
        if n > 1:
            metrics["tpot_s"] = float(rng.uniform(0, 0.1))
        if i == 3:
            metrics["ttft_s"] = None  # no first token
        if i == 4:
            metrics["ttft_s"] = 0.0  # a legitimate zero stays in the population
        outs.append(cls(request_id=i, prompt=[1, 2], token_ids=list(range(n)),
                        finish_reason="error" if i == 5 else "length", metrics=metrics))
    return outs


@pytest.mark.parametrize("slo", [None, dict(ttft_s=0.5), dict(ttft_s=0.5, tpot_s=0.05)])
def test_goodput_summary_matches_jax(slo):
    rng = np.random.default_rng(0)
    jout, tout = _outputs(JaxOutput, rng), _outputs(RequestOutput, np.random.default_rng(0))
    want = jax_goodput(jout, 3.7, None if slo is None else JaxSlo(**slo))
    got = wl.goodput_summary(tout, 3.7, None if slo is None else wl.SloConfig(**slo))
    assert got == want
    assert wl.goodput_summary([], 1.0)["ttft_p50_ms"] is None


def test_percentile_and_breach_match_jax():
    rng = np.random.default_rng(1)
    for n in (0, 1, 2, 7, 100):
        xs = rng.standard_normal(n).tolist()
        for q in (0, 10, 50, 95, 100, 120):
            assert wl.percentile_exact(xs, q) == jax_percentile(xs, q)
    for slo in (dict(ttft_s=0.2), dict(tpot_s=0.01), dict(ttft_s=0.2, tpot_s=0.01)):
        for ttft in (None, 0.1, 0.2, 0.3):
            for tpot in (None, 0.005, 0.02):
                assert (wl.breach_kinds(wl.SloConfig(**slo), ttft, tpot)
                        == jax_breach(JaxSlo(**slo), ttft, tpot))
    with pytest.raises(ValueError, match="at least one"):
        wl.SloConfig()


def _engine_pair(hf_model, hf_cfg):
    return _Pair(hf_model, hf_cfg, pa_block_size=8, pa_num_blocks=32, ctx_batch_size=1,
                 tkg_batch_size=3)


def test_engine_metrics_follow_jax_rule(tiny_hf_llama):
    hf_model, hf_cfg = tiny_hf_llama
    pair = _engine_pair(hf_model, hf_cfg)
    jeng, teng = pair.engines()
    t0 = time.perf_counter() - 0.25  # every request arrived 250 ms ago
    jouts = [jeng.add_request(p, JaxSP(max_new_tokens=4), arrival_s=t0) for p in PROMPTS[:3]]
    touts = [teng.add_request(p, SamplingParams(max_new_tokens=4), arrival_s=t0)
             for p in PROMPTS[:3]]
    jres, tres = jeng.run(), teng.run()
    assert len(jres) == len(tres) == len(jouts) == len(touts)
    for j, t in zip(sorted(jres, key=lambda o: o.prompt), sorted(tres, key=lambda o: o.prompt)):
        assert t.token_ids == j.token_ids
        assert set(t.metrics) == set(j.metrics)
        m = t.metrics
        assert 0.25 <= m["ttft_s"] <= m["e2e_s"]
        assert m["tpot_s"] == pytest.approx((m["e2e_s"] - m["ttft_s"]) / (len(t.token_ids) - 1))
    one = teng.add_request([1, 2, 3], SamplingParams(max_new_tokens=1))
    (o,) = teng.run()
    assert o.request_id == one.request_id and "tpot_s" not in o.metrics


def test_drive_arrivals_poisson(tiny_hf_llama):
    hf_model, hf_cfg = tiny_hf_llama
    pair = _engine_pair(hf_model, hf_cfg)
    _, closed = pair.engines()
    for p in PROMPTS:
        closed.add_request(p, SamplingParams(max_new_tokens=5))
    closed_streams = {tuple(o.prompt): o.token_ids for o in closed.run()}
    _, eng = pair.engines()
    arrivals = np.cumsum(np.random.default_rng(17).exponential(1 / 40.0, len(PROMPTS)))
    submitted = []

    def submit(engine, i, arrival_s):
        submitted.append(arrival_s)
        engine.add_request(PROMPTS[i], SamplingParams(max_new_tokens=5), arrival_s=arrival_s)

    outs, wall = wl.drive_arrivals(eng, arrivals, submit)
    assert len(outs) == len(PROMPTS) and wall > arrivals[-1]
    assert np.all(np.diff(submitted) >= 0)
    assert {tuple(o.prompt): o.token_ids for o in outs} == closed_streams
    summary = wl.goodput_summary(outs, wall)
    assert summary["requests"] == len(PROMPTS) and summary["errors"] == 0
    assert summary["tok_s"] == round(5 * len(PROMPTS) / wall, 1)
    assert summary["ttft_p50_ms"] > 0 and summary["tpot_p50_ms"] > 0


def test_padding_side(tiny_hf_llama):
    for cls in (TpuConfig, TorchConfig):
        with pytest.raises(ValueError, match="padding_side must be 'right' or 'left'"):
            cls(padding_side="center")
        assert cls(padding_side="left").padding_side == "left"
    hf_model, hf_cfg = tiny_hf_llama
    right = port_app(hf_model, hf_cfg)
    left = port_app(hf_model, hf_cfg, padding_side="left")
    assert left.tpu_config.to_dict()["padding_side"] == "left"
    # generate() takes right-padded ids either way, as the JAX adapter does
    np.testing.assert_array_equal(
        HuggingFaceGenerationAdapter(left).generate(PROMPT, max_new_tokens=4, padding_side="left"),
        HuggingFaceGenerationAdapter(right).generate(PROMPT, max_new_tokens=4))
