"""The port's paged continuous-batching engine on the CPU (the kernels'
plain versions) held against the JAX package's ``InferenceEngine`` (Pallas
kernels in interpret mode) and HF greedy, on the tiny random llama.

Each test mirrors one of the JAX package's engine tests
(``tests/integration/test_serving_engine.py``,
``tests/integration/test_prefix_cache_engine.py``): the same configuration
and traffic go through both engines, the streams must be token-identical to
each other and to ``hf_greedy_generate``, and every submodel must record the
same attention strategies in both packages."""

import numpy as np
import pytest
import torch

import jax

from nxdi_tpu.config import OnDeviceSamplingConfig as JaxODSC
from nxdi_tpu.config import TpuConfig
from nxdi_tpu.models.llama import modeling_llama as jml
from nxdi_tpu.runtime.application import TpuModelForCausalLM
from nxdi_tpu.serving import InferenceEngine as JaxEngine
from nxdi_tpu.serving import SamplingParams as JaxSP
from nxdi_tpu.serving import SchedulerConfig as JaxSC
from nxdi_tpu.utils.accuracy import hf_greedy_generate
from nxdi_tpu_torch.config import OnDeviceSamplingConfig, TorchConfig
from nxdi_tpu_torch.models.convert import from_jax_params
from nxdi_tpu_torch.models.llama import modeling_llama as tml
from nxdi_tpu_torch.runtime.application import TAG_PREFIX_PREFILL, TorchModelForCausalLM
from nxdi_tpu_torch.serving import InferenceEngine, SamplingParams, SchedulerConfig
from test_torch_slice import fresh_jax_compiles

P0 = [5, 9, 3, 17, 2, 8, 11, 42]
P1 = [7, 13, 21, 4, 33]
P2 = [9, 9, 2, 40, 17, 3]
SHARED = [5, 9, 3, 17, 2, 8, 11, 42, 7, 13]  # > 1 full block at pa_block_size=8
PROMPTS = [SHARED + [21, 4], SHARED + [33, 6], SHARED + [21, 4, 9]]
LONG = np.random.default_rng(0).integers(1, 255, size=20).tolist()

KERNELS = dict(attn_kernel_enabled=True, attn_tkg_kernel_enabled=True)


@pytest.fixture(autouse=True, scope="module")
def _fresh_jax_compiles():
    # the JAX engine compiles without a persistent cache an earlier test left on
    with fresh_jax_compiles():
        yield


def _common(**kw):
    d = dict(tp_degree=1, seq_len=64, max_context_length=32, batch_size=2, dtype="float32",
             skip_warmup=True, is_block_kv_layout=True)
    d.update(kw)
    return d


class _Pair:
    """One configuration built in both packages from one HF state dict."""

    def __init__(self, hf_model, hf_cfg, **kw):
        sd = {k: v.detach().numpy() for k, v in hf_model.state_dict().items()}
        jcfg = jml.LlamaInferenceConfig(
            TpuConfig(on_device_sampling_config=JaxODSC(), telemetry="basic", **_common(**kw)),
            load_config=lambda: hf_cfg.to_dict(),
        )
        tcfg = tml.LlamaInferenceConfig(
            TorchConfig(on_device_sampling_config=OnDeviceSamplingConfig(), **_common(**kw)),
            load_config=lambda: hf_cfg.to_dict(),
        )

        class JApp(TpuModelForCausalLM):
            def get_state_dict(self):
                return sd

        class TApp(TorchModelForCausalLM):
            def get_state_dict(self):
                return {k: torch.from_numpy(v) for k, v in sd.items()}

        self.japp = JApp("<memory>", jcfg, model_family=jml)
        self.japp.load()
        self.tapp = TApp("<memory>", tcfg, model_family=tml, device="cpu")
        self.tapp.load()

    def engines(self, **sched):
        return (JaxEngine(self.japp, JaxSC(**sched)),
                InferenceEngine(self.tapp, SchedulerConfig(**sched)))

    def strategies_match(self):
        """Every submodel the port dispatched recorded the JAX app's
        strategies for the same configuration."""
        seen = {}
        for tag, w in self.tapp.models.items():
            port = {s for ss in w.attention_strategies.values() for s in ss}
            ref = {s for p in self.japp.models[tag]._programs.values()
                   for s in p.attention_strategies}
            assert port == ref, (tag, port, ref)
            seen[tag] = port
        return seen

    def jax_dispatches(self, tag):
        disp = self.japp.telemetry.dispatches_total
        i = disp.label_names.index("submodel")
        return sum(v for k, v in disp.series().items() if k[i] == tag)


def _assert_same_tree(port, carried):
    assert port.keys() == carried.keys()
    for k, v in port.items():
        if isinstance(v, dict):
            _assert_same_tree(v, carried[k])
        else:
            torch.testing.assert_close(v, carried[k], rtol=0, atol=0)


def _hf(hf_model, prompt, n):
    return hf_greedy_generate(hf_model, np.array([prompt]), n)[0, len(prompt):].tolist()


def _both(pair, drive, **sched):
    """Run ``drive(engine, SamplingParams)`` on both engines; returns their
    {key: tokens} streams and the port engine."""
    jeng, teng = pair.engines(**sched)
    jout = drive(jeng, JaxSP)
    tout = drive(teng, SamplingParams)
    assert tout == jout
    return tout, teng


def _streams(outs, reqs):
    got = {o.request_id: o.token_ids for o in outs}
    return {k: got[r.request_id] for k, r in reqs.items()}


def test_engine_interleaved_arrivals(tiny_hf_llama):
    """Mirrors test_engine_paged_parity_interleaved_vs_static_generate: a
    third request arrives mid-flight; nothing is preempted. Also checks the
    two packages' param trees agree."""
    hf_model, hf_cfg = tiny_hf_llama
    pair = _Pair(hf_model, hf_cfg, pa_block_size=8, pa_num_blocks=32, ctx_batch_size=1,
                 tkg_batch_size=3, **KERNELS)
    _assert_same_tree(pair.tapp.params, from_jax_params(jax.device_get(pair.japp.params)))

    budgets = {0: 10, 1: 12, 2: 9}

    def drive(eng, SP):
        streams = {}
        reqs = {i: eng.add_request(p, SP(max_new_tokens=budgets[i]),
                                   on_token=lambda r, t: streams.setdefault(r.request_id, [])
                                   .append(t))
                for i, p in enumerate((P0, P1))}
        outs = eng.step() + eng.step()
        reqs[2] = eng.add_request(P2, SP(max_new_tokens=budgets[2]),
                                  on_token=lambda r, t: streams.setdefault(r.request_id, [])
                                  .append(t))
        outs += eng.run()
        assert all(o.metrics["preemptions"] == 0 for o in outs)
        got = _streams(outs, reqs)
        assert got == {k: streams[r.request_id] for k, r in reqs.items()}
        return got

    got, _ = _both(pair, drive, num_slots=3)
    for i, p in enumerate((P0, P1, P2)):
        assert got[i] == _hf(hf_model, p, budgets[i])
    assert pair.strategies_match() == {
        "context_encoding_model": {"cte_flash_kernel"},
        "token_generation_model": {"tkg_kernel"},
    }


@pytest.mark.parametrize("num_blocks", [16, 8], ids=["forced", "natural"])
def test_engine_preemption(tiny_hf_llama, num_blocks):
    """Mirrors test_engine_parity_across_preemption: a forced eviction of
    the youngest request after one step (16 blocks), and a pool too small
    for both sequences (8 blocks). The block-table decode kernel is on."""
    hf_model, hf_cfg = tiny_hf_llama
    pair = _Pair(hf_model, hf_cfg, pa_block_size=4, pa_num_blocks=num_blocks, ctx_batch_size=1,
                 tkg_batch_size=2, attn_block_tkg_kernel_enabled=True, **KERNELS)
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
    assert pair.strategies_match() == {
        "context_encoding_model": {"cte_flash_kernel"},
        "token_generation_model": {"tkg_paged_kernel"},
    }


def test_engine_chunked_prefill_admission(tiny_hf_llama):
    """Mirrors test_engine_chunked_prefill_admission: the 20-token prompt
    prefills in chunks of 8 (context encoding, then prefix-prefill through
    the block table) while a short neighbour decodes."""
    hf_model, hf_cfg = tiny_hf_llama
    pair = _Pair(hf_model, hf_cfg, chunked_prefill_config={"chunk_size": 8,
                                                          "kernel_q_tile_size": 8},
                 pa_block_size=4, pa_num_blocks=32, ctx_batch_size=1, tkg_batch_size=2,
                 **KERNELS)

    def drive(eng, SP):
        reqs = {0: eng.add_request(P1, SP(max_new_tokens=8)),
                1: eng.add_request(LONG, SP(max_new_tokens=6))}
        return _streams(eng.run(), reqs)

    got, teng = _both(pair, drive, num_slots=2)
    assert got == {0: _hf(hf_model, P1, 8), 1: _hf(hf_model, LONG, 6)}
    assert teng.dispatches[TAG_PREFIX_PREFILL] >= 2
    assert teng.dispatches[TAG_PREFIX_PREFILL] == pair.jax_dispatches(TAG_PREFIX_PREFILL)
    assert pair.strategies_match()[TAG_PREFIX_PREFILL] == {"cte_paged_kernel"}


def _waves(prompts):
    """Wave 1 seeds the cache (retirement inserts); later arrivals hit."""

    def drive(eng, SP):
        reqs = {0: eng.add_request(prompts[0], SP(max_new_tokens=8))}
        outs = eng.run()
        for i, p in enumerate(prompts[1:], 1):
            reqs[i] = eng.add_request(p, SP(max_new_tokens=8))
        outs += eng.run()
        return _streams(outs, reqs)

    return drive


def test_prefix_cache_parity_and_hits(tiny_hf_llama):
    """Mirrors test_prefix_cache_parity_and_hits: cache ON == cache OFF ==
    the JAX engine == HF, with real hits."""
    hf_model, hf_cfg = tiny_hf_llama
    app_kw = dict(pa_block_size=8, pa_num_blocks=32, ctx_batch_size=1, tkg_batch_size=3,
                  **KERNELS)
    pair = _Pair(hf_model, hf_cfg, is_prefix_caching=True, **app_kw)
    on, teng = _both(pair, _waves(PROMPTS), num_slots=3, prefix_cache=True)
    pc = teng.scheduler.prefix_cache
    assert pc.hits_n >= 2 and pc.tokens_saved_n > 0
    assert on == {i: _hf(hf_model, p, 8) for i, p in enumerate(PROMPTS)}
    assert pair.strategies_match()[TAG_PREFIX_PREFILL] == {"cte_paged_kernel"}

    # the same app with the cache off
    off = _waves(PROMPTS)(InferenceEngine(pair.tapp, SchedulerConfig(num_slots=3)),
                          SamplingParams)
    assert off == on


def test_prefix_cache_chunked_prefill(tiny_hf_llama):
    """Mirrors test_prefix_cache_parity_chunked_prefill, with the attention
    kernels off (the plain strategies): the repeat of a 20-token prompt
    rides the cache and needs fewer prefix-prefill chunks than its first
    service."""
    hf_model, hf_cfg = tiny_hf_llama
    pair = _Pair(hf_model, hf_cfg, is_prefix_caching=True, pa_block_size=8, pa_num_blocks=32,
                 ctx_batch_size=1, tkg_batch_size=3,
                 chunked_prefill_config={"chunk_size": 8, "kernel_q_tile_size": 8})
    chunks = []

    def drive(eng, SP):
        reqs = {0: eng.add_request(LONG, SP(max_new_tokens=6))}
        outs = eng.run()
        if isinstance(eng, InferenceEngine):
            chunks.append(eng.dispatches[TAG_PREFIX_PREFILL])
        reqs[1] = eng.add_request(LONG, SP(max_new_tokens=6))
        outs += eng.run()
        if isinstance(eng, InferenceEngine):
            chunks.append(eng.dispatches[TAG_PREFIX_PREFILL] - chunks[0])
        return _streams(outs, reqs)

    got, teng = _both(pair, drive, num_slots=3, prefix_cache=True)
    assert got[0] == got[1] == _hf(hf_model, LONG, 6)
    assert teng.scheduler.prefix_cache.hits_n >= 1
    assert chunks[1] < chunks[0]
    assert pair.strategies_match() == {
        "context_encoding_model": {"cte_xla"},
        "token_generation_model": {"tkg_xla"},
        TAG_PREFIX_PREFILL: {"tkg_xla"},
    }


def test_n_fork_shares_the_prompt_copy_on_write(tiny_hf_llama):
    """SamplingParams(n=2): the sibling forks the parent's prompt blocks and
    copy-on-writes the shared partial block; both continuations equal the
    solo greedy stream."""
    hf_model, hf_cfg = tiny_hf_llama
    pair = _Pair(hf_model, hf_cfg, is_prefix_caching=True, pa_block_size=8, pa_num_blocks=32,
                 ctx_batch_size=1, tkg_batch_size=3, **KERNELS)
    eng = InferenceEngine(pair.tapp, SchedulerConfig(num_slots=3, prefix_cache=True))
    eng.add_request(PROMPTS[0], SamplingParams(max_new_tokens=6, n=2))
    outs = eng.run()
    assert [o.token_ids for o in outs] == [_hf(hf_model, PROMPTS[0], 6)] * 2
    assert eng.prefix_cache.cow_copies_n >= 1


def test_engine_refuses_what_is_not_ported(tiny_hf_llama):
    hf_model, hf_cfg = tiny_hf_llama
    # ported: roles and padding_side, under the JAX package's rules
    with pytest.raises(ValueError, match="role='decode' requires is_block_kv_layout"):
        TorchConfig(role="decode")
    with pytest.raises(ValueError, match="padding_side must be 'right' or 'left'"):
        TorchConfig(padding_side="middle")
    assert TorchConfig(padding_side="left").padding_side == "left"
    # speculation is ported, EAGLE included (an EAGLE draft implies the fused window)
    assert TorchConfig(speculation_length=2).speculation_length == 2
    assert TorchConfig(enable_eagle_speculation=True).enable_fused_speculation
    # ported: the device-resident decode family, under the JAX package's rules
    for key, value in (("device_loop", True), ("decode_steps_per_dispatch", 2)):
        with pytest.raises(ValueError, match="requires on-device sampling"):
            TorchConfig(**{key: value})
    assert TorchConfig(is_continuous_batching=True).is_continuous_batching
    with pytest.raises(ValueError, match="requires is_block_kv_layout"):
        TorchConfig(is_prefix_caching=True)
    # mixed dispatch is ported; the JAX package's rules for it and for the
    # fused projection flags hold word for word
    with pytest.raises(ValueError, match="mixed_dispatch requires is_block_kv_layout"):
        TorchConfig(mixed_dispatch=True)
    with pytest.raises(ValueError, match="qkv_kernel_enabled requires fused_qkv"):
        TorchConfig(qkv_kernel_enabled=True)
    cfg = tml.LlamaInferenceConfig(
        TorchConfig(seq_len=16, on_device_sampling_config=OnDeviceSamplingConfig()),
        load_config=lambda: hf_cfg.to_dict(),
    )

    class App(TorchModelForCausalLM):
        def get_state_dict(self):
            return {k: v.detach() for k, v in hf_model.state_dict().items()}

    app = App("<memory>", cfg, model_family=tml, device="cpu")
    app.load()
    with pytest.raises(ValueError, match="is_block_kv_layout"):
        InferenceEngine(app)  # the static layout has no per-request cache routing
