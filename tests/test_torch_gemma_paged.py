"""Gemma at its head dim of 256 on the paged engines, held to the JAX
package, and the paged kernels at that head dim (rows 6, 7' and 8) held to
the Pallas kernels in interpret mode.

Kernels: the plain versions the wrappers run on CPU tensors, at Gemma-2B's
attention (8 query heads over 1 kv head of 256), against
``paged_attention_prefill``, ``paged_attention_decode`` and
``ragged_paged_attention`` of the JAX package on the same numpy inputs: a
bf16 / f32 pool and a one-byte store with per-tensor scales. Tolerances as
``tests/test_torch_paged_kernels.py`` states them: float32 1e-5, bfloat16
2e-2 (both sides round P to bfloat16, against different running maxima,
and round the output). The card holds the CUDA kernels to these plain
versions (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 3m).

Engines: a tiny Gemma (2 layers, hidden 64, the published attention shape:
8 heads over 1 kv head of 256, tanh GELU, tied head) served by the split
paged engine (attention and block-table decode kernel flags: the paged
prefill serves the prefix-cached and chunked prefills) and the mixed
engine (5c's setup: fused QKV, the QKV, MLP and ragged kernels), each on a
float32 pool and an e4m3 pool with per-tensor scales; the same traffic
through the JAX package's engine of the same configuration (Pallas in
interpret mode): greedy streams identical, every dispatch's last-token
logits within 1e-4 (float32; measured ~1e-6), the strategies the JAX app
records."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nxdi_tpu.ops.kernels import flash_attention as jfa
from nxdi_tpu.ops.kernels import ragged_paged_attention as jax_ragged  # the function
from nxdi_tpu.serving import InferenceEngine as JaxEngine
from nxdi_tpu.serving import SamplingParams as JaxSP
from nxdi_tpu.serving import SchedulerConfig as JaxSC
from nxdi_tpu_torch.models import base as tbase
from nxdi_tpu_torch.ops.kernels import flash_attention as tfa
from nxdi_tpu_torch.ops.kernels import ragged_paged_attention as tra
from nxdi_tpu_torch.serving import InferenceEngine, SamplingParams, SchedulerConfig

from test_torch_families import jax_family_app, port_family_app
from test_torch_slice import fresh_jax_compiles

H, KV, D = 8, 1, 256
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
STORES = {"e4m3": (jnp.float8_e4m3fn, torch.float8_e4m3fn), "int8": (jnp.int8, torch.int8)}
SCALES = dict(k_scale=0.5, v_scale=0.5)
# int8 stores the values x 20 (of inputs x 2): its scales bring them back
INT8_SCALES = dict(k_scale=0.025, v_scale=0.025)
LOGIT_TOL = 1e-4
E4M3_PT = dict(dtype="float8_e4m3", scale_mode="per_tensor", k_scale=0.25, v_scale=0.25)


@pytest.fixture(autouse=True, scope="module")
def _fresh_jax_compiles():
    with fresh_jax_compiles():
        yield


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _pool(store, dtype, n, seed):
    """(jax k, jax v, torch k, torch v) pools of n slots: float inputs in
    ``dtype``, or a one-byte store (the same stored values on both sides)."""
    k, v = _rand((n, KV, D), seed) * 2, _rand((n, KV, D), seed + 1) * 2
    if store is None:
        return (jnp.asarray(k, JDT[dtype]), jnp.asarray(v, JDT[dtype]),
                torch.from_numpy(k).to(TDT[dtype]), torch.from_numpy(v).to(TDT[dtype]))
    jdt, tdt = STORES[store]
    if store == "int8":
        k, v = (np.clip(np.round(x * 20), -127, 127).astype(np.int8) for x in (k, v))
        return jnp.asarray(k), jnp.asarray(v), torch.from_numpy(k), torch.from_numpy(v)
    jk, jv = jnp.asarray(k, jdt), jnp.asarray(v, jdt)
    # the same fp8 codes on both sides, carried as bytes
    tk = torch.from_numpy(np.asarray(jk.view(jnp.uint8))).view(tdt)
    tv = torch.from_numpy(np.asarray(jv.view(jnp.uint8))).view(tdt)
    return jk, jv, tk, tv


def _scales(store):
    return INT8_SCALES if store == "int8" else SCALES


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=TOL[dtype], rtol=0)


def _tables(bs):
    """Three rows over a pool of 2 * NB blocks: dense, a hole mid-range, and
    all holes (no visible key)."""
    NB = 48 // bs
    perm = np.random.default_rng(bs).permutation(2 * NB).astype(np.int32)
    bt = np.stack([perm[:NB], perm[NB:], np.full(NB, -1, np.int32)])
    bt[1, 1] = -1
    return bt, 2 * NB


@pytest.mark.parametrize("store", [None, "e4m3", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_prefill_at_head_dim_256_matches_pallas(dtype, store):
    """Row 6 (and 6' over a one-byte pool) at Gemma-2B's heads: a 12-token
    chunk per row across block boundaries, a hole, a row of holes; the
    card's body choice at that head dim (mma.sync for bf16, the CUDA cores
    for f32: no TMA body at 256)."""
    bs, Sq = 8, 12
    bt, nblk = _tables(bs)
    jk, jv, tk, tv = _pool(store, dtype, nblk * bs, 20)
    q = _rand((3, H, Sq, D), 22)
    qp = np.array([30, 13, 5], np.int32)[:, None] + np.arange(Sq, dtype=np.int32)
    jq = jnp.asarray(q, JDT[dtype])
    want = jfa.paged_attention_prefill(jq, jk, jv, jnp.asarray(bt), jnp.asarray(qp),
                                       block_size=bs, **_scales(store))
    tq = torch.from_numpy(q).to(TDT[dtype])
    tfa.paged_attention_prefill.launches = 0
    got = tfa.paged_attention_prefill(tq, tk, tv, torch.from_numpy(bt), torch.from_numpy(qp),
                                      block_size=bs, **_scales(store))
    assert tfa.paged_attention_prefill.launches == 0  # CPU tensors: the plain version
    _close(got, want, dtype)
    assert torch.equal(got[2], torch.zeros_like(got[2]))
    assert tfa.paged_prefill_body(tq, tk, tv, bs) == ("mma" if dtype == "bfloat16" else "simt")
    assert jfa.paged_prefill_kernel_supported(jq.shape, jk.shape, bs)


@pytest.mark.parametrize("store", ["e4m3", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_one_byte_paged_decode_at_head_dim_256_matches_pallas(dtype, store):
    """Row 7' at Gemma-2B's heads over a one-byte pool with scales."""
    bs = 8
    bt, nblk = _tables(bs)
    jk, jv, tk, tv = _pool(store, dtype, nblk * bs, 10)
    q = _rand((3, H, 1, D), 12)
    qp = np.array([[47], [20], [9]], np.int32)
    want = jfa.paged_attention_decode(jnp.asarray(q, JDT[dtype]), jk, jv, jnp.asarray(bt),
                                      jnp.asarray(qp), block_size=bs, **_scales(store))
    got = tfa.paged_attention_decode(torch.from_numpy(q).to(TDT[dtype]), tk, tv,
                                     torch.from_numpy(bt), torch.from_numpy(qp), block_size=bs,
                                     **_scales(store))
    _close(got, want, dtype)
    assert torch.equal(got[2], torch.zeros_like(got[2]))


@pytest.mark.parametrize("store", [None, "e4m3"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ragged_at_head_dim_256_matches_pallas(dtype, store):
    """Row 8 (and 8') at Gemma-2B's heads: a 10-token chunk after a prefix,
    a decode token deep in its row, a fresh 3-token prefill, padding; the
    one-row tiles' body at that head dim is mma.sync (bf16) over either
    pool, so the plan holds no wgmma items."""
    bs, T = 8, 24
    jk, jv, tk, tv = _pool(store, dtype, 96, 30)
    bt = np.array([[3, 5, -1, 11], [7, 2, 9, -1], [1, -1, -1, -1]], np.int32)
    rid = np.array([0] * 10 + [1] + [2] * 3 + [-1] * 10, np.int32)
    qp = np.array(list(range(8, 18)) + [21] + [0, 1, 2] + [0] * 10, np.int32)
    q = _rand((1, H, T, D), 32)
    want = jax_ragged(
        jnp.asarray(q, JDT[dtype]), jk, jv, jnp.asarray(bt), jnp.asarray(rid), jnp.asarray(qp),
        block_size=bs, block_q=8, **SCALES)
    tra.ragged_paged_attention.launches = 0
    got = tra.ragged_paged_attention(torch.from_numpy(q).to(TDT[dtype]), tk, tv, bt, rid, qp,
                                     block_size=bs, **SCALES)
    assert tra.ragged_paged_attention.launches == 0
    _close(got[:, :, :14], want[:, :, :14], dtype)
    assert torch.all(got[:, :, 14:] == 0)
    assert tra.ragged_direct_body(TDT[dtype], tk.dtype, D, bs) == (
        "mma" if dtype == "bfloat16" else "simt")
    plan = tra.ragged_plan(rid, qp, 3, 4 * bs, KV)
    assert plan.n_wg == 0 and not plan.wgmma
    assert tbase._card_limits(D, TDT[dtype], store=tk.dtype) == []


# ---------------------------------------------------------------------------
# Gemma's paged engines against the JAX engine
# ---------------------------------------------------------------------------

P0 = [5, 9, 3, 17, 2, 8, 11, 42, 7, 13, 21, 4]
SHARED = [5, 9, 3, 17, 2, 8, 11, 42, 7, 13]
P1 = SHARED + [33, 6, 9, 40, 2, 17, 3, 8, 8, 1]  # shares P0's first block
P2 = [9, 9, 2, 40, 17, 3]
PAGED = dict(batch_size=1, ctx_batch_size=1, tkg_batch_size=3, is_block_kv_layout=True,
             pa_block_size=8, pa_num_blocks=32, is_prefix_caching=True, seq_len=64,
             max_context_length=32, chunked_prefill_config={"chunk_size": 8,
                                                            "kernel_q_tile_size": 8},
             attn_kernel_enabled=True, attn_block_tkg_kernel_enabled=True)
MIXED = dict(mixed_dispatch=True, fused_qkv=True, qkv_kernel_enabled=True,
             mlp_kernel_enabled=True, chunked_prefill_config=None)


@functools.lru_cache(maxsize=None)
def tiny_gemma():
    """(HF config dict, state dict as numpy): Gemma at Gemma-2B's attention
    shape, 2 layers, narrow elsewhere; norms drawn N(0, 0.3) so the (1 + w)
    norms bite, projections scaled x 16 so the greedy tokens move."""
    import transformers

    torch.manual_seed(0)
    cfg = transformers.GemmaConfig(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                                   num_attention_heads=H, num_key_value_heads=KV, head_dim=D,
                                   vocab_size=256, max_position_embeddings=256,
                                   rms_norm_eps=1e-6, hidden_act="gelu_pytorch_tanh",
                                   tie_word_embeddings=True)
    model = transformers.GemmaForCausalLM(cfg).eval()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "norm" in name:
                p.normal_(0.0, 0.3)
            elif "proj" in name:
                p.mul_(16.0)
    return cfg.to_dict(), {k: v.detach().numpy() for k, v in model.state_dict().items()}


def _record_logits(app):
    """Every dispatch's last-token logits of ``app`` (JAX or port), as numpy."""
    inner = app.forward
    logs = []

    def fwd(*a, **k):
        out = inner(*a, **k)
        lg = out["logits"]
        lg = lg.numpy() if isinstance(lg, torch.Tensor) else np.asarray(jax.device_get(lg))
        logs.append(lg[:, -1, :].astype(np.float32))
        return out

    app.forward = fwd
    return logs


def _drive(eng, SP):
    """r0 prefills; r1 (sharing r0's first block, 20 tokens: chunks of 8)
    and r2 arrive while r0 decodes; the streams by arrival."""
    reqs = [eng.add_request(P0, SP(max_new_tokens=10))]
    outs = eng.step()
    reqs += [eng.add_request(P1, SP(max_new_tokens=8)), eng.add_request(P2, SP(max_new_tokens=9))]
    outs += eng.run()
    got = {o.request_id: o.token_ids for o in outs}
    return [got[r.request_id] for r in reqs]


def _strategies(japp, tapp):
    seen = {}
    for tag, w in tapp.models.items():
        port = {s for ss in w.attention_strategies.values() for s in ss}
        ref = {s for p in japp.models[tag]._programs.values() for s in p.attention_strategies}
        assert port == ref, (tag, port, ref)
        seen[tag] = port
    return seen


@pytest.mark.parametrize("pool", ["float32", "e4m3"])
@pytest.mark.parametrize("engine", ["split", "mixed"])
def test_gemma_paged_engine_matches_jax(engine, pool):
    cfg, sd = tiny_gemma()
    kw = dict(PAGED, **(MIXED if engine == "mixed" else {}),
              **({} if pool == "float32" else dict(kv_quant_config=dict(E4M3_PT))))
    japp = jax_family_app("gemma", cfg, sd, **kw)
    tapp = port_family_app("gemma", cfg, sd=sd, **kw)
    assert tapp.models["token_generation_model"].arch.head_dim == D
    jlogs, tlogs = _record_logits(japp), _record_logits(tapp)
    sched = dict(num_slots=3, prefix_cache=True)
    want = _drive(JaxEngine(japp, JaxSC(**sched)), JaxSP)
    teng = InferenceEngine(tapp, SchedulerConfig(**sched))
    got = _drive(teng, SamplingParams)
    assert got == want
    assert len(set(got[0])) > 2  # the tokens move
    assert len(tlogs) == len(jlogs)
    worst = max(np.abs(t - j).max() for t, j in zip(tlogs, jlogs))
    assert worst <= LOGIT_TOL, worst
    seen = _strategies(japp, tapp)
    if engine == "mixed":
        assert teng.mixed and {k for k, v in teng.dispatches.items() if v} == {"mixed_model"}
        assert {"mixed_ragged_kernel", "qkv_fused_kernel", "mlp_fused_kernel"} <= seen[
            "mixed_model"]
    else:
        assert seen["prefix_prefill_model"] == {"cte_paged_kernel"}
        assert seen["token_generation_model"] == {"tkg_paged_kernel"}
        assert teng.dispatches["prefix_prefill_model"] >= 2  # P1's chunks after its first
    if pool == "e4m3":
        assert tapp.kv_cache["k"].dtype == torch.float8_e4m3fn
