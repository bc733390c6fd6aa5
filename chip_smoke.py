#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``nxdi_tpu_torch``) on one H100.

    python3 chip_smoke.py

Phases, all of them on every run, in order; any failure raises, so the exit
code is non-zero:

1. Card: name and power limit (nvidia-smi), torch and CUDA versions.
2. Build: the hand-written CUDA kernels from ``nxdi_tpu_torch/csrc``.
3. Kernels against their plain PyTorch versions at the slice's shapes, in
   bfloat16 and float32, with kernel / plain / library times and the bound.
3b. The paged-decode, paged-prefill and window-decode kernels the same way,
   at the serving engine's shapes (block 128, and block 16 for correctness).
4. The slice at full Llama-3.2-1B width, 2 layers, float32: greedy
   ``generate()`` on the CPU (plain versions) and on the card (kernels),
   every step's logits held against each other.
4b. The paged serving engine at full width, 2 layers, float32, on the CPU
   and on the card: interleaved arrivals, a shared prefix, chunked prefill
   and a forced preemption; identical streams, every dispatch's logits
   within 1e-4, the window-decode kernel on the decode path.
5. The slice at full depth (16 layers), bfloat16, batch 8, 1024-token
   prompts: launch counts checked exactly, prefill / decode times printed.
5b. The serving engine at full depth, bfloat16, 8 slots, 16 requests with a
   shared 384-token prefix: launch counts checked exactly against the
   engine's dispatch counts, tok/s, TTFT, TPOT and a profiled decode step.
6. One JSON line per kernel summary, the card line, then the result line.

It imports nothing of JAX. Without a GPU, or without the repository beside
it, it prints no result and exits non-zero.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense bf16 tensor / f32 non-tensor

# max |kernel - plain| allowed, by kernel and dtype: a few times the error
# measured on an H100 (bf16 prefill 3.9e-3, one output ulp near 0.5; bf16
# decode 2.4e-4; f32 prefill 1.1e-6, f32 decode 1.5e-7)
TOL = {
    ("prefill", "float32"): 1e-5,
    ("prefill", "bfloat16"): 8e-3,
    ("decode", "float32"): 1e-5,
    ("decode", "bfloat16"): 1e-3,
}
LOGIT_TOL = 1e-4  # phases 4/4b: float32 CPU vs card logits (measured 8.9e-6), 2 layers, full width
# phase 3b (paged decode, paged prefill, window decode): a few times the
# error measured on an H100 (bf16 1.95e-3 for all three, one output ulp near
# 0.5; f32 2.2e-7 to 4.3e-7)
PAGED_TOL = {"float32": 2e-6, "bfloat16": 8e-3}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, timeout=60, check=True,
    )
    return out.stdout.decode().strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing helpers
# ---------------------------------------------------------------------------


def measure(torch, fn, n=5, flush=None, kernel=None):
    """Device ms of one ``fn()``: the summed duration of the kernels it ran,
    from a ``torch.profiler`` trace, averaged over ``n`` runs with the L2
    cache evicted (untimed) before each. With ``kernel``, only kernels whose
    name contains it count (not a wrapper's small argument copies)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    dev = 0.0
    for _ in range(n):
        if flush is not None:
            flush()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        dev += sum(k.self_device_time_total for k in prof.key_averages()
                   if kernel is None or kernel in k.key) / 1e3
    if dev <= 0.0:
        raise RuntimeError("torch.profiler recorded no device time on this machine")
    return dev / n


def bound_ms(nbytes, flops, dtype_name):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels vs plain versions
# ---------------------------------------------------------------------------


def check_kernels(torch, results):
    import torch.nn.functional as F

    from nxdi_tpu_torch.ops.kernels import flash_attention as fa
    from nxdi_tpu_torch.ops.kernels import kv_commit as kc

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    scratch = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device=dev)

    def flush():
        scratch.zero_()

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(dtype)

    B, H, KV, D, S, S_cache, L = 8, 32, 8, 64, 1024, 2048, 16
    G = H // KV
    for dname in ("bfloat16", "float32"):
        dt = getattr(torch, dname)
        es = torch.tensor([], dtype=dt).element_size()

        # --- prefill ---
        q = randn((B, S, H, D), dt).transpose(1, 2)  # the model's head-split layout
        k = randn((B, S, KV, D), dt).transpose(1, 2)
        v = randn((B, S, KV, D), dt).transpose(1, 2)
        # the positions the model gives a right-padded batch: every row, pad
        # lanes included, runs 0..S-1 (the kernel reads only each row's start),
        # so every query row is computed and compared
        pos = torch.arange(S, device=dev, dtype=torch.int32)[None].expand(B, S).contiguous()
        got = fa.flash_attention_prefill(q, k, v, pos, pos)
        want = fa.flash_attention_prefill_plain(q, k, v, pos, pos)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        tol = TOL[("prefill", dname)]
        assert err <= tol, f"prefill {dname}: max abs err {err} > {tol}"
        ms = measure(torch, lambda: fa.flash_attention_prefill(q, k, v, pos, pos), flush=flush,
                                kernel="prefill")
        plain_ms = measure(torch, lambda: fa.flash_attention_prefill_plain(q, k, v, pos, pos),
                           n=3, flush=flush)
        ke, ve = k.repeat_interleave(G, dim=1), v.repeat_interleave(G, dim=1)
        lib_ms = measure(torch, lambda: F.scaled_dot_product_attention(q, ke, ve, is_causal=True),
                         flush=flush)
        flops = 4 * B * H * D * (S * (S + 1) // 2)
        nbytes = (2 * B * H * S * D + 2 * B * KV * S * D) * es
        bms, by = bound_ms(nbytes, flops, dname)
        results.append(dict(kernel="prefill", dtype=dname, max_abs_err=err, tol=tol, ms=ms,
                            plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms, bound_by=by))
        log(f"[kernels] prefill {dname}: err {err:.3g} kernel {ms:.4f} ms plain {plain_ms:.4f} "
            f"sdpa {lib_ms:.4f} bound {bms:.4f} ({by})")
        del q, k, v, ke, ve, got, want

        # ragged lengths, window / chunk masks, offset starts, a head dim that
        # is not a multiple of 16: correctness only
        for (Sx, Dx, win, chk) in ((300, 64, 100, None), (300, 64, None, 128), (200, 40, None, None)):
            qx = randn((2, Sx, 8, Dx), dt).transpose(1, 2)
            kx = randn((2, Sx, 2, Dx), dt).transpose(1, 2)
            vx = randn((2, Sx, 2, Dx), dt).transpose(1, 2)
            px = torch.arange(Sx, device=dev, dtype=torch.int32)[None].expand(2, Sx) + torch.tensor(
                [[0], [37]], device=dev, dtype=torch.int32)
            got = fa.flash_attention_prefill(qx, kx, vx, px, px, sliding_window=win, chunk_size=chk)
            want = fa.flash_attention_prefill_plain(qx, kx, vx, px, px, sliding_window=win,
                                                    chunk_size=chk)
            torch.cuda.synchronize()
            errx = (got.float() - want.float()).abs().max().item()
            assert errx <= tol, f"prefill {dname} S={Sx} D={Dx} win={win} chunk={chk}: err {errx}"
            log(f"[kernels] prefill {dname} S={Sx} D={Dx} window={win} chunk={chk}: err {errx:.3g}")

        # --- fused decode (stacked entry, layer 5 of 16; kv_len = TKG bucket) ---
        ks = randn((L, B, KV, S_cache, D), dt)
        vs = randn((L, B, KV, S_cache, D), dt)
        qd = randn((B, 1, H, D), dt).transpose(1, 2)
        kn = randn((B, 1, KV, D), dt).transpose(1, 2)
        vn = randn((B, 1, KV, D), dt).transpose(1, 2)
        qpos = torch.tensor([[1024 + 37 * b] for b in range(B)], device=dev, dtype=torch.int32)
        qpos[0, 0] = 0  # decode at position 0: only the fresh row is visible
        li, kv_len = 5, S_cache
        got = fa.flash_attention_decode_fused_stacked(qd, ks, vs, kn, vn, qpos, li, kv_len=kv_len)
        want = fa.flash_attention_decode_fused_plain(qd, ks[li], vs[li], kn, vn, qpos, kv_len=kv_len)
        got_l = fa.flash_attention_decode_fused(
            qd, ks[li], vs[li], kn, vn, qpos,
            torch.arange(S_cache, device=dev)[None].expand(B, S_cache), kv_len=1536,
        )
        want_l = fa.flash_attention_decode_fused_plain(qd, ks[li], vs[li], kn, vn, qpos, kv_len=1536)
        torch.cuda.synchronize()
        err = max((got.float() - want.float()).abs().max().item(),
                  (got_l.float() - want_l.float()).abs().max().item())
        tol = TOL[("decode", dname)]
        assert err <= tol, f"decode {dname}: max abs err {err} > {tol}"
        ms = measure(torch, lambda: fa.flash_attention_decode_fused_stacked(
            qd, ks, vs, kn, vn, qpos, li, kv_len=kv_len), flush=flush, kernel="decode_kernel")
        plain_ms = measure(torch, lambda: fa.flash_attention_decode_fused_plain(
            qd, ks[li], vs[li], kn, vn, qpos, kv_len=kv_len), flush=flush)
        # library yardstick: SDPA over [cache window | fresh row] with the
        # strict-causal mask, K/V concatenated and expanded beforehand
        kcat = torch.cat([ks[li], kn], dim=2).repeat_interleave(G, dim=1)
        vcat = torch.cat([vs[li], vn], dim=2).repeat_interleave(G, dim=1)
        slot = torch.arange(S_cache + 1, device=dev)
        mask = (slot[None, :] < qpos) | (slot[None, :] == S_cache)
        mask = mask[:, None, None, :]
        lib_ms = measure(torch, lambda: F.scaled_dot_product_attention(
            qd, kcat, vcat, attn_mask=mask), flush=flush)
        visible = int(torch.clamp(qpos[:, 0], max=kv_len).sum().item())
        flops = 4 * H * D * (visible + B)
        nbytes = (2 * KV * D * (visible + B) + 2 * B * H * D) * es
        bms, by = bound_ms(nbytes, flops, dname)
        results.append(dict(kernel="decode", dtype=dname, max_abs_err=err, tol=tol, ms=ms,
                            plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms, bound_by=by))
        log(f"[kernels] decode {dname}: err {err:.3g} kernel {ms:.4f} ms plain {plain_ms:.4f} "
            f"sdpa {lib_ms:.4f} bound {bms:.4f} ({by})")
        del kcat, vcat

        # --- commit (one dropped slot) ---
        kr = randn((L, B, KV, 1, D), dt)
        vr = randn((L, B, KV, 1, D), dt)
        slots = qpos.clone()
        slots[3, 0] = -1
        k_ref, v_ref = ks.clone(), vs.clone()
        kc.kv_commit_rows_plain(k_ref, v_ref, kr, vr, slots)
        kc.kv_commit_rows(ks, vs, kr, vr, slots)
        torch.cuda.synchronize()
        assert torch.equal(ks, k_ref) and torch.equal(vs, v_ref), f"commit {dname}: not bit-exact"
        ms = measure(torch, lambda: kc.kv_commit_rows(ks, vs, kr, vr, slots), flush=flush,
                              kernel="kv_commit_kernel")
        plain_ms = measure(torch, lambda: kc.kv_commit_rows_plain(ks, vs, kr, vr, slots), flush=flush)
        valid = (slots[:, 0] >= 0).nonzero()[:, 0]
        sl = slots[valid, 0].long()
        zero = torch.zeros_like(valid)

        def library_commit():
            ks[:, valid, :, sl] = kr[:, valid, :, zero]
            vs[:, valid, :, sl] = vr[:, valid, :, zero]

        lib_ms = measure(torch, library_commit, flush=flush)
        nbytes = 2 * 2 * L * int(valid.numel()) * KV * D * es  # rows read + written, k and v
        bms, by = bound_ms(nbytes, 0, dname)
        results.append(dict(kernel="commit", dtype=dname, max_abs_err=0.0, tol=0.0, ms=ms,
                            plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms, bound_by=by))
        log(f"[kernels] commit {dname}: exact; kernel {ms:.4f} ms plain {plain_ms:.4f} "
            f"index_put {lib_ms:.4f} bound {bms:.5f} ({by})")
        del ks, vs, k_ref, v_ref
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 3b: the serving engine's kernels vs plain versions
# ---------------------------------------------------------------------------


def _kernel_row(results, name, dname, err, ms, plain_ms, lib_ms, nbytes, flops):
    bms, by = bound_ms(nbytes, flops, dname)
    tol = PAGED_TOL[dname]
    assert err <= tol, f"{name} {dname}: max abs err {err} > {tol}"
    results.append(dict(kernel=name, dtype=dname, max_abs_err=err, tol=tol, ms=ms,
                        plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms, bound_by=by))
    log(f"[kernels] {name} {dname}: err {err:.3g} kernel {ms:.4f} ms plain {plain_ms:.4f} "
        f"library {lib_ms:.4f} bound {bms:.4f} ({by})")


def check_paged_kernels(torch, results):
    """Paged decode at B=8, H=32, KV=8, D=64, block 128, 136 blocks, table
    width 16, q_pos spread over 0..2000 with a hole; paged prefill at B=1,
    Sq=512 from 512 (timed) and from a 384-token prefix; window decode at
    B=8, Sk=2048. The library yardstick is SDPA over K/V gathered through
    the table (the gather included) or over the GQA-expanded window."""
    import torch.nn.functional as F

    from nxdi_tpu_torch.ops.kernels import flash_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4321)
    scratch = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device=dev)

    def flush():
        scratch.zero_()

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(dtype)

    B, H, KV, D, bs, nblk, NB, Sk = 8, 32, 8, 64, 128, 136, 16, 2048
    G = H // KV
    qpos = torch.linspace(0, 2000, B, device=dev).long()
    perm = torch.randperm(nblk, generator=torch.Generator().manual_seed(0)).tolist()
    bt = torch.full((B, NB), -1, dtype=torch.int32)
    nxt = 0
    for b in range(B):
        n = int(qpos[b]) // bs + 1
        bt[b, :n] = torch.tensor(perm[nxt:nxt + n], dtype=torch.int32)
        nxt += n
    bt[3, 2] = -1  # a hole inside row 3's attended range
    bt = bt.to(dev)
    # the same pool seen as 16-slot blocks: block j of 128 is blocks 8j..8j+7
    sub = bs // 16
    bt16 = torch.where(bt[:, :, None] >= 0, bt[:, :, None] * sub + torch.arange(sub, device=dev),
                       -1).reshape(B, -1).to(torch.int32)
    slot_pos = torch.arange(NB * bs, device=dev)
    live = torch.repeat_interleave(bt >= 0, bs, dim=1) & (slot_pos[None] <= qpos[:, None])
    visible = int(live.sum())

    def gathered(cache, table, n_rows):
        rows = (table.long()[:, :, None] * bs + torch.arange(bs, device=dev)).reshape(n_rows, -1)
        return cache[rows.clamp(min=0)].transpose(1, 2)  # (n, KV, W, D)

    for dname in ("bfloat16", "float32"):
        dt = getattr(torch, dname)
        es = torch.tensor([], dtype=dt).element_size()
        kc, vc = randn((nblk * bs, KV, D), dt), randn((nblk * bs, KV, D), dt)

        # --- paged decode ---
        q = randn((B, 1, H, D), dt).transpose(1, 2)
        qp = qpos[:, None].to(torch.int32)
        got = fa.paged_attention_decode(q, kc, vc, bt, qp, block_size=bs)
        want = fa.paged_attention_decode_plain(q, kc, vc, bt, qp, block_size=bs)
        got16 = fa.paged_attention_decode(q, kc, vc, bt16, qp, block_size=16, k_scale=0.5,
                                          v_scale=2.0)
        want16 = fa.paged_attention_decode_plain(q, kc, vc, bt16, qp, block_size=16,
                                                 k_scale=0.5, v_scale=2.0)
        torch.cuda.synchronize()
        err = max((got.float() - want.float()).abs().max().item(),
                  (got16.float() - want16.float()).abs().max().item())
        ms = measure(torch, lambda: fa.paged_attention_decode(q, kc, vc, bt, qp, block_size=bs),
                     flush=flush, kernel="decode_kernel")
        plain_ms = measure(torch, lambda: fa.paged_attention_decode_plain(
            q, kc, vc, bt, qp, block_size=bs), flush=flush)
        mask = live[:, None, None, :]

        def library_decode():
            kg = gathered(kc, bt, B).repeat_interleave(G, dim=1)
            vg = gathered(vc, bt, B).repeat_interleave(G, dim=1)
            return F.scaled_dot_product_attention(q, kg, vg, attn_mask=mask)

        lib_ms = measure(torch, library_decode, flush=flush)
        _kernel_row(results, "paged_decode", dname, err, ms, plain_ms, lib_ms,
                    (2 * visible * KV * D + 2 * B * H * D) * es + bt.numel() * 4,
                    4 * H * D * visible)

        # --- window decode over the gathered window's layout ---
        kw = randn((B, Sk, KV, D), dt).transpose(1, 2)
        vw = randn((B, Sk, KV, D), dt).transpose(1, 2)
        kv_pos = torch.arange(Sk, device=dev, dtype=torch.int32)[None].expand(B, Sk)
        got = fa.flash_attention_decode(q, kw, vw, qp, kv_pos)
        want = fa.flash_attention_decode_plain(q, kw, vw, qp, kv_pos)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        ms = measure(torch, lambda: fa.flash_attention_decode(q, kw, vw, qp, kv_pos),
                     flush=flush, kernel="decode_kernel")
        plain_ms = measure(torch, lambda: fa.flash_attention_decode_plain(q, kw, vw, qp, kv_pos),
                           flush=flush)
        wmask = (kv_pos <= qp)[:, None, None, :]
        kwe, vwe = kw.repeat_interleave(G, dim=1), vw.repeat_interleave(G, dim=1)
        lib_ms = measure(torch, lambda: F.scaled_dot_product_attention(q, kwe, vwe,
                                                                       attn_mask=wmask),
                         flush=flush)
        seen = int((kv_pos <= qp).sum())
        _kernel_row(results, "window_decode", dname, err, ms, plain_ms, lib_ms,
                    (2 * seen * KV * D + 2 * B * H * D) * es, 4 * H * D * seen)
        del kw, vw, kwe, vwe

        # --- paged prefill: a 512-token chunk after 512 (timed) or 384 cached ---
        Sq = 512
        bt1 = bt[7:8]  # 16 live blocks: positions 0..2047
        qx = randn((1, Sq, H, D), dt).transpose(1, 2)
        err = 0.0
        for start in (384, 512):
            qpx = (start + torch.arange(Sq, device=dev, dtype=torch.int32))[None]
            got = fa.paged_attention_prefill(qx, kc, vc, bt1, qpx, block_size=bs)
            want = fa.paged_attention_prefill_plain(qx, kc, vc, bt1, qpx, block_size=bs)
            torch.cuda.synchronize()
            err = max(err, (got.float() - want.float()).abs().max().item())
        ms = measure(torch, lambda: fa.paged_attention_prefill(qx, kc, vc, bt1, qpx,
                                                               block_size=bs),
                     flush=flush, kernel="prefill")
        plain_ms = measure(torch, lambda: fa.paged_attention_prefill_plain(
            qx, kc, vc, bt1, qpx, block_size=bs), n=3, flush=flush)
        pmask = (slot_pos[None, :] <= qpx[0][:, None])[None, None]

        def library_prefill():
            kg = gathered(kc, bt1, 1).repeat_interleave(G, dim=1)
            vg = gathered(vc, bt1, 1).repeat_interleave(G, dim=1)
            return F.scaled_dot_product_attention(qx, kg, vg, attn_mask=pmask)

        lib_ms = measure(torch, library_prefill, flush=flush)
        pairs = int(pmask.sum())  # (query, key) pairs attended
        _kernel_row(results, "paged_prefill", dname, err, ms, plain_ms, lib_ms,
                    (2 * Sq * H * D + 2 * (start + Sq) * KV * D) * es, 4 * H * D * pairs)
        del kc, vc
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phases 4 and 5: the slice through generate()
# ---------------------------------------------------------------------------


def make_app(ml, TorchConfig, OnDeviceSamplingConfig, TorchModelForCausalLM, dense, *,
             layers, dtype, batch, seq_len, ctx_len, device, params=None, output_logits=False):
    tcfg = TorchConfig(
        tp_degree=1, batch_size=batch, seq_len=seq_len, max_context_length=ctx_len,
        dtype=dtype, on_device_sampling_config=OnDeviceSamplingConfig(),
        attn_kernel_enabled=True, attn_tkg_kernel_enabled=True,
        output_logits=output_logits, skip_warmup=False,
    )
    cfg = ml.LlamaInferenceConfig(tcfg, **dict(ml.LLAMA_3_2_1B, num_hidden_layers=layers))
    arch = ml.build_arch(cfg)

    class App(TorchModelForCausalLM):
        def build_params(self):
            if params is not None:
                return params
            return dense.random_params(arch, seed=0, device=device)

    app = App("<random>", cfg, model_family=ml, device=device)
    app.load()
    return app, arch


def recording(app, log_list):
    """Wrap ``app.forward`` so each dispatch's last-position logits are kept."""
    inner = app.forward

    def fwd(*a, **kw):
        out = inner(*a, **kw)
        log_list.append(out["logits"][:, -1, :].float().cpu())
        return out

    app.forward = fwd


def prompts(rng, B, S, lengths, vocab):
    ids = rng.integers(1, vocab, size=(B, S)).astype("int64")
    mask = (ids * 0 + 1).astype("int32")
    for b, n in enumerate(lengths):
        ids[b, n:] = 0
        mask[b, n:] = 0
    return ids, mask


def slice_vs_cpu(torch, np, mods):
    ml, TorchConfig, ODSC, App, dense, Adapter = mods
    arch_kwargs = dict(layers=2, dtype="float32", batch=2, seq_len=256, ctx_len=128,
                       output_logits=True)
    cpu_app, arch = make_app(ml, TorchConfig, ODSC, App, dense, device="cpu", **arch_kwargs)
    gpu_app, _ = make_app(ml, TorchConfig, ODSC, App, dense, device="cuda",
                          params=cpu_app.params, **arch_kwargs)
    ids, mask = prompts(np.random.default_rng(7), 2, 128, [128, 97], arch.vocab_size)
    logs_cpu, logs_gpu = [], []
    recording(cpu_app, logs_cpu)
    recording(gpu_app, logs_gpu)
    out_cpu = Adapter(cpu_app).generate(ids, attention_mask=mask, max_new_tokens=16)
    out_gpu = Adapter(gpu_app).generate(ids, attention_mask=mask, max_new_tokens=16)
    worst, compared = 0.0, 0
    for step, (lc, lg) in enumerate(zip(logs_cpu, logs_gpu)):
        err = (lc - lg).abs().max().item()
        worst = max(worst, err)
        compared += 1
        assert err <= LOGIT_TOL, f"phase 4 step {step}: logits differ by {err} > {LOGIT_TOL}"
        tc, tg = lc.argmax(-1), lg.argmax(-1)
        if not torch.equal(tc, tg):
            top2 = lc.topk(2, dim=-1).values
            gap = (top2[:, 0] - top2[:, 1])[tc != tg].max().item()
            assert gap <= LOGIT_TOL, f"phase 4 step {step}: tokens differ at top-2 gap {gap}"
            log(f"[slice-2L] step {step}: near-tie token flip (gap {gap:.3g}); stopping compare")
            break
    else:
        assert (out_cpu == out_gpu).all(), "phase 4: generated tokens differ"
    log(f"[slice-2L] {compared} steps compared, max logit diff {worst:.3g} (tol {LOGIT_TOL})")
    return worst


def slice_full_depth(torch, np, mods, card):
    from nxdi_tpu_torch.ops.kernels import flash_attention as fa
    from nxdi_tpu_torch.ops.kernels import kv_commit as kc

    ml, TorchConfig, ODSC, App, dense, Adapter = mods
    B, P, NEW, L = 8, 1024, 32, 16
    t0 = time.perf_counter()
    app, arch = make_app(ml, TorchConfig, ODSC, App, dense, layers=L, dtype="bfloat16",
                         batch=B, seq_len=2048, ctx_len=P, device="cuda", output_logits=True)
    log(f"[slice-16L] load + warmup {time.perf_counter() - t0:.1f} s")
    ids, mask = prompts(np.random.default_rng(11), B, P, [P, P, 1000, P, 731, P, P, 1023],
                        arch.vocab_size)

    times, finite = [], []
    inner = app.forward

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = inner(*a, **kw)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        finite.append(bool(torch.isfinite(out["logits"]).all()))
        return out

    app.forward = timed
    fa.flash_attention_prefill.launches = 0
    fa.flash_attention_decode_fused.launches = 0
    kc.kv_commit_rows.launches = 0
    out = Adapter(app).generate(ids, attention_mask=mask, max_new_tokens=NEW)
    counts = {
        "prefill": fa.flash_attention_prefill.launches,
        "decode": fa.flash_attention_decode_fused.launches,
        "commit": kc.kv_commit_rows.launches,
    }
    steps = len(times) - 1
    assert steps == NEW - 1, f"expected {NEW - 1} decode steps, ran {steps}"
    want = {"prefill": L, "decode": L * steps, "commit": steps}
    assert counts == want, f"launch counts {counts} != {want}"
    strategies = set()
    for w in app.models.values():
        for s in w.attention_strategies.values():
            strategies |= set(s)
    assert strategies == {"cte_flash_kernel", "tkg_fused_kernel_stacked"}, strategies
    assert all(finite), "phase 5: non-finite logits"
    gen = np.stack([out[b, n:n + NEW] for b, n in enumerate(mask.sum(axis=1))])
    assert gen.shape == (B, NEW) and (gen >= 0).all() and (gen < arch.vocab_size).all()
    # one more decode step under the profiler: device busy vs the step's wall
    from torch.profiler import ProfilerActivity, profile

    nxt = np.array([[int(out[b, n + NEW - 1])] for b, n in enumerate(mask.sum(axis=1))], "int32")
    pos = (mask.sum(axis=1) + NEW - 1).astype("int32")[:, None]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        inner(nxt, pos, last_token_index=np.zeros((B,), "int32"))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    by_kernel = sorted(((k.self_device_time_total / 1e3, k.key) for k in prof.key_averages()),
                       reverse=True)
    busy_ms = sum(t for t, _ in by_kernel)
    log(f"[slice-16L] profiled decode step: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
        f"(idle {100 * (1 - busy_ms / wall_ms):.1f}%); top: "
        + "; ".join(f"{name[:60]} {t:.3f} ms" for t, name in by_kernel[:6]))
    prefill_ms = times[0] * 1e3
    decode_ms = float(np.mean(times[1:steps + 1])) * 1e3
    tok_s = B * steps / sum(times[1:steps + 1])
    log(f"[slice-16L] {card}: prefill {prefill_ms:.2f} ms, decode {decode_ms:.3f} ms/step, "
        f"{tok_s:.1f} tok/s (B={B}, prompt {P}, {NEW} new)")
    return counts, dict(prefill_ms=prefill_ms, decode_ms_per_step=decode_ms, decode_tok_s=tok_s,
                        profiled_step_wall_ms=wall_ms, profiled_step_busy_ms=busy_ms,
                        profiled_step_top=by_kernel[:10], card=card)


# ---------------------------------------------------------------------------
# phases 4b and 5b: the paged serving engine
# ---------------------------------------------------------------------------


def make_engine_app(ml, TorchConfig, ODSC, App, dense, *, layers, dtype, slots, seq_len, ctx_len,
                    num_blocks, chunk, block_tkg, device, params=None):
    tcfg = TorchConfig(
        tp_degree=1, batch_size=1, ctx_batch_size=1, tkg_batch_size=slots, seq_len=seq_len,
        max_context_length=ctx_len, dtype=dtype, on_device_sampling_config=ODSC(),
        enable_bucketing=True, is_block_kv_layout=True, pa_block_size=128,
        pa_num_blocks=num_blocks, is_prefix_caching=True,
        chunked_prefill_config={"chunk_size": chunk},
        attn_kernel_enabled=True, attn_tkg_kernel_enabled=True,
        attn_block_tkg_kernel_enabled=block_tkg, output_logits=True, skip_warmup=False,
    )
    cfg = ml.LlamaInferenceConfig(tcfg, **dict(ml.LLAMA_3_2_1B, num_hidden_layers=layers))
    arch = ml.build_arch(cfg)

    class EngineApp(App):
        def build_params(self):
            if params is not None:
                return params
            return dense.random_params(arch, seed=0, device=device)

    app = EngineApp("<random>", cfg, model_family=ml, device=device)
    app.load()
    return app, arch


def strategies_of(app):
    out = set()
    for w in app.models.values():
        for s in w.attention_strategies.values():
            out |= set(s)
    return out


def engine_vs_cpu(torch, np, mods):
    """Phase 4b: the same traffic through a CPU engine (plain versions) and
    a card engine (kernels): 6 requests, interleaved arrivals, two sharing a
    256-token (2-block) prefix, one 300-token prompt longer than the
    256-token chunk, and one forced preemption. Returns the card run's
    window-decode launches, which must be exactly 2 per decode dispatch, as
    the flash and paged prefill launches must be per CTE and prefix-prefill
    dispatch."""
    from nxdi_tpu_torch.ops.kernels import flash_attention as fa
    from nxdi_tpu_torch.runtime.application import TAG_PREFIX_PREFILL
    from nxdi_tpu_torch.runtime.model_wrapper import TAG_CONTEXT_ENCODING, TAG_TOKEN_GENERATION
    from nxdi_tpu_torch.serving import InferenceEngine, SamplingParams, SchedulerConfig

    ml, TorchConfig, ODSC, App, dense, _ = mods
    L = 2
    kw = dict(layers=L, dtype="float32", slots=4, seq_len=512, ctx_len=512, num_blocks=24,
              chunk=256, block_tkg=False)
    cpu_app, arch = make_engine_app(ml, TorchConfig, ODSC, App, dense, device="cpu", **kw)
    gpu_app, _ = make_engine_app(ml, TorchConfig, ODSC, App, dense, device="cuda",
                                 params=cpu_app.params, **kw)
    rng = np.random.default_rng(5)
    shared = rng.integers(1, arch.vocab_size, 256).tolist()
    prompts = [rng.integers(1, arch.vocab_size, n).tolist() for n in (300, 140)]
    prompts += [shared + rng.integers(1, arch.vocab_size, n).tolist() for n in (20, 35)]
    prompts += [rng.integers(1, arch.vocab_size, n).tolist() for n in (90, 200)]

    def drive(app):
        logits = []
        inner = app.forward

        def fwd(*a, **k):
            out = inner(*a, **k)
            logits.append(out["logits"][:, -1, :].float().cpu())
            return out

        app.forward = fwd
        # FCFS admission: cache-aware admission's starvation bound reads the
        # wall clock, and the two runs must dispatch in the same order
        eng = InferenceEngine(app, SchedulerConfig(prefix_cache=True,
                                                   cache_aware_admission=False))
        sp = SamplingParams(max_new_tokens=16)
        reqs = [eng.add_request(prompts[0], sp), eng.add_request(prompts[1], sp)]
        outs = eng.step()
        reqs.append(eng.add_request(prompts[2], sp))
        outs += eng.step() + eng.step() + eng.step()  # the sharing prompt's prefill lands
        reqs.append(eng.add_request(prompts[3], sp))  # ... so this one hits its 2 blocks
        outs += eng.step()
        victim = eng.preempt_youngest()
        assert victim is not None, "phase 4b: nothing to preempt"
        reqs += [eng.add_request(p, sp) for p in prompts[4:]]
        outs += eng.run()
        got = {o.request_id: o.token_ids for o in outs}
        assert eng.prefix_cache.hits_n >= 1, "phase 4b: the shared prefix never hit"
        return [got[r.request_id] for r in reqs], logits, strategies_of(app), dict(eng.dispatches)

    cpu_streams, cpu_logits, cpu_strats, _ = drive(cpu_app)
    kernels = {"prefill": fa.flash_attention_prefill, "paged_prefill": fa.paged_attention_prefill,
               "paged_decode": fa.paged_attention_decode, "window_decode": fa.flash_attention_decode}
    for fn in kernels.values():
        fn.launches = 0
    gpu_streams, gpu_logits, gpu_strats, disp = drive(gpu_app)
    counts = {k: fn.launches for k, fn in kernels.items()}
    want = {
        "prefill": L * disp[TAG_CONTEXT_ENCODING],
        "paged_prefill": L * disp[TAG_PREFIX_PREFILL],
        "paged_decode": 0,
        "window_decode": L * disp[TAG_TOKEN_GENERATION],
    }
    assert counts == want, f"phase 4b: launch counts {counts} != {want} (dispatches {disp})"
    assert all(counts[k] > 0 for k in ("prefill", "paged_prefill", "window_decode")), counts
    launches = counts["window_decode"]
    want = {"cte_flash_kernel", "cte_paged_kernel", "tkg_kernel"}
    assert cpu_strats == gpu_strats == want, (cpu_strats, gpu_strats)
    assert len(cpu_logits) == len(gpu_logits), "phase 4b: dispatch counts differ"
    worst = 0.0
    for i, (lc, lg) in enumerate(zip(cpu_logits, gpu_logits)):
        err = (lc - lg).abs().max().item()
        worst = max(worst, err)
        assert err <= LOGIT_TOL, f"phase 4b dispatch {i}: logits differ by {err} > {LOGIT_TOL}"
    assert cpu_streams == gpu_streams, "phase 4b: CPU and card streams differ"
    log(f"[engine-2L] {len(cpu_logits)} dispatches compared, max logit diff {worst:.3g} "
        f"(tol {LOGIT_TOL}); streams identical; launches {counts} (dispatches {disp})")
    return launches, worst


def engine_full_depth(torch, np, mods, card):
    """Phase 5b: 16 layers, bf16, 8 slots; 16 requests with prompts of
    200-992 tokens (prompt + 32 new tokens must fit the 1024-token decode
    window the prefix-prefill ladder sets), 8 of them sharing a 384-token
    prefix; 8 arrive at the start, then one per engine step."""
    from nxdi_tpu_torch.ops.kernels import flash_attention as fa
    from nxdi_tpu_torch.runtime.application import TAG_PREFIX_PREFILL
    from nxdi_tpu_torch.runtime.model_wrapper import TAG_CONTEXT_ENCODING, TAG_TOKEN_GENERATION
    from nxdi_tpu_torch.serving import InferenceEngine, SamplingParams, SchedulerConfig

    ml, TorchConfig, ODSC, App, dense, _ = mods
    L, NEW = 16, 32
    t0 = time.perf_counter()
    app, arch = make_engine_app(ml, TorchConfig, ODSC, App, dense, layers=L, dtype="bfloat16",
                                slots=8, seq_len=2048, ctx_len=1024, num_blocks=136, chunk=512,
                                block_tkg=True, device="cuda")
    log(f"[engine-16L] load + warmup {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(17)
    shared = rng.integers(1, arch.vocab_size, 384).tolist()
    lens = rng.integers(200, 993, 16)
    prompts = [
        (shared + rng.integers(1, arch.vocab_size, max(n - 384, 1)).tolist()) if i % 2 == 0
        else rng.integers(1, arch.vocab_size, n).tolist()
        for i, n in enumerate(lens)
    ]
    finite = []
    inner = app.forward

    def fwd(*a, **k):
        out = inner(*a, **k)
        finite.append(bool(torch.isfinite(out["logits"]).all()))
        return out

    app.forward = fwd
    eng = InferenceEngine(app, SchedulerConfig(prefix_cache=True))
    stamps = {}

    def on_token(req, tok):
        stamps.setdefault(req.request_id, []).append(time.perf_counter())

    for fn in (fa.flash_attention_prefill, fa.paged_attention_prefill, fa.paged_attention_decode,
               fa.flash_attention_decode):
        fn.launches = 0
    torch.cuda.synchronize()
    t_start = time.perf_counter()
    arrivals = {}
    pending = list(prompts)
    for p in pending[:8]:
        r = eng.add_request(p, SamplingParams(max_new_tokens=NEW), on_token=on_token)
        arrivals[r.request_id] = time.perf_counter()
    pending = pending[8:]
    outs = []
    while eng.has_work() or pending:
        if pending:
            r = eng.add_request(pending.pop(0), SamplingParams(max_new_tokens=NEW),
                                on_token=on_token)
            arrivals[r.request_id] = time.perf_counter()
        outs += eng.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    counts = {
        "prefill": fa.flash_attention_prefill.launches,
        "paged_prefill": fa.paged_attention_prefill.launches,
        "paged_decode": fa.paged_attention_decode.launches,
        "window_decode": fa.flash_attention_decode.launches,
    }
    disp = dict(eng.dispatches)
    want = {
        "prefill": L * disp[TAG_CONTEXT_ENCODING],
        "paged_prefill": L * disp[TAG_PREFIX_PREFILL],
        "paged_decode": L * disp[TAG_TOKEN_GENERATION],
        "window_decode": 0,
    }
    assert counts == want, f"phase 5b: launch counts {counts} != {want} (dispatches {disp})"
    assert all(counts[k] > 0 for k in ("prefill", "paged_prefill", "paged_decode")), counts
    strats = strategies_of(app)
    assert strats == {"cte_flash_kernel", "cte_paged_kernel", "tkg_paged_kernel"}, strats
    assert all(finite), "phase 5b: non-finite logits"
    assert len(outs) == 16 and all(len(o.token_ids) == NEW for o in outs)
    assert all(0 <= t < arch.vocab_size for o in outs for t in o.token_ids)
    hits = eng.prefix_cache.hits_n
    assert hits >= 1, "phase 5b: the shared prefix never hit"
    ttft = np.array([stamps[i][0] - arrivals[i] for i in arrivals]) * 1e3
    tpot = np.array([(stamps[i][-1] - stamps[i][0]) / (len(stamps[i]) - 1) for i in arrivals]) * 1e3
    tok_s = 16 * NEW / wall

    # one decode-only step under the profiler: 8 fresh short requests, each
    # prefilled by its own step, then a step that only decodes
    for _ in range(8):
        eng.add_request(rng.integers(1, arch.vocab_size, 200).tolist(),
                        SamplingParams(max_new_tokens=16))
        eng.step()
    from torch.profiler import ProfilerActivity, profile

    assert len(eng.scheduler.decodable()) == 8 and not eng.scheduler.waiting
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t) * 1e3
    by_kernel = sorted(((k.self_device_time_total / 1e3, k.key) for k in prof.key_averages()),
                       reverse=True)
    busy_ms = sum(t for t, _ in by_kernel)
    eng.run()
    stats = dict(
        card=card, wall_s=wall, tok_s=tok_s, ttft_p50_ms=float(np.percentile(ttft, 50)),
        ttft_p95_ms=float(np.percentile(ttft, 95)), tpot_p50_ms=float(np.percentile(tpot, 50)),
        dispatches=disp, prefix_hits=hits, prefix_tokens_saved=eng.prefix_cache.tokens_saved_n,
        profiled_step_wall_ms=step_ms, profiled_step_busy_ms=busy_ms,
        profiled_step_idle_pct=100 * (1 - busy_ms / step_ms), profiled_step_top=by_kernel[:10],
    )
    log(f"[engine-16L] {card}: {tok_s:.1f} tok/s over {wall:.2f} s; TTFT p50 "
        f"{stats['ttft_p50_ms']:.2f} ms p95 {stats['ttft_p95_ms']:.2f} ms; TPOT p50 "
        f"{stats['tpot_p50_ms']:.3f} ms; dispatches {disp}; prefix hits {hits}")
    log(f"[engine-16L] profiled decode step (8 rows): wall {step_ms:.3f} ms, device busy "
        f"{busy_ms:.3f} ms (idle {stats['profiled_step_idle_pct']:.1f}%); top: "
        + "; ".join(f"{name[:60]} {t:.3f} ms" for t, name in by_kernel[:6]))
    return counts, stats


def main() -> int:
    repo = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(repo, "nxdi_tpu_torch")):
        log("chip_smoke: the nxdi_tpu_torch package is not beside this script")
        return 2
    sys.path.insert(0, repo)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from nxdi_tpu_torch.config import OnDeviceSamplingConfig, TorchConfig
    from nxdi_tpu_torch.generation.hf_adapter import HuggingFaceGenerationAdapter
    from nxdi_tpu_torch.models import dense
    from nxdi_tpu_torch.models.llama import modeling_llama as ml
    from nxdi_tpu_torch.ops.kernels import _build
    from nxdi_tpu_torch.runtime.application import TorchModelForCausalLM

    mods = (ml, TorchConfig, OnDeviceSamplingConfig, TorchModelForCausalLM, dense,
            HuggingFaceGenerationAdapter)
    card = card_line()
    log(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    _build.build(verbose=True)
    log(f"[build] {time.perf_counter() - t0:.1f} s")
    _build.library()

    kernel_results = []
    check_kernels(torch, kernel_results)
    check_paged_kernels(torch, kernel_results)
    slice_vs_cpu(torch, np, mods)
    window_launches, engine_logit_err = engine_vs_cpu(torch, np, mods)
    counts, slice_times = slice_full_depth(torch, np, mods, card)
    engine_counts, engine_stats = engine_full_depth(torch, np, mods, card)
    counts = dict(counts, window_decode=window_launches,
                  paged_prefill=engine_counts["paged_prefill"],
                  paged_decode=engine_counts["paged_decode"])
    engine_stats["phase_4b_max_logit_err"] = engine_logit_err

    sources = {
        "prefill": ("flash_attention_prefill", "nxdi_tpu_torch/csrc/flash_prefill.cu",
                    "nxdi_tpu/ops/kernels/flash_attention.py:234"),
        "decode": ("flash_attention_decode_fused", "nxdi_tpu_torch/csrc/flash_decode.cu",
                   "nxdi_tpu/ops/kernels/flash_attention.py:509,629"),
        "commit": ("kv_commit_rows", "nxdi_tpu_torch/csrc/kv_commit.cu",
                   "nxdi_tpu/ops/kernels/kv_commit.py:170"),
        "window_decode": ("flash_attention_decode", "nxdi_tpu_torch/csrc/window_decode.cu",
                          "nxdi_tpu/ops/kernels/flash_attention.py:337"),
        "paged_prefill": ("paged_attention_prefill", "nxdi_tpu_torch/csrc/paged_prefill.cu",
                          "nxdi_tpu/ops/kernels/flash_attention.py:946"),
        "paged_decode": ("paged_attention_decode", "nxdi_tpu_torch/csrc/paged_decode.cu",
                         "nxdi_tpu/ops/kernels/flash_attention.py:802"),
    }
    summary = []
    for key, (name, src, replaces) in sources.items():
        row = next(r for r in kernel_results if r["kernel"] == key and r["dtype"] == "bfloat16")
        summary.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": counts[key],
            **{f: row[f] for f in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms")},
        })
    os.makedirs(os.path.join(repo, "chiprun_out"), exist_ok=True)
    with open(os.path.join(repo, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "kernels": kernel_results, "slice": slice_times,
                   "engine": engine_stats, "counts": counts}, f, indent=1)
    print(json.dumps({"slice": slice_times, "engine": engine_stats,
                      "kernel_checks": kernel_results}))
    print(json.dumps({"kernels": summary}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
