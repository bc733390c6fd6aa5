#!/usr/bin/env python
"""Where phase 5f's bf16 speculative streams part from the plain greedy stream.

On one card, at Llama-3.2-1B's published width, 16 layers, bf16, phase 5's
prompts at batch 8 and ``chip_smoke.py``'s seeded random weights:

1. Teacher-forced along the non-speculative greedy stream's first new
   tokens, the logits of
   - ``decode_kernel``: the non-speculative dispatches (stacked fused-decode
     kernel, one token a step),
   - ``decode_plain``: the same steps on the plain two-part attention,
   - ``verify``: the speculation verify (one 5-token forward, plain
     two-part attention),
   - ``f32``: a float32 forward of the same tokens from the same weights
     (bf16 values held in f32, plain attention): the witness,
   each against the others (max |difference| over vocabulary, rows and
   positions). Every bf16 path is measured twice: with the plain attention's
   weighted sums rounded to bf16 per part (``pv="bf16"``, the JAX package's
   arithmetic) and accumulated in f32, rounded once (``pv="f32"``).
2. The speculative streams (fused and standard with a perfect and a 2-layer
   draft, Medusa chain and tree) against the non-speculative streams on the
   decode kernel and on the plain path: rows equal to the 32nd token, the
   first difference's top-2 gap in bf16 steps, and every emitted token's
   margin under the f32 witness (its best logit less the emitted token's).

Run on the card from the repository's root:

    python scripts/spec_numerics.py [--out chiprun_out/spec_numerics.json]
"""

import argparse
import dataclasses
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

L, P, NEW, K_SPEC, N_TF = 16, 1024, 32, 4, 5
RUNS = (("fused", "perfect"), ("fused", "weak"), ("standard", "perfect"), ("chain", None),
        ("tree", None))


def two_part_f32(q, kk, vv, k2, v2, q_pos, kv_pos, kv_pos2, *, scale=None, sliding_window=None,
                 chunk_size=None):
    """ops.attention.attention_two_part with the weighted sums in f32."""
    import torch

    from nxdi_tpu_torch.ops import attention as A

    B, H, Sq, D = q.shape
    KV, W = kk.shape[1], kk.shape[2]
    scale = D ** -0.5 if scale is None else scale
    qg = q.reshape(B, KV, H // KV, Sq, D).float()
    s = torch.cat([torch.einsum("bkgqd,bksd->bkgqs", qg, kk.float()),
                   torch.einsum("bkgqd,bksd->bkgqs", qg, k2.float())], dim=-1) * scale
    mask = torch.cat([A._mask_from_positions(q_pos, kv_pos, sliding_window, chunk_size),
                      A._mask_from_positions(q_pos, kv_pos2, sliding_window, chunk_size)], -1)
    s = torch.where(mask[:, None, None], s, torch.full_like(s, A.NEG_INF))
    w = torch.softmax(s, dim=-1)
    out = (torch.einsum("bkgqs,bksd->bkgqd", w[..., :W], vv.float())
           + torch.einsum("bkgqs,bksd->bkgqd", w[..., W:], v2.float()))
    return out.reshape(B, H, Sq, vv.shape[-1]).to(vv.dtype)


def grouped_f32(q, k, v, mask, scale=None):
    """ops.attention.grouped_attention with the weighted sum in f32."""
    import torch

    from nxdi_tpu_torch.ops import attention as A

    B, H, Sq, D = q.shape
    KV = k.shape[1]
    scale = D ** -0.5 if scale is None else scale
    qg = q.reshape(B, KV, H // KV, Sq, D).float()
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k.float()) * scale
    s = torch.where(mask[:, None, None], s, torch.full_like(s, A.NEG_INF))
    out = torch.einsum("bkgqs,bksd->bkgqd", torch.softmax(s, dim=-1), v.float())
    return out.reshape(B, H, Sq, v.shape[-1]).to(v.dtype)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "spec_numerics.json"))
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("spec_numerics: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from nxdi_tpu_torch.config import OnDeviceSamplingConfig, TorchConfig
    from nxdi_tpu_torch.generation.hf_adapter import HuggingFaceGenerationAdapter as Adapter
    from nxdi_tpu_torch.models import dense
    from nxdi_tpu_torch.models.base import causal_lm_forward
    from nxdi_tpu_torch.models.llama import modeling_llama as ml
    from nxdi_tpu_torch.ops import attention as A
    from nxdi_tpu_torch.ops.kernels import _build
    from nxdi_tpu_torch.runtime.application import TorchModelForCausalLM

    mods = (ml, TorchConfig, OnDeviceSamplingConfig, TorchModelForCausalLM, dense, Adapter)
    card = cs.card_line()
    _build.build(verbose=False)
    _build.library()
    params = cs.spec_params(ml, dense, torch, layers=L, dtype="bfloat16", device="cuda",
                            heads=4)
    B = 8
    ids, mask = cs.prompts(np.random.default_rng(11), B, P, [P, P, 1000, P, 731, P, P, 1023],
                           ml.LLAMA_3_2_1B["vocab_size"])
    lengths = mask.sum(axis=1)
    geo = dict(layers=L, dtype="bfloat16", batch=B, seq_len=2048, ctx_len=P, device="cuda")
    originals = (A.attention_two_part, A.grouped_attention)

    def set_pv(pv):
        A.attention_two_part, A.grouped_attention = (
            originals if pv == "bf16" else (two_part_f32, grouped_f32))

    params32 = cs.to_float32(params["target"])
    witness = None

    def gen_ref(tkg_kernel):
        app, _ = cs.make_app(ml, TorchConfig, OnDeviceSamplingConfig, TorchModelForCausalLM,
                             dense, params=params["target"], output_logits=True,
                             attn_tkg_kernel_enabled=tkg_kernel, **geo)
        logs = []
        cs.recording(app, logs)
        toks = Adapter(app).generate(ids, attention_mask=mask, max_new_tokens=NEW)
        return app, toks, torch.stack(logs, dim=1)  # (B, NEW, V)

    def first_diff(tokens, ref, ref_logits):
        rows = []
        for b, m in enumerate(lengths):
            d = np.flatnonzero(tokens[b, m:m + NEW] != ref[b, m:m + NEW])
            if not d.size:
                continue
            j = int(d[0])
            top2 = ref_logits[b, j].topk(2).values
            gap = float(top2[0] - top2[1])
            rows.append((b, j, gap, gap / cs.bf16_ulp(float(top2[0]))))
        return rows

    report = {"card": card, "teacher_forced": {}, "streams": {}}
    t0 = time.perf_counter()
    for pv in ("bf16", "f32"):
        set_pv(pv)
        refs = {}
        for name, kern in (("decode_kernel", True), ("decode_plain", False)):
            app, toks, logits = gen_ref(kern)
            refs[name] = (toks, logits)
            if name == "decode_kernel":
                w = next(iter(app.models.values()))
                inv_freq = w.inv_freq
                if witness is None:
                    witness = cs.Witness(torch, np, app, params32, ids, lengths, NEW)
                cache = app.kv_cache
                saved = {k: v.clone() for k, v in cache.items()}
                base = refs[name][0]
                cand = torch.tensor(np.stack([base[b, m:m + N_TF] for b, m in enumerate(lengths)]),
                                    dtype=torch.int32, device="cuda")
                pos = (torch.tensor(lengths, dtype=torch.int32, device="cuda")[:, None]
                       + torch.arange(N_TF, dtype=torch.int32, device="cuda")[None])
                sp = torch.ones((B, 3), device="cuda")
                lti = torch.zeros((B,), dtype=torch.int32, device="cuda")
                tf = {}
                with torch.inference_mode():
                    o, _ = causal_lm_forward(
                        w.arch, inv_freq, app.params, cache,
                        {"input_ids": cand, "position_ids": pos, "last_token_index": lti,
                         "sampling_params": sp},
                        attend_to_cache=True, kv_window=2048, layout=w.layout,
                        gather_last_token=False, output_logits=True, on_device_sampling=False)
                    tf["verify"] = o["logits"].float().cpu()
                    for k in cache:
                        cache[k].copy_(saved[k])
                    plain_arch = dataclasses.replace(w.arch, attn_tkg_kernel_enabled=False)
                    steps = []
                    for j in range(N_TF):
                        o, _ = causal_lm_forward(
                            plain_arch, inv_freq, app.params, cache,
                            {"input_ids": cand[:, j:j + 1], "position_ids": pos[:, j:j + 1],
                             "last_token_index": lti, "sampling_params": sp},
                            attend_to_cache=True, kv_window=2048, layout=w.layout,
                            gather_last_token=False, output_logits=True,
                            on_device_sampling=False)
                        steps.append(o["logits"][:, 0].float().cpu())
                    tf["decode_plain"] = torch.stack(steps, dim=1)
                    for k in cache:
                        cache[k].copy_(saved[k])
                del saved
                tf["decode_kernel"] = logits[:, 1:1 + N_TF]
                wl = witness.logits(base)
                tf["f32"] = wl[:, 1:1 + N_TF]
                refs["f32_of_kernel_stream"] = wl
                names = list(tf)
                report["teacher_forced"][pv] = {
                    f"{a} vs {c}": float((tf[a] - tf[c]).abs().max())
                    for i, a in enumerate(names) for c in names[i + 1:]}
                report["teacher_forced"][pv]["f32 top logit range"] = [
                    float(tf["f32"].max(-1).values.min()), float(tf["f32"].max(-1).values.max())]
                print(f"[{time.perf_counter() - t0:7.1f} s] pv {pv} teacher-forced: "
                      + json.dumps(report["teacher_forced"][pv]), file=sys.stderr, flush=True)
            del app
            gc.collect()
            torch.cuda.empty_cache()
        streams = {"decode_kernel": refs["decode_kernel"][0],
                   "decode_plain": refs["decode_plain"][0]}
        for kind, draft in RUNS:
            app = cs.make_spec_app(mods, kind, params, draft=draft, spec_len=K_SPEC,
                                   tree=cs.MC_TREE, **geo)
            streams[f"{kind} {draft or ''}".strip()] = Adapter(app).generate(
                ids, attention_mask=mask, max_new_tokens=NEW)
            del app
            gc.collect()
            torch.cuda.empty_cache()
        for name, toks in streams.items():
            wl = (refs["f32_of_kernel_stream"] if name == "decode_kernel"
                  else witness.logits(toks))
            mg = cs.margins(torch, toks, wl, lengths, NEW).numpy()
            steps = mg / np.vectorize(cs.bf16_ulp)(wl.max(-1).values.numpy())
            entry = {
                "f32_margin_max": float(mg.max()), "f32_margin_max_bf16_steps": float(steps.max()),
                "tokens_not_f32_argmax": int((mg > 0).sum()),
                "vs_kernel": first_diff(toks, *refs["decode_kernel"]),
                "vs_plain": first_diff(toks, *refs["decode_plain"])}
            report["streams"][f"{pv} {name}"] = entry
            print(f"[{time.perf_counter() - t0:7.1f} s] pv {pv} {name}: " + json.dumps(entry),
                  file=sys.stderr, flush=True)
    set_pv("bf16")
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(card)
    print(json.dumps({"teacher_forced": report["teacher_forced"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
