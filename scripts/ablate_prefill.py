#!/usr/bin/env python3
"""Where the TMA + wgmma prefill body spends its time: the body timed as it
is and with parts of it removed, beside the mma.sync body and SDPA.

    python3 scripts/ablate_prefill.py [--calls 50]

Needs the card and nvcc. Each variant is a copy of ``nxdi_tpu_torch/csrc``
whose ``prefill_wgmma.cuh`` has one part cut out, built with the kernels'
own flags into ``build/ablate_prefill/<variant>/`` (``flash_prefill.cu``
alone) and called through the port's wrapper (``flash_attention_prefill``)
at phase 3's shape (B 8, H 32, KV 8, S 1024, bf16) at head dims 64 and 128:

- ``body``: the body as it is (its max error against the plain version is
  printed; the other variants compute wrong numbers on purpose);
- ``no_mask``: every kv tile takes the unmasked softmax (the diagonal too);
- ``no_softmax``: no softmax at all (the scores go straight to P);
- ``pipeline_only``: no products and no softmax: the TMA ring, the barriers
  and the epilogue alone;
- ``k_only``: the V tiles are not loaded (P.V reads the K tile): half the
  K/V bytes, the same arithmetic.

Times are CUDA-event means over ``--calls`` back-to-back calls after five
warm-up calls (no L2 flush: the variants are compared with each other in one
process). The last line is one JSON object with every time and the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

SOFTMAX = """        if (t_lo >= blk_vlo && t_lo + kFqBK - 1 <= blk_vhi && holes == 0) {
          fq_softmax<D, false>(st, sc, t_lo, scale_log2, tig);
        } else {
          fq_softmax<D, true, TABLE>(st, sc, t_lo, scale_log2, tig, holes, box_shift);
        }
"""
SCORES = "      if (i < n_live) fq_scores<D>(sc, qa, stage_of(it + i));\n"
PV = "      if (i > 0) fq_pv<D>(st, pa, stage_of(it + i - 1) + kTile);\n"
MASK_TEST = "if (t_lo >= blk_vlo && t_lo + kFqBK - 1 <= blk_vhi && holes == 0) {"
V_EXPECT = "            mbar_expect_tx(full, 2 * kTile);"
V_LOAD = ("              tma_load_4d(st + kTile + c * kFqBox, &tv, 64 * c, w.kvh, kt * kFqBK, w.b, "
          "full);\n")

def _edit(src: str, old: str, new: str = "") -> str:
    if old not in src:
        raise RuntimeError(f"prefill_wgmma.cuh no longer holds {old!r}: update the script")
    return src.replace(old, new)


VARIANTS = {
    "body": lambda s: s,
    "no_mask": lambda s: _edit(s, MASK_TEST, "if (true) {"),
    "no_softmax": lambda s: _edit(s, SOFTMAX),
    "pipeline_only": lambda s: _edit(_edit(_edit(s, SOFTMAX), SCORES), PV),
    "k_only": lambda s: _edit(_edit(_edit(s, V_EXPECT, V_EXPECT.replace("2 * kTile", "kTile")),
                                    V_LOAD), PV, PV.replace(" + kTile)", ")")),
}


def build(out_dir: Path):
    from nxdi_tpu_torch.ops.kernels import _build

    src_dir = REPO / "nxdi_tpu_torch" / "csrc"
    procs = {}
    for name, edit in VARIANTS.items():
        d = out_dir / name
        if d.exists():
            shutil.rmtree(d)
        shutil.copytree(src_dir, d)
        header = d / "prefill_wgmma.cuh"
        header.write_text(edit(header.read_text()))
        cmd = [_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
               "-shared", "-I", str(d), "-o", str(d / "lib.so"), str(d / "flash_prefill.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    for name, proc in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode:
            raise RuntimeError(f"{name}: build failed\n{log[-4000:]}")
    return {name: out_dir / name / "lib.so" for name in VARIANTS}


def events_ms(torch, fn, calls):
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--calls", type=int, default=50)
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F

    from nxdi_tpu_torch.ops.kernels import _build
    from nxdi_tpu_torch.ops.kernels import flash_attention as fa

    if not torch.cuda.is_available():
        print("ablate_prefill: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          stdout=subprocess.PIPE, text=True, check=True).stdout.strip()
    libs = build(REPO / "build" / "ablate_prefill")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    B, H, KV, S = 8, 32, 8, 1024
    result = {"card": card, "calls": args.calls, "shape": dict(B=B, H=H, KV=KV, S=S)}
    for D in (64, 128):
        def bf(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

        q, k, v = bf(B, S, H, D).transpose(1, 2), bf(B, S, KV, D).transpose(1, 2), \
            bf(B, S, KV, D).transpose(1, 2)
        pos = torch.arange(S, device=dev, dtype=torch.int32)[None].expand(B, S).contiguous()
        want = fa.flash_attention_prefill_plain(q, k, v, pos, pos)
        ke, ve = k.repeat_interleave(H // KV, 1), v.repeat_interleave(H // KV, 1)
        row = {"sdpa": events_ms(torch, lambda: F.scaled_dot_product_attention(
            q, ke, ve, is_causal=True), args.calls)}
        _build._lib = None  # the repository's own build, for the mma.sync body
        saved = fa.prefill_body
        fa.prefill_body = lambda *a: "mma"
        try:
            row["mma_sync"] = events_ms(torch, lambda: fa.flash_attention_prefill(
                q, k, v, pos, pos), args.calls)
        finally:
            fa.prefill_body = saved
        for name, path in libs.items():
            lib = ctypes.CDLL(str(path))
            lib.nxdi_flash_prefill.argtypes = _build.SIGNATURES["nxdi_flash_prefill"]
            lib.nxdi_flash_prefill.restype = ctypes.c_int
            _build._lib = lib
            got = fa.flash_attention_prefill(q, k, v, pos, pos)
            torch.cuda.synchronize()
            if name == "body":
                row["body_max_abs_err"] = (got.float() - want.float()).abs().max().item()
            row[name] = events_ms(torch, lambda: fa.flash_attention_prefill(q, k, v, pos, pos),
                                  args.calls)
        _build._lib = None
        result[f"D{D}"] = row
        print(f"D={D} ({card}): " + "; ".join(
            f"{key} {val:.4f}" if key != "body_max_abs_err" else f"err {val:.3g}"
            for key, val in row.items())
            + " (ms)", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
