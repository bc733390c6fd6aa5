#!/usr/bin/env python3
"""How the one-byte paged prefill body splits its shared memory between
bf16 stages (what the consumers' wgmma read) and raw one-byte stages (what
TMA lands and the converting warps read): the body timed at each split.

    python3 scripts/stages_prefill_1b.py [--calls 50] [--csrc DIR] [--out DIR]

Needs the card and nvcc. Each variant is a copy of ``nxdi_tpu_torch/csrc``
whose ``prefill_wgmma.cuh`` sets ``kFq1bStages`` / ``kFq1bRaw`` (bf16 /
raw stages) for one head dim, built with the kernels' own flags into
``build/stages_prefill_1b/<variant>/`` (``paged_prefill.cu`` and
``paged_prefill_1b.cu`` alone) and called through the port's wrapper
(``paged_attention_prefill``) over a float8_e4m3fn pool (block 128, H 32,
KV 8, k_scale = v_scale = 0.25) at two shapes:

- ``3e``: phase 3e's, one row, a 512-token chunk after 512 cached;
- ``long``: four rows, a 512-token chunk after 3584 cached (32 kv tiles a
  q tile: the ring's depth at work).

A split must fit the 227 KB a block may hold (Q, bf16 stages of 2 x 16 KB
a 64 columns, raw stages of 2 x 8 KB a 64 bytes) and hold at least two
bf16 stages (the consumers read stage i's K beside stage i - 1's V).
Beside the variants: the same call over a bf16 pool (the bf16 body) and on
the mma.sync body (the earlier design), from the repository's own build.
``--csrc DIR`` builds the variants from another copy of the sources (an
earlier tree's, to compare two designs in one process). Times are the
device time of the prefill kernels (``torch.profiler``) summed over
``--calls`` back-to-back calls after five warm-up calls, per call (no L2
flush: the variants are compared with each other in one process; the
host's enqueue is not timed); every variant's output is checked equal, bit
for bit, to the bf16 body's on the up-cast pool. The last line is one JSON
object with every time and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

# (D, bf16 stages, raw stages); the first of each head dim is the body's own
VARIANTS = [(64, 4, 4), (64, 5, 2), (64, 4, 2), (64, 3, 3), (64, 2, 2),
            (128, 2, 2), (128, 2, 1)]
STAGES = re.compile(r"constexpr int kFq1bStages = D == 64 \? \d+ : \d+;")
RAW = re.compile(r"constexpr int kFq1bRaw = D == 64 \? \d+ : \d+;")


def _name(D, st, raw):
    return f"D{D}_{st}c{raw}r"


def build(out_dir: Path, src_dir: Path):
    from nxdi_tpu_torch.ops.kernels import _build

    procs = {}
    for D, st, raw in VARIANTS:
        name = _name(D, st, raw)
        d = out_dir / name
        if d.exists():
            shutil.rmtree(d)
        shutil.copytree(src_dir, d)
        header = d / "prefill_wgmma.cuh"
        text = header.read_text()
        if not (STAGES.search(text) and RAW.search(text)):
            raise RuntimeError("prefill_wgmma.cuh no longer sets kFq1bStages / kFq1bRaw as "
                               "this script expects: update it")
        other = 2  # the other head dim keeps a split that fits
        text = STAGES.sub(f"constexpr int kFq1bStages = D == 64 ? {st if D == 64 else other} : "
                          f"{st if D == 128 else other};", text)
        text = RAW.sub(f"constexpr int kFq1bRaw = D == 64 ? {raw if D == 64 else other} : "
                       f"{raw if D == 128 else other};", text)
        header.write_text(text)
        cmd = [_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
               "-shared", "-I", str(d), "-o", str(d / "lib.so"), str(d / "paged_prefill.cu"),
               str(d / "paged_prefill_1b.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    for name, proc in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode:
            raise RuntimeError(f"{name}: build failed\n{log[-4000:]}")
    return {name: out_dir / name / "lib.so" for name in procs}


def device_ms(torch, fn, calls):
    """Device ms per call of the prefill kernels ``fn`` launches."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(k.self_device_time_total for k in prof.key_averages() if "prefill" in k.key)
    if us <= 0:
        raise RuntimeError("torch.profiler recorded no prefill kernel time")
    return us / 1e3 / calls


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--calls", type=int, default=50)
    ap.add_argument("--csrc", type=Path, default=REPO / "nxdi_tpu_torch" / "csrc")
    ap.add_argument("--out", type=Path, default=REPO / "build" / "stages_prefill_1b")
    args = ap.parse_args()
    import torch

    from nxdi_tpu_torch.ops.kernels import _build
    from nxdi_tpu_torch.ops.kernels import flash_attention as fa

    if not torch.cuda.is_available():
        print("stages_prefill_1b: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          stdout=subprocess.PIPE, text=True, check=True).stdout.strip()
    libs = build(args.out, args.csrc.resolve())
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    H, KV, bs, Sq, sc = 32, 8, 128, 512, 0.25
    result = {"card": card, "calls": args.calls, "csrc": str(args.csrc)}
    for D in (64, 128):
        for shape, (B, start) in {"3e": (1, 512), "long": (4, 3584)}.items():
            nb = (start + Sq) // bs
            pool = B * nb
            kb = torch.randn((pool * bs, KV, D), generator=gen, device=dev).to(torch.bfloat16)
            vb = torch.randn((pool * bs, KV, D), generator=gen, device=dev).to(torch.bfloat16)
            k8, v8 = (x.float().div(sc).to(torch.float8_e4m3fn) for x in (kb, vb))
            k8b, v8b = k8.to(torch.bfloat16), v8.to(torch.bfloat16)
            bt = torch.randperm(pool, generator=torch.Generator().manual_seed(1)).reshape(B, nb)
            bt = bt.to(device=dev, dtype=torch.int32)
            q = torch.randn((B, Sq, H, D), generator=gen, device=dev).to(torch.bfloat16)
            q = q.transpose(1, 2)
            qp = (start + torch.arange(Sq, device=dev, dtype=torch.int32))[None].expand(B, Sq)
            kw = dict(block_size=bs, k_scale=sc, v_scale=sc)

            def one_byte():
                return fa.paged_attention_prefill(q, k8, v8, bt, qp, **kw)

            _build._lib = None  # the repository's own build
            want = fa.paged_attention_prefill(q, k8b, v8b, bt, qp, **kw)
            row = {"bf16_pool": device_ms(torch, lambda: fa.paged_attention_prefill(
                q, kb, vb, bt, qp, **kw), args.calls)}
            saved = fa.paged_prefill_body
            fa.paged_prefill_body = lambda *a: "mma"
            try:
                row["mma_sync"] = device_ms(torch, one_byte, args.calls)
            finally:
                fa.paged_prefill_body = saved
            for name, path in libs.items():
                if not name.startswith(f"D{D}_"):
                    continue
                lib = ctypes.CDLL(str(path))
                lib.nxdi_paged_prefill.argtypes = _build.SIGNATURES["nxdi_paged_prefill"]
                lib.nxdi_paged_prefill.restype = ctypes.c_int
                _build._lib = lib
                got = one_byte()
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise RuntimeError(f"{name} {shape}: differs from the bf16 body's bits")
                row[name] = device_ms(torch, one_byte, args.calls)
            _build._lib = None
            result[f"D{D}_{shape}"] = row
            print(f"D={D} {shape} (B {B}, {Sq} after {start}; {card}): "
                  + "; ".join(f"{key} {val:.4f}" for key, val in row.items()) + " (ms)",
                  flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
