#!/usr/bin/env python3
"""How the one-byte paged decode and the ragged split kernel split a warp's
shared memory between raw one-byte tiles in flight (what cp.async lands)
and bf16 tiles (what the tensor cores read): both timed at each split.

    python3 scripts/stages_decode_1b.py [--calls 21] [--csrc DIR] [--out DIR]

Needs the card and nvcc. Each variant is a copy of ``nxdi_tpu_torch/csrc``
whose ``decode_kernel.cuh`` sets ``kDecRaw`` / ``kDecCvt`` (raw tiles,
bf16 tiles a warp, at head dims up to 64 and up to 128) and whose
``ragged_split.cuh`` sets ``kSplitRaw`` / ``kSplitCvt`` to the same, built
with the kernels' own flags into
``build/stages_decode_1b/<variant>/`` (``paged_decode.cu``,
``paged_decode_1b.cu``, ``ragged_paged.cu``, ``ragged_paged_1b.cu``) and
called through the port's wrappers (bf16 q) over a float8_e4m3fn pool
(block 128, H 32, KV 8, k_scale = v_scale = 0.5), at D 64 and D 128:

- ``3e``: the paged decode at phase 3e's point, 8 rows at positions
  0 ... 2000 with a hole (6 chunks of 384: about 3 tiles a warp);
- ``long``: the paged decode, 8 rows at positions 7000 ... 8000 (chunks of
  1920: about 15 tiles a warp, the ring's depth at work);
- ``ragged8``: the ragged decode-only bucket 8 (slots 0-7 at positions
  230 ... 1000: one tile a warp).

A warp's split must leave the block within the 227 KB it may hold (4 warps;
Q as f32 for 16 q heads). Beside the variants: the same calls over a bf16
pool (rows 7 and 8), from the repository's own build. ``--csrc DIR``
builds the variants from another copy of the sources. Times are the
device time of the decode or ragged kernels (split and combine, ``torch.profiler``)
over ``--calls`` calls, each after the L2 is evicted by writing 256 MB, per
call (the host's enqueue is not timed); every variant's paged decode is
checked equal, bit for bit, to row 7's kernel on the up-cast pool, and its
ragged output equal to the plain version's within 8e-3. The last line
is one JSON object with every time and the card's name and power limit.
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

# ((raw, bf16) tiles a warp at D <= 64, the same at D <= 128); the first is
# the kernels' own
VARIANTS = [((1, 1), (1, 1)), ((2, 1), (2, 1)), ((3, 1), (1, 2)), ((2, 2), (2, 2)),
            ((4, 1), (3, 1))]
CONSTS = {"decode_kernel.cuh": "kDec", "ragged_split.cuh": "kSplit"}
SOURCES = ("paged_decode.cu", "paged_decode_1b.cu", "ragged_paged.cu", "ragged_paged_1b.cu",
           "ragged_split_1b.cu")


def _name(v):
    return "_".join(f"r{r}c{c}" for r, c in v)


def _set(text, prefix, v):
    """``text`` with the prefix's Raw / Cvt constants set to ``v``."""
    (r64, c64), (r128, c128) = v
    for name, a, b in (("Raw", r64, r128), ("Cvt", c64, c128)):
        pat = re.compile(rf"constexpr int {prefix}{name}\[2\] = \{{\d+, \d+\}};")
        if not pat.search(text):
            raise RuntimeError(f"{prefix}{name} is no longer set as this script expects: "
                               "update it")
        text = pat.sub(f"constexpr int {prefix}{name}[2] = {{{a}, {b}}};", text)
    return text


def build(out_dir: Path, src_dir: Path):
    from nxdi_tpu_torch.ops.kernels import _build

    flags = [*_build.ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
    procs = []
    for v in VARIANTS:
        d = out_dir / _name(v)
        if d.exists():
            shutil.rmtree(d)
        shutil.copytree(src_dir, d)
        for header, prefix in CONSTS.items():
            (d / header).write_text(_set((d / header).read_text(), prefix, v))
        for src in SOURCES:
            cmd = [_build._nvcc(), *flags, "-I", str(d), "-c", str(d / src), "-o",
                   str(d / (src + ".o"))]
            procs.append((_name(v), subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                     stderr=subprocess.STDOUT)))
    for name, proc in procs:
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode:
            raise RuntimeError(f"{name}: build failed\n{log[-4000:]}")
    libs = {}
    for v in VARIANTS:
        d = out_dir / _name(v)
        subprocess.run([_build._nvcc(), *_build.ARCH_FLAGS, "-shared", "-o", str(d / "lib.so")]
                       + [str(d / (src + ".o")) for src in SOURCES], check=True)
        libs[_name(v)] = d / "lib.so"
    return libs


def _load(ctypes, _build, path):
    lib = ctypes.CDLL(str(path))
    for sym in ("nxdi_paged_decode", "nxdi_ragged_paged"):
        getattr(lib, sym).argtypes = _build.SIGNATURES[sym]
        getattr(lib, sym).restype = ctypes.c_int
    return lib


def device_ms(torch, fn, calls, flush, kind="decode"):
    """Device ms per call of the ``kind`` (decode or ragged) split and
    combine kernels ``fn`` launches, each call after ``flush()``; a trace
    short of split launches is taken again."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(4):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                flush()
                fn()
            torch.cuda.synchronize()
        ks = [k for k in prof.key_averages()
              if f"{kind}_split_kernel" in k.key or f"{kind}_combine_kernel" in k.key]
        if sum(k.count for k in ks if f"{kind}_split_kernel" in k.key) == calls:
            return sum(k.self_device_time_total for k in ks) / 1e3 / calls
    raise RuntimeError(f"torch.profiler traced every try short of {kind} kernels")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--calls", type=int, default=21)
    ap.add_argument("--csrc", type=Path, default=REPO / "nxdi_tpu_torch" / "csrc")
    ap.add_argument("--out", type=Path, default=REPO / "build" / "stages_decode_1b")
    args = ap.parse_args()
    import torch

    from nxdi_tpu_torch.ops.kernels import _build
    from nxdi_tpu_torch.ops.kernels import flash_attention as fa
    from nxdi_tpu_torch.ops.kernels import ragged_paged_attention as rpa

    if not torch.cuda.is_available():
        print("stages_decode_1b: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          stdout=subprocess.PIPE, text=True, check=True).stdout.strip()
    libs = build(args.out, args.csrc.resolve())
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    scratch = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device=dev)

    def flush():
        scratch.zero_()

    B, H, KV, bs, sc = 8, 32, 8, 128, 0.5
    result = {"card": card, "calls": args.calls, "csrc": str(args.csrc),
              "variants": [_name(v) for v in VARIANTS]}

    def table(rows_pos, NB):
        """Each row's blocks drawn from a permutation of a pool just large
        enough; returns the (rows, NB) table on the card and the pool's blocks."""
        nblk = int(sum(int(p) // bs + 1 for p in rows_pos))
        perm = torch.randperm(nblk, generator=torch.Generator().manual_seed(0)).tolist()
        bt = torch.full((len(rows_pos), NB), -1, dtype=torch.int32)
        nxt = 0
        for b, p in enumerate(rows_pos):
            n = int(p) // bs + 1
            bt[b, :n] = torch.tensor(perm[nxt:nxt + n], dtype=torch.int32)
            nxt += n
        return bt, nblk

    points = {"3e": (0, 2000, 16), "long": (7000, 8000, 64), "ragged8": (230, 1000, 16)}
    for D in (64, 128):
        for shape, (first, last, NB) in points.items():
            ragged = shape == "ragged8"
            qpos = torch.linspace(first, last, B).long()
            bt, nblk = table(qpos.tolist(), NB)
            if not ragged:
                bt[3, 2] = -1
            bt = bt.to(dev)
            kb = torch.randn((nblk * bs, KV, D), generator=gen, device=dev).to(torch.bfloat16)
            vb = torch.randn((nblk * bs, KV, D), generator=gen, device=dev).to(torch.bfloat16)
            k8, v8 = (x.float().div(sc).to(torch.float8_e4m3fn) for x in (kb, vb))
            k8b, v8b = k8.to(torch.bfloat16), v8.to(torch.bfloat16)
            kw = dict(block_size=bs, k_scale=sc, v_scale=sc)
            if ragged:  # one decode token a slot, packed
                q = torch.randn((1, B, H, D), generator=gen, device=dev).to(torch.bfloat16)
                q = q.transpose(1, 2)
                rid = torch.arange(B, dtype=torch.int32)
                qp = qpos.to(torch.int32)
                plan = rpa.ragged_plan(rid.numpy(), qp.numpy(), B, NB * bs, KV, wgmma=True)
                plan_bf16 = rpa.ragged_plan(rid.numpy(), qp.numpy(), B, NB * bs, KV)
                rid, qp, plan, plan_bf16 = rid.to(dev), qp.to(dev), plan.to(dev), plan_bf16.to(dev)

                def one_byte():
                    return rpa.ragged_paged_attention(q, k8, v8, bt, rid, qp, plan=plan, **kw)

                def bf16_pool():
                    return rpa.ragged_paged_attention(q, kb, vb, bt, rid, qp, plan=plan_bf16,
                                                      block_size=bs)

                want = rpa.ragged_paged_attention_plain(q, k8, v8, bt, rid, qp, **kw)
            else:
                q = torch.randn((B, 1, H, D), generator=gen, device=dev).to(torch.bfloat16)
                q = q.transpose(1, 2)
                qp = qpos[:, None].to(device=dev, dtype=torch.int32)

                def one_byte():
                    return fa.paged_attention_decode(q, k8, v8, bt, qp, **kw)

                def bf16_pool():
                    return fa.paged_attention_decode(q, kb, vb, bt, qp, block_size=bs)

                _build._lib = None  # the repository's own build
                want = fa.paged_attention_decode(q, k8b, v8b, bt, qp, **kw)
            kind = "ragged" if ragged else "decode"
            _build._lib = None
            row = {"bf16_pool": device_ms(torch, bf16_pool, args.calls, flush, kind)}
            for name, path in libs.items():
                _build._lib = _load(ctypes, _build, path)
                got = one_byte()
                torch.cuda.synchronize()
                if ragged:
                    err = (got.float() - want.float()).abs().max().item()
                    if err > 8e-3:
                        raise RuntimeError(f"{name} D{D} {shape}: max err {err} against plain")
                elif not torch.equal(got, want):
                    raise RuntimeError(f"{name} D{D} {shape}: differs from row 7's bits on the "
                                       "up-cast pool")
                row[name] = device_ms(torch, one_byte, args.calls, flush, kind)
            _build._lib = None
            result[f"D{D}_{shape}"] = row
            where = (f"bucket 8 at {first}...{last}" if ragged else
                     f"chunk {fa.decode_chunk(B, KV, NB * bs, fa._sm_count(0))}, "
                     f"positions {first}...{last}")
            print(f"D={D} {shape} (B {B}, {where}; {card}): "
                  + "; ".join(f"{key} {val:.4f}" for key, val in row.items()) + " (ms)",
                  flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
