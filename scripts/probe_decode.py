#!/usr/bin/env python3
"""Where the split decode kernel spends its time: the paged and fused decode
modes timed over chunk lengths and with parts of the kernel removed.

    python3 scripts/probe_decode.py [--calls 21]

Needs the card and nvcc. Each variant is a copy of ``nxdi_tpu_torch/csrc``
whose ``decode_kernel.cuh`` has one part cut out, built with the kernels'
own flags into ``build/probe_decode/<variant>/`` (``paged_decode.cu`` and
``flash_decode.cu``) and called through the port's wrappers at the
``chip_smoke.py`` phase 3 / 3b points (bf16, B 8, H 32, KV 8, D 64, 2048
positions a row; paged: block 128, rows at 0 ... 2000 with a hole; fused:
rows at 0 and 1061 ... 1283):

- ``kernel``: the kernel as it is (its max error against the plain version
  is printed; the other variants compute wrong numbers on purpose);
- ``loads_only``: each tile's copies and waits, no Q.K, softmax or P.V;
- ``no_pv``: no P.V (Q.K and the softmax stay).

The cuts are made in the tensor-core body, which bf16 at D 64 runs.

Each (variant, chunk length) is timed three ways: CUDA events over
``--calls`` back-to-back calls (L2 warm), and the profiler's device time of
each kernel (split, combine) per call after the L2 is evicted by writing
256 MB (as ``chip_smoke.py`` does: the evicted lines are dirty) or by
reading them (clean). Chunk lengths: 128 ... 1024 and one chunk a row
(``flash_attention.decode_chunk`` replaced). The last line is one JSON
object with every time and the card's name and power limit.
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

TILE_START = "      const unsigned vis = __ballot_sync(0xffffffffu, lane_visible(t));"
PV_START = "      // O += P V: P (rounded to bf16"
TILE_END = "      __syncwarp();  // the next tile's copies overwrite this stage"


def _cut(src: str, start: str, end: str) -> str:
    """``src`` without [start, the first ``end`` after it)."""
    if start not in src or end not in src[src.index(start):]:
        raise RuntimeError("decode_kernel.cuh no longer holds the cut's markers: update the script")
    i = src.index(start)
    return src[:i] + src[src.index(end, i):]


VARIANTS = {
    "kernel": lambda s: s,
    "loads_only": lambda s: _cut(s, TILE_START, TILE_END),
    "no_pv": lambda s: _cut(s, PV_START, TILE_END),
}
ENTRIES = {"paged": ("paged_decode.cu", "nxdi_paged_decode"),
           "fused": ("flash_decode.cu", "nxdi_flash_decode_fused")}
CHUNKS = (128, 256, 384, 512, 1024, 1 << 30)


def build(out_dir: Path):
    from nxdi_tpu_torch.ops.kernels import _build

    src_dir = REPO / "nxdi_tpu_torch" / "csrc"
    procs = {}
    for name, edit in VARIANTS.items():
        d = out_dir / name
        if d.exists():
            shutil.rmtree(d)
        shutil.copytree(src_dir, d)
        header = d / "decode_kernel.cuh"
        header.write_text(edit(header.read_text()))
        cmd = [_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
               "-shared", "-I", str(d), "-o", str(d / "lib.so")] + [
                   str(d / src) for src, _ in ENTRIES.values()]
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


def kernel_ms(torch, fn, calls, evict):
    """Median device ms per call of the split and the combine kernel, each
    call after ``evict()``; calls the profiler traced short are dropped."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    split, comb = [], []
    for _ in range(2 * calls):
        evict()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        s = [k for k in prof.key_averages() if "decode_split_kernel" in k.key]
        c = [k for k in prof.key_averages() if "decode_combine_kernel" in k.key]
        if not s:
            continue
        split.append(sum(k.self_device_time_total for k in s) / 1e3)
        comb.append(sum(k.self_device_time_total for k in c) / 1e3)
        if len(split) == calls:
            break

    def med(x):
        return sorted(x)[len(x) // 2] if x else 0.0

    return med(split), med(comb)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--calls", type=int, default=21)
    args = ap.parse_args()
    import torch

    from nxdi_tpu_torch.ops.kernels import _build
    from nxdi_tpu_torch.ops.kernels import flash_attention as fa

    if not torch.cuda.is_available():
        print("probe_decode: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          stdout=subprocess.PIPE, text=True, check=True).stdout.strip()
    libs = build(REPO / "build" / "probe_decode")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    scratch = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device=dev)
    evictions = {"dirty": lambda: scratch.zero_(), "clean": lambda: scratch.sum(dtype=torch.int32)}
    B, H, KV, D, bs, nblk, NB, S = 8, 32, 8, 64, 128, 136, 16, 2048

    def bf(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    # paged: the phase 3b point
    qpos = torch.linspace(0, 2000, B, device=dev).long()
    perm = torch.randperm(nblk, generator=torch.Generator().manual_seed(0)).tolist()
    bt = torch.full((B, NB), -1, dtype=torch.int32)
    nxt = 0
    for b in range(B):
        n = int(qpos[b]) // bs + 1
        bt[b, :n] = torch.tensor(perm[nxt:nxt + n], dtype=torch.int32)
        nxt += n
    bt[3, 2] = -1
    bt = bt.to(dev)
    kc, vc, q = bf(nblk * bs, KV, D), bf(nblk * bs, KV, D), bf(B, 1, H, D).transpose(1, 2)
    qp = qpos[:, None].to(torch.int32)
    # fused: the phase 3 point (the stacked entry's layer view)
    kcache, vcache = bf(B, KV, S, D), bf(B, KV, S, D)
    kn, vn = bf(B, 1, KV, D).transpose(1, 2), bf(B, 1, KV, D).transpose(1, 2)
    fpos = torch.tensor([[0]] + [[1024 + 37 * b] for b in range(1, B)], device=dev,
                        dtype=torch.int32)
    kvpos = torch.arange(S, device=dev)[None].expand(B, S)
    calls = {
        "paged": (lambda: fa.paged_attention_decode(q, kc, vc, bt, qp, block_size=bs),
                  lambda: fa.paged_attention_decode_plain(q, kc, vc, bt, qp, block_size=bs)),
        "fused": (lambda: fa.flash_attention_decode_fused(q, kcache, vcache, kn, vn, fpos, kvpos),
                  lambda: fa.flash_attention_decode_fused_plain(q, kcache, vcache, kn, vn, fpos)),
    }
    result = {"card": card, "calls": args.calls, "default_chunk": fa.decode_chunk(B, KV, S, 132)}
    saved = fa.decode_chunk
    try:
        for name, path in libs.items():
            lib = ctypes.CDLL(str(path))
            for _, sym in ENTRIES.values():
                getattr(lib, sym).argtypes = _build.SIGNATURES[sym]
                getattr(lib, sym).restype = ctypes.c_int
            _build._lib = lib
            for mode, (call, plain) in calls.items():
                for chunk in CHUNKS:
                    fa.decode_chunk = lambda *a, c=chunk: c
                    row = {}
                    if name == "kernel":
                        got = call()
                        torch.cuda.synchronize()
                        row["max_abs_err"] = (got.float() - plain().float()).abs().max().item()
                    row["events_ms"] = events_ms(torch, call, args.calls)
                    for ev, evict in evictions.items():
                        row[f"split_{ev}_ms"], row[f"combine_{ev}_ms"] = kernel_ms(
                            torch, call, args.calls, evict)
                    key = f"{name}/{mode}/{'one' if chunk > S else chunk}"
                    result[key] = row
                    print(f"{key} ({card}): " + "; ".join(
                        f"{k} {v:.4f}" if "err" not in k else f"err {v:.3g}"
                        for k, v in row.items()), flush=True)
    finally:
        fa.decode_chunk = saved
        _build._lib = None
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
