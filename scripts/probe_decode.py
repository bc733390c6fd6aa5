#!/usr/bin/env python3
"""Where the split decode kernel and the ragged split kernel spend their
time: the paged, fused and window decode modes and the ragged decode-only
bucket timed over chunk lengths, with parts of the tensor-core tile loop
removed, and beside another tree's kernels.

    python3 scripts/probe_decode.py [--calls 21] [--store float8_e4m3fn]
        [--csrc DIR] [--chunks 128,384,one|default]

Needs the card and nvcc. Each variant is a copy of ``nxdi_tpu_torch/csrc``
whose ``mma_tiles.cuh`` (the tile loop the decode and ragged split kernels
share) has one part cut out, built with the kernels' own flags into
``build/probe_decode/<variant>/`` and called through the port's wrappers at
the ``chip_smoke.py`` phase 3 / 3b / 3c points (bf16, B 8, H 32, KV 8, D 64,
2048 positions a row; paged: block 128, rows at 0 ... 2000 with a hole;
window: a contiguous window, rows at the same positions; fused: rows at 0
and 1061 ... 1283; ragged, block 128: bucket 8, slots 0-7 at positions
230 ... 1000, and the packed 1032 stream, a 512-token chunk after 384
cached beside 7 decode tokens):

- ``kernel``: the kernels as they are (the max error against the plain
  version is printed; the other variants compute wrong numbers on purpose);
- ``loads_only``: each tile's copies, waits and (one-byte pool) K/V
  conversion, no Q.K, softmax or P.V;
- ``no_pv``: no P.V (Q.K and the softmax stay).

``--store`` adds the paged decode (``paged_1b``) and the ragged streams
(``ragged8_1b``, ``ragged1032_1b``) over a one-byte pool (float8_e4m3fn,
float8_e5m2 or int8; phase 3e's scales, 0.5 for fp8 and 0.05 for int8);
the paged decode and the bucket (split items only) are also checked equal,
bit for bit, to the bf16 pool's kernels on the pool up-cast to bf16. ``--csrc DIR`` builds the kernels as they are from another
copy of the sources too (``earlier``: for example a ``git archive`` of the
parent commit's tree) and times the two in one process, in turns: earlier,
kernel, the cut variants, kernel, earlier.

Each (variant, mode, chunk length) is timed three ways: CUDA events over
``--calls`` back-to-back calls (L2 warm; the host's launch rate, not device
time), and the profiler's device time of each kernel (split, combine) per
call after the L2 is evicted by writing 256 MB (as ``chip_smoke.py`` does:
the evicted lines are dirty) or by reading them (clean), with the median,
min and max of the call's total. Chunk lengths (decode modes; the ragged
plan picks its own): ``--chunks``, by default 128 ... 1024 and one chunk a
row (``flash_attention.decode_chunk`` replaced); ``default`` keeps the
port's own. The last line is one JSON object with every time and the
card's name and power limit.
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

TILE_START = "      const int j = j0 + lane;\n      const unsigned vis"
PV_START = "      // O += P V: P (rounded to bf16"
TILE_END = "      __syncwarp();  // the next tile's copies (bf16) or conversion"


def _cut(src: str, start: str, end: str) -> str:
    """``src`` without [start, the first ``end`` after it)."""
    if start not in src or end not in src[src.index(start):]:
        raise RuntimeError("mma_tiles.cuh no longer holds the cut's markers: update the script")
    i = src.index(start)
    return src[:i] + src[src.index(end, i):]


CUTS = {
    "loads_only": lambda s: _cut(s, TILE_START, TILE_END),
    "no_pv": lambda s: _cut(s, PV_START, TILE_END),
}

DECODE_SOURCES = ("paged_decode.cu", "paged_decode_1b.cu", "flash_decode.cu",
                  "window_decode.cu")
RAGGED_SOURCES = ("ragged_paged.cu", "ragged_paged_1b.cu", "ragged_split_1b.cu")
SYMBOLS = ("nxdi_paged_decode", "nxdi_flash_decode_fused", "nxdi_flash_decode_window",
           "nxdi_ragged_paged")
CHUNKS = (128, 256, 384, 512, 1024, 1 << 30)
SCALES = {"float8_e4m3fn": 0.5, "float8_e5m2": 0.5, "int8": 0.05}


def build(out_dir: Path, trees: dict):
    """One library per variant: ``trees`` maps a variant to (source dir,
    {header: edit}). Every source compiles in parallel."""
    from nxdi_tpu_torch.ops.kernels import _build

    flags = [*_build.ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
    procs = []
    for name, (src_dir, edits) in trees.items():
        d = out_dir / name
        if d.exists():
            shutil.rmtree(d)
        shutil.copytree(src_dir, d)
        for header, edit in edits.items():
            (d / header).write_text(edit((d / header).read_text()))
        for src in DECODE_SOURCES + RAGGED_SOURCES:
            cmd = [_build._nvcc(), *flags, "-I", str(d), "-c", str(d / src), "-o",
                   str(d / (src + ".o"))]
            procs.append((name, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT)))
    for name, proc in procs:
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode:
            raise RuntimeError(f"{name}: build failed\n{log[-4000:]}")
    libs = {}
    for name in trees:
        d = out_dir / name
        objs = [str(d / (src + ".o")) for src in DECODE_SOURCES + RAGGED_SOURCES]
        subprocess.run([_build._nvcc(), *_build.ARCH_FLAGS, "-shared", "-o", str(d / "lib.so")]
                       + objs, check=True)
        libs[name] = d / "lib.so"
    return libs


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


def kernel_ms(torch, fn, calls, evict, names):
    """Device ms per call of the split and the combine kernel (``names``),
    each call after ``evict()``: the medians of each, the median, min and
    max of their sum, and the median of every kernel the call ran (the
    ragged stream's direct tiles too); calls the profiler traced short are
    dropped."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    split, comb, every, with_comb = [], [], [], False
    for _ in range(2 * calls):
        evict()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        s = [k for k in prof.key_averages() if names[0] in k.key]
        c = [k for k in prof.key_averages() if names[1] in k.key]
        with_comb = with_comb or bool(c)
        if not s or (with_comb and not c):
            continue
        split.append(sum(k.self_device_time_total for k in s) / 1e3)
        comb.append(sum(k.self_device_time_total for k in c) / 1e3)
        every.append(sum(k.self_device_time_total for k in prof.key_averages()) / 1e3)
        if len(split) == calls:
            break

    def med(x):
        return sorted(x)[len(x) // 2] if x else 0.0

    total = [a + b for a, b in zip(split, comb)]
    return (med(split), med(comb), med(total), min(total, default=0.0), max(total, default=0.0),
            med(every))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--calls", type=int, default=21)
    ap.add_argument("--store", choices=sorted(SCALES), default=None,
                    help="also time the paged decode and the ragged bucket over this store")
    ap.add_argument("--csrc", type=Path, default=None,
                    help="another copy of nxdi_tpu_torch/csrc, timed as 'earlier'")
    ap.add_argument("--chunks", default=None,
                    help="decode chunk lengths: comma-separated, 'one', or 'default'")
    args = ap.parse_args()
    import torch

    from nxdi_tpu_torch.ops.kernels import _build
    from nxdi_tpu_torch.ops.kernels import flash_attention as fa
    from nxdi_tpu_torch.ops.kernels import ragged_paged_attention as rpa

    if not torch.cuda.is_available():
        print("probe_decode: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          stdout=subprocess.PIPE, text=True, check=True).stdout.strip()
    src_dir = REPO / "nxdi_tpu_torch" / "csrc"
    trees = {"kernel": (src_dir, {}),
             **{n: (src_dir, {"mma_tiles.cuh": e}) for n, e in CUTS.items()}}
    order = ["kernel", *CUTS]
    if args.csrc is not None:
        trees["earlier"] = (args.csrc.resolve(), {})
        order = ["earlier", "kernel", *CUTS, "kernel", "earlier"]
    libs = build(REPO / "build" / "probe_decode", trees)
    if args.chunks is None:
        chunks = CHUNKS
    elif args.chunks == "default":
        chunks = (None,)
    else:
        chunks = tuple(1 << 30 if c == "one" else int(c) for c in args.chunks.split(","))

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
    # window: the phase 3b point (a contiguous window, the paged rows' positions)
    kw_, vw_ = (bf(B, S, KV, D).transpose(1, 2) for _ in range(2))
    wpos = torch.arange(S, device=dev, dtype=torch.int32)[None].expand(B, S)
    # ragged: phase 3c's decode-only bucket 8 over the paged pool
    R = 8
    rbt = torch.full((R, NB), -1, dtype=torch.int32)
    rpos = torch.tensor([230 + 110 * s for s in range(R)], dtype=torch.int32)
    nxt = 0
    for s in range(R):
        n = int(rpos[s]) // bs + 1
        rbt[s, :n] = torch.tensor(perm[nxt:nxt + n], dtype=torch.int32)
        nxt += n
    rbt = rbt.to(dev)
    rid = torch.arange(R, dtype=torch.int32, device=dev)
    rqp = rpos.to(dev)
    qr = bf(1, R, H, D).transpose(1, 2)
    rplan = rpa.ragged_plan(rid.cpu().numpy(), rpos.numpy(), R, NB * bs, KV).to(dev)
    # ragged: phase 3c's packed 1032 stream (slot 5's 512-token chunk after 384
    # cached, then decode tokens of slots 3, 0, 7, 1, 6, 2, 4 at 200 ... 2000)
    T2, dec = 1032, list(zip([3, 0, 7, 1, 6, 2, 4], [200 + 300 * i for i in range(7)]))
    rid2 = torch.full((T2,), -1, dtype=torch.int32)
    qp2 = torch.zeros((T2,), dtype=torch.int32)
    rid2[:512], qp2[:512] = 5, torch.arange(384, 896, dtype=torch.int32)
    rid2[512:519] = torch.tensor([s_ for s_, _ in dec], dtype=torch.int32)
    qp2[512:519] = torch.tensor([p for _, p in dec], dtype=torch.int32)
    perm2 = torch.randperm(nblk, generator=torch.Generator().manual_seed(1)).tolist()
    bt2 = torch.full((R, NB), -1, dtype=torch.int32)
    nxt = 0
    for slot, last in [(5, 895)] + dec:
        n = last // bs + 1
        bt2[slot, :n] = torch.tensor(perm2[nxt:nxt + n], dtype=torch.int32)
        nxt += n
    bt2 = bt2.to(dev)
    q2 = bf(1, T2, H, D).transpose(1, 2)
    plan2 = rpa.ragged_plan(rid2.numpy(), qp2.numpy(), R, NB * bs, KV).to(dev)
    rid2, qp2 = rid2.to(dev), qp2.to(dev)
    calls = {
        "paged": (lambda: fa.paged_attention_decode(q, kc, vc, bt, qp, block_size=bs),
                  lambda: fa.paged_attention_decode_plain(q, kc, vc, bt, qp, block_size=bs)),
        "fused": (lambda: fa.flash_attention_decode_fused(q, kcache, vcache, kn, vn, fpos, kvpos),
                  lambda: fa.flash_attention_decode_fused_plain(q, kcache, vcache, kn, vn, fpos)),
        "window": (lambda: fa.flash_attention_decode(q, kw_, vw_, qp, wpos),
                   lambda: fa.flash_attention_decode_plain(q, kw_, vw_, qp, wpos)),
        "ragged8": (lambda: rpa.ragged_paged_attention(qr, kc, vc, rbt, rid, rqp, block_size=bs,
                                                       plan=rplan),
                    lambda: rpa.ragged_paged_attention_plain(qr, kc, vc, rbt, rid, rqp,
                                                             block_size=bs)),
        "ragged1032": (lambda: rpa.ragged_paged_attention(q2, kc, vc, bt2, rid2, qp2,
                                                          block_size=bs, plan=plan2),
                       lambda: rpa.ragged_paged_attention_plain(q2, kc, vc, bt2, rid2, qp2,
                                                                block_size=bs)),
    }
    upcast = {}
    if args.store is not None:
        sc = SCALES[args.store]
        store = getattr(torch, args.store)

        def to_store(x):
            y = x.float() / sc
            return y.round().clamp(-127, 127).to(store) if store == torch.int8 else y.to(store)

        k1, v1 = to_store(kc), to_store(vc)
        kup, vup = k1.to(torch.bfloat16), v1.to(torch.bfloat16)
        kw = dict(block_size=bs, k_scale=sc, v_scale=sc)
        plan1b = rpa.ragged_plan(rid.cpu().numpy(), rpos.numpy(), R, NB * bs, KV,
                                 wgmma=True).to(dev)
        calls["paged_1b"] = (lambda: fa.paged_attention_decode(q, k1, v1, bt, qp, **kw),
                             lambda: fa.paged_attention_decode_plain(q, k1, v1, bt, qp, **kw))
        calls["ragged8_1b"] = (
            lambda: rpa.ragged_paged_attention(qr, k1, v1, rbt, rid, rqp, plan=plan1b, **kw),
            lambda: rpa.ragged_paged_attention_plain(qr, k1, v1, rbt, rid, rqp, **kw))
        plan2_1b = rpa.ragged_plan(rid2.cpu().numpy(), qp2.cpu().numpy(), R, NB * bs, KV,
                                   wgmma=True).to(dev)
        calls["ragged1032_1b"] = (
            lambda: rpa.ragged_paged_attention(q2, k1, v1, bt2, rid2, qp2, plan=plan2_1b, **kw),
            lambda: rpa.ragged_paged_attention_plain(q2, k1, v1, bt2, rid2, qp2, **kw))
        upcast["paged_1b"] = lambda: fa.paged_attention_decode(q, kup, vup, bt, qp, **kw)
        upcast["ragged8_1b"] = lambda: rpa.ragged_paged_attention(qr, kup, vup, rbt, rid, rqp,
                                                                  plan=rplan, **kw)
    names = {"ragged": ("ragged_split_kernel", "ragged_combine_kernel"),
             "decode": ("decode_split_kernel", "decode_combine_kernel")}
    result = {"card": card, "calls": args.calls, "store": args.store,
              "default_chunk": fa.decode_chunk(B, KV, S, 132), "order": order}
    saved = fa.decode_chunk
    seen = {}
    try:
        for name in order:
            seen[name] = seen.get(name, 0) + 1
            tag = name if order.count(name) == 1 else f"{name}#{seen[name]}"
            lib = ctypes.CDLL(str(libs[name]))
            for sym in SYMBOLS:
                getattr(lib, sym).argtypes = _build.SIGNATURES[sym]
                getattr(lib, sym).restype = ctypes.c_int
            _build._lib = lib
            for mode, (call, plain) in calls.items():
                ragged = mode.startswith("ragged")
                for chunk in ((None,) if ragged else chunks):
                    fa.decode_chunk = saved if chunk is None else (lambda *a, c=chunk: c)
                    row = {}
                    if name in ("kernel", "earlier"):
                        got = call()
                        torch.cuda.synchronize()
                        row["max_abs_err"] = (got.float() - plain().float()).abs().max().item()
                        if mode in upcast:
                            row["bits_equal_upcast"] = float(torch.equal(got, upcast[mode]()))
                    row["events_ms"] = events_ms(torch, call, args.calls)
                    for ev, evict in evictions.items():
                        (row[f"split_{ev}_ms"], row[f"combine_{ev}_ms"], row[f"total_{ev}_ms"],
                         row[f"total_{ev}_min"], row[f"total_{ev}_max"],
                         row[f"all_{ev}_ms"]) = kernel_ms(
                            torch, call, args.calls, evict, names["ragged" if ragged else "decode"])
                    label = ("plan" if ragged else "default" if chunk is None
                             else "one" if chunk > S else chunk)
                    key = f"{tag}/{mode}/{label}"
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
