#!/usr/bin/env python3
"""Time the port's bf16 QKV and MLP GEMMs on one card under the plan
``nxdi_tpu_torch.ops.kernels.fused_proj.gemm_plan`` picks and under others
the kernels can run, beside one PyTorch call of the same function.

    python3 scripts/bench_gemm_plans.py [--ms 8,520] [--plans default,wide]
                                        [--alt NAME[@dual|@plain]:FIELD=VALUE,...]
                                        [--grid] [--out chiprun_out/gemm_plans.json]

Products at Llama-3.2-1B's widths: QKV (2048 -> 3072) and the silu MLP
(2048 -> 8192 -> 2048). Every plan but the default is the default plan of
each GEMM with some fields replaced (``dataclasses.replace``): ``stream``
(the weight-streaming body, 64-row tiles), ``narrow`` and ``wide`` (the
two-warpgroup wgmma body with 128- or 256-column B tiles; the MLP's dual
gate/up tiles give half as many output columns), and ``split-x2`` (twice the
default's K slices: for the streaming body, two blocks per SM instead of
one). ``--alt`` adds a plan the same way: ``bn`` is the B tile's width, an
integer value replaces the field, ``2x`` multiplies it; the tiles, K slices
and workspace follow. ``@dual`` or ``@plain`` applies it only to the MLP's
gate/up GEMM or to the plain GEMMs (QKV, the MLP's down product); a plan
that changes no GEMM of a product is not timed for it. ``--grid`` adds
every B width (128, 256) and split count (1, 2, 3, 4, 6, 8) of the wgmma
body for each of the two, and then prints, for each product and M, the
default beside the fastest plan. For each M and plan: the max error against the plain
version (held to chip_smoke.py's limit), a bitwise-equal second call, and
the device time of each of 11 calls with the L2 cache flushed before it
(torch.profiler; median, min, max). For a QKV plan on the wgmma body
without a K split it also prints the share of the per-SM peak (989 TFLOP/s
over the SMs) that its waves of tiles reached: the rates ``gemm_plan``'s
model of that body uses. Prints one line per point and the card's name and
power limit, and writes the rows as JSON to ``--out``. Needs a CUDA card;
it imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MS = (2, 8, 64, 128, 256, 512, 520, 1032)
CALLS = 11
PEAK_BF16 = 989e12
PLANS = {
    "default": {},
    "stream": {"body": "stream", "bm": 64, "bn": 128},
    "narrow": {"body": "wgmma", "bm": 128, "bn": 128},
    "wide": {"body": "wgmma", "bm": 128, "bn": 256},
    "split-x2": {"splits": "2x"},
}
GRID = [f"{name}-w{w}-s{s}@{gemm}:body=wgmma,bm=128,bn={w},splits={s}"
        for gemm, name in (("dual", "gu"), ("plain", "p")) for w in (128, 256)
        for s in (1, 2, 3, 4, 6, 8)]


def parse_alt(text):
    """``NAME[@dual|@plain]:FIELD=VALUE,...`` -> (name, (gemm or None,
    {field: value}))."""
    name, _, spec = text.partition(":")
    name, _, gemm = name.partition("@")
    fields = {}
    for item in filter(None, spec.split(",")):
        field, _, value = item.partition("=")
        fields[field] = value
    return name, (gemm or None, fields)


def derive(plan, M, N, K, dual, fields):
    """``plan`` (the default for this GEMM) with ``fields`` replaced, its
    tiles, K slices and workspace made to follow."""
    planes = 2 if dual else 1
    kw = {}
    for field, value in fields.items():
        if field == "body":
            kw[field] = value
        elif isinstance(value, str) and value.endswith("x"):
            kw[field] = getattr(plan, field) * int(value[:-1])
        else:
            kw[field] = int(value) // (planes if field == "bn" else 1)
    p = dataclasses.replace(plan, **kw)
    k_tiles = -(-K // p.bk)
    slice_tiles = -(-k_tiles // min(p.splits, k_tiles))
    splits = -(-k_tiles // slice_tiles)
    return dataclasses.replace(
        p, m_tiles=-(-M // p.bm), n_tiles=-(-N // p.bn), splits=splits,
        k_slice=slice_tiles * p.bk, workspace_bytes=splits * M * N * 4 * planes if splits > 1 else 0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ms", default=",".join(map(str, MS)), help="rows, comma-separated")
    ap.add_argument("--plans", default=",".join(PLANS), help="plans, comma-separated")
    ap.add_argument("--alt", action="append", default=[], help="NAME:FIELD=VALUE,...")
    ap.add_argument("--grid", action="store_true", help="every wgmma width and split")
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out", "gemm_plans.json"))
    args = ap.parse_args(argv)
    plans = {name: (None, PLANS[name]) for name in args.plans.split(",") if name}
    plans.update(parse_alt(a) for a in args.alt + (GRID if args.grid else []))
    if not os.path.isdir(os.path.join(REPO, "nxdi_tpu_torch")):
        print("bench_gemm_plans: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("bench_gemm_plans: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from nxdi_tpu_torch.ops.kernels import fused_proj as fp

    card = cs.card_line()
    dev = torch.device("cuda")
    sms = fp._num_sms(0)
    gen = torch.Generator(device=dev).manual_seed(2468)
    scratch = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device=dev)

    def flush():
        scratch.zero_()

    def randn(shape, std=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(torch.bfloat16)

    H, T, I = 2048, 3072, 8192
    w = randn((H, T), 0.02)
    g, u, d = randn((H, I), 0.02), randn((H, I), 0.02), randn((I, H), 0.02)
    default_plan = fp._plan
    rows = []
    for M in (int(m) for m in args.ms.split(",")):
        x = randn((M, H))
        for prod in ("qkv", "mlp"):
            if prod == "qkv":
                call, plain = (lambda: fp.qkv_matmul(x, w)), (lambda: fp.qkv_matmul_plain(x, w))
                library = lambda: torch.matmul(x, w)  # noqa: E731
            else:
                call = lambda: fp.fused_mlp(x, g, u, d)  # noqa: E731
                plain = lambda: fp.fused_mlp_plain(x, g, u, d)  # noqa: E731
                library = lambda: (F.silu(x @ g) * (x @ u)) @ d  # noqa: E731
            want = plain()
            lib, _, _ = cs.traced_times(torch, library, CALLS, flush)
            lib_ms = cs.spread(lib)[0]
            for name, (gemm, fields) in plans.items():
                used = []

                def forced(M_, N_, K_, dual, x_, gemm=gemm, fields=fields, used=used):
                    plan = default_plan(M_, N_, K_, dual, x_)
                    if gemm is None or gemm == ("dual" if dual else "plain"):
                        plan = derive(plan, M_, N_, K_, dual, fields)
                    used.append((plan, plan == default_plan(M_, N_, K_, dual, x_)))
                    return plan

                fp._plan = forced
                try:
                    got = call()
                    if name != "default" and all(same for _, same in used):
                        continue
                    used = [p for p, _ in used]
                    err = (got.float() - want.float()).abs().max().item()
                    assert err <= cs.NEW_TOL[(prod, "bfloat16")], f"{prod} M={M} {name}: err {err}"
                    assert torch.equal(call(), got), f"{prod} M={M} {name}: a second call differs"
                    times, names, _ = cs.traced_times(torch, call, CALLS, flush, kernel="gemm")
                finally:
                    fp._plan = default_plan
                ms, lo, hi = cs.spread(times)
                row = dict(product=prod, M=M, plan=name, ms=ms, ms_min=lo, ms_max=hi,
                           library_ms=lib_ms, max_abs_err=err, bodies=cs.gemm_bodies(names),
                           plans=[dataclasses.asdict(p) for p in used[:2]])
                line = (f"{prod} M={M:5d} {name:12s} {ms:.4f} ms (min {lo:.4f} max {hi:.4f}) "
                        f"library {lib_ms:.4f} ratio {ms / lib_ms:.2f}x; "
                        + " + ".join(cs.gemm_bodies(names)))
                p = used[0]
                if prod == "qkv" and p.body == "wgmma" and p.splits == 1:
                    waves = math.ceil(p.m_tiles * p.n_tiles / sms)
                    share = 2 * p.bm * p.bn * H * waves / (ms * 1e-3) / (PEAK_BF16 / sms)
                    row["sm_peak_share"] = share
                    line += f"; {p.m_tiles * p.n_tiles} tiles of {p.bm} x {p.bn} in {waves} " \
                            f"wave(s): {100 * share:.1f} % of the per-SM peak"
                rows.append(row)
                print(line, flush=True)
    if args.grid:
        for prod in ("qkv", "mlp"):
            for M in sorted({r["M"] for r in rows}):
                pts = [r for r in rows if r["product"] == prod and r["M"] == M]
                best = min(pts, key=lambda r: r["ms"])
                base = next(r for r in pts if r["plan"] == "default")
                print(f"{prod} M={M:5d}: default {base['ms']:.4f} ms, fastest {best['plan']} "
                      f"{best['ms']:.4f} ms (the default {100 * (base['ms'] / best['ms'] - 1):.1f}"
                      " % slower)", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "calls": CALLS, "rows": rows}, f, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
