#!/usr/bin/env python3
"""Per-shape table of two checkouts' K1/K2 and K6 device times from A/B/B/A
runs of ``tools/kernel_times.py --out`` (one JSON a run; K6 from ``--step
train`` runs), with cuDNN's time, the bound and the kernel's plan at each
shape.

    python3 tools/ab_table.py --a A1.json A2.json --b B1.json B2.json
                              [--dtype bfloat16] [--kernels conv3d_wgrad ...]

A is the old checkout, B the new; each column is the mean of that side's
runs (``library_ms`` over all four). The bound is the larger of the bytes
(inputs read once, the output written once, over 3.35 TB/s) and the
operations (over the dtype's tensor-core peak), as ``chip_smoke.py``
computes it; the plan is this checkout's in ``--dtype``: K1/K2's
``convolution.wgmma_plan`` (tile, slab widths, TMA or staged parts, tile
width, splits, fp32's resident weights), K6's ``wgrad_plan`` (box tile,
slab, taps a block, tile n, splits; the routes of A and B by their widths
at an aligned base). Prints a markdown table and the sums; needs no card.
"""

import argparse
import json
import math
import os
import sys

sys.path.insert(0, os.getcwd())


def _rows(path, dtype, name):
    with open(path) as f:
        d = json.load(f)
    return {json.dumps(r["sig"]): r for r in d[dtype].get(name, {}).get("shapes", [])}


def _bound_ms(cs, cv, name, sig, dtype):
    esize = 2 if dtype == "bfloat16" else 4
    rate = cs.BF16_FLOP_PER_S if dtype == "bfloat16" else cs.TF32_FLOP_PER_S / 3
    if name == "conv3d_wgrad":  # A and B read once, the gradient written once
        ashape, bshape, ks, _ = sig
        nbytes = (math.prod(ashape) + math.prod(bshape) + math.prod(ks) * ashape[-1]
                  * bshape[-1]) * esize
        flops = 2.0 * math.prod(ks) * ashape[-1] * bshape[-1] * math.prod(bshape[:4])
        return cs.bound_ms(nbytes, flops, rate)
    transposed = name == "conv3d_transpose"
    shapes = [sig[0]] if transposed else sig[0]
    cout = sig[1][3] if transposed else sig[1][4]
    geom = cv.window_plan(sig[1][:3], sig[2], shapes[0][1:4], transposed)
    out_numel = shapes[0][0] * math.prod(geom["out"]) * cout
    nbytes = (sum(math.prod(s) for s in shapes) + math.prod(sig[1]) + out_numel) * esize \
        + cout * 4
    return cs.bound_ms(nbytes, cs._conv_flops(sig, transposed), rate)


def _wgrad_row(cv, sig, dtype):
    """(A, B, kernel, strides, plan) cells of a K6 shape."""
    import torch

    ashape, bshape, ks, st = sig
    dt = getattr(torch, dtype)
    es = 2 if dtype == "bfloat16" else 4
    tma = tuple((s[-1] * es) % 16 == 0 for s in (ashape, bshape))
    p = cv.wgrad_plan(tuple(ashape), bshape[-1], tuple(ks), tuple(st), dt, tma)
    plan = (f"{'flat' if p['flat'] else 'x'.join(map(str, p['tile']))}, slab {p['width']}, "
            f"{p['tpb']} taps a block, N {p['bn']}, {p['tap_groups'] * p['slabs']}x"
            f"{p['n_tiles']} tiles, {'ping-pong' if p['pingpong'] else 'split'} x "
            f"{p['splits']}, "
            f"{'/'.join('TMA' if t else 'staged' for t in tma)}")
    return ('×'.join(map(str, ashape[1:])), '×'.join(map(str, bshape[1:])),
            '×'.join(map(str, ks)), ','.join(map(str, st)), plan)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--a", nargs="+", required=True)
    ap.add_argument("--b", nargs="+", required=True)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--kernels", nargs="+",
                    default=["conv3d", "conv3d_transpose", "conv3d_wgrad"])
    args = ap.parse_args(argv)
    import torch

    import chip_smoke as cs
    from prostatemr_3d_cad_cspca_tpu_torch.ops import convolution as cv

    for name in args.kernels:
        a = [_rows(p, args.dtype, name) for p in args.a]
        b = [_rows(p, args.dtype, name) for p in args.b]
        if not a[0]:
            continue
        print(f"\n{name} ({args.dtype})\n")
        cols = "A | B" if name == "conv3d_wgrad" else "parts | extent"
        print(f"| n | {cols} | kernel | strides | old µs | new µs | cuDNN µs | bound µs "
              "| plan |")
        print("|---|---|---|---|---|---|---|---|---|---|")
        sums = [0.0, 0.0, 0.0, 0.0]
        for key, r in a[0].items():
            sig = json.loads(key)
            old = sum(x[key]["ms"] for x in a) / len(a)
            new = sum(x[key]["ms"] for x in b) / len(b)
            libs = [x[key].get("library_ms") for x in a + b]
            lib = sum(libs) / len(libs) if None not in libs else float("nan")
            bound, by = _bound_ms(cs, cv, name, sig, args.dtype)
            n = r["count"]
            sums = [sums[0] + n * old, sums[1] + n * new, sums[2] + n * lib, sums[3] + n * bound]
            if name == "conv3d_wgrad":
                ash, bsh, ker, strd, plan = _wgrad_row(cv, sig, args.dtype)
                print(f"| {n} | {ash} | {bsh} | {ker} | {strd} | {old * 1e3:.1f} | "
                      f"{new * 1e3:.1f} | {lib * 1e3:.1f} | {bound * 1e3:.1f} ({by[0]}) | "
                      f"{plan} |")
                continue
            pl = cs._conv_plan(name, sig, getattr(torch, args.dtype))
            if "tma" in pl:
                routes = {"TMA" if t else "staged" for t in pl["tma"]}
                plan = (f"{'flat' if pl['flat'] else 'x'.join(map(str, pl['tile']))}, "
                        f"slab {pl['width']}, {'+'.join(sorted(routes))}, "
                        f"N {pl['bn']}, split {pl['splits']}"
                        + (", phase loop" if pl["phase_loop"] else "")
                        + (", resident" if pl.get("resident") else ""))
            else:
                plan = f"N {pl['bn']}, split {pl['splits']}"
            parts = [s[-1] for s in (sig[0] if name == "conv3d" else [sig[0]])]
            ext = (sig[0][0] if name == "conv3d" else sig[0])[1:4]
            print(f"| {n} | {'+'.join(map(str, parts))} | {'×'.join(map(str, ext))} | "
                  f"{'×'.join(map(str, sig[1][:3]))} {sig[1][3]}→{sig[1][4]} | "
                  f"{','.join(map(str, sig[2]))} | {old * 1e3:.1f} | {new * 1e3:.1f} | "
                  f"{lib * 1e3:.1f} | {bound * 1e3:.1f} ({by[0]}) | {plan} |")
        print(f"\nsums (ms, calls weighted): old {sums[0]:.3f}, new {sums[1]:.3f}, "
              f"cuDNN {sums[2]:.3f}, bound {sums[3]:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
