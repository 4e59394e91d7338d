#!/usr/bin/env python3
"""Device time of the port's model-path kernels over one cfg1 forward (K1-K4)
or one cfg1 train step (``--step train``: K1-K4, the data gradients' K1/K2
calls, K6 and K7), per dtype, on one GPU, and each CUDA kernel's ptxas
report.

    python3 tools/kernel_times.py [--step forward|train] [--batch 2]
                                  [--model cfg1|prob|prob_dense]
                                  [--dtypes float32 bfloat16] [--kernels NAME ...]
                                  [--library] [--split] [--host] [--stamps]
                                  [--wgrad-schedule auto|split|pingpong]
                                  [--out FILE]

Every distinct kernel call of the cfg1 forward (or of the train step of the
CLI's default recipe, ``chip_smoke.TRAIN_CFG``) at ``--batch`` is timed as
``chip_smoke.py`` times it (10 calls captured in one CUDA graph, replayed
between CUDA events, after warm-up) and weighted by its count;
``--library`` also times the one torch call computing the same function
(cuDNN: ``F.conv3d``, ``F.conv_transpose3d`` for K2 and the data gradients
it computes, ``torch.nn.grad.conv3d_weight`` for K6; fp32 with TF32 off).
``--kernels`` times only the kernels named (wrapper names, e.g.
``in_backward``); ``--split`` adds each shape's device time by CUDA kernel
(``kernels_us``, a call's share of ``--reps`` calls under torch.profiler,
outside the graph), e.g. K7's two passes. ``--wgrad-schedule split |
pingpong`` holds K6's plans to one schedule of its consumer warpgroups
(``convolution.wgrad_plan``'s ``schedules``; ping-pong falls back to split
where no plan's rows fit one warpgroup; each row records the one it ran). ``--model`` traces the forward
of another model of ``chip_smoke.py`` (``prob``: the probabilistic ladder,
``prob_dense``: its dense-skip form with the six-part stitch) instead of
cfg1's. ``--host`` adds the host us per call of K1 and K3
(``chip_smoke.host_us_per_call``). ``--stamps`` builds the diagnostic
library (``PMR_STAMPS=1``, ``csrc/stamps.cuh``) and, at each of
STAMP_SHAPES (those of ``--kernels`` where given: ``--kernels conv3d_wgrad``
stamps K6's three), runs the K1/K2 or K6 call once with its blocks'
clock64 counters installed: the mean cycles a block spends in each phase
of the kernel (stamped times are not the kernel's times; they are its own
account).
Inputs are drawn on the
card from a fixed seed. Run it from the root of a checkout: it uses that
checkout's package and ``chip_smoke.py``, and builds that checkout's
kernels, so ``ptxas`` lists each compiled variant's registers and spills
(from the log kept beside the library where it was already built). To
compare two versions, unpack one into a directory of the other and run the
script from each root in turns, on one card: A, B, B, A. Prints one JSON line: the card, then
per dtype and kernel the sum over the forward (ms); ``--out`` gets the same
with each shape's time and the ptxas report.
"""

import argparse
import functools
import json
import os
import re
import subprocess
import sys

sys.path.insert(0, os.getcwd())

PTXAS_KERNELS = ("conv3d_wgmma_kernel", "wgmma_splitk_reduce_kernel", "in_stats_kernel",
                 "in_apply_kernel", "wgrad_wgmma_kernel", "wgrad_reduce_kernel",
                 "wgrad_split_kernel",
                 "in_bwd_reduce_kernel", "in_bwd_apply_kernel")


def ptxas_variants(log):
    """{mangled name: [registers, spill bytes (stores + loads)]} of the
    kernels in PTXAS_KERNELS, from nvcc's -Xptxas -v report."""
    out, current = {}, None
    for line in (log or "").splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            current = m.group(1) if any(k in m.group(1) for k in PTXAS_KERNELS) else None
            if current:
                out[current] = [None, 0]
            continue
        if current is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill:
            out[current][1] += int(spill.group(1)) + int(spill.group(2))
        used = re.search(r"Used (\d+) registers", line)
        if used:
            out[current][0] = int(used.group(1))
    return out


# the shapes whose cycles --stamps accounts for (in each of --dtypes), at
# batch 2. K1/K2: level 0's two-part stitch, the dense-skip ladder's
# six-part one, level 2's 3x3x3 stitch, level 4's 1x1x1, the stem, the
# ladder's K2 at cin 259, the deepest stitch (level 3's 128+128 at 3x3x3, K
# 6,912) and level 0's flat 1x1x1 16 -> 16 (8,000 one-stage units). K6:
# level 0's 1x3x3 16 -> 16 (the longest K, 1.02 M rows), level 2's 3x3x3
# 64 -> 64, the deepest, level 3's 3x3x3 128 -> 128, level 0's flat 1x1x1
# 16 -> 16 and the deepest K2's (2,2,2) 3x3x3 128 -> 256
L0, L2, L3 = (2, 20, 160, 160, 16), (2, 20, 40, 40, 64), (2, 10, 20, 20, 128)
STAMP_SHAPES = {
    "level0_two_part_32to16": ("conv3d", ((L0, L0), (1, 3, 3, 32, 16), (1, 1, 1))),
    "level0_six_part_96to16": ("conv3d", ((L0,) * 6, (1, 3, 3, 96, 16), (1, 1, 1))),
    "level2_64+64to64_3x3x3": ("conv3d", ((L2, L2), (3, 3, 3, 128, 64), (1, 1, 1))),
    "level4_256to128_1x1x1": ("conv3d", (((2, 5, 10, 10, 256),), (1, 1, 1, 256, 128),
                                         (1, 1, 1))),
    "stem_cin3": ("conv3d", (((2, 20, 160, 160, 3),), (1, 3, 3, 3, 16), (1, 1, 1))),
    "k2_cin259": ("conv3d_transpose", ((2, 5, 10, 10, 259), (3, 3, 3, 128, 259),
                                       (2, 2, 2))),
    "level3_128+128to128_3x3x3": ("conv3d", ((L3, L3), (3, 3, 3, 256, 128), (1, 1, 1))),
    "level0_flat_16to16_1x1x1": ("conv3d", ((L0,), (1, 1, 1, 16, 16), (1, 1, 1))),
    "k6_level0_1x3x3_16to16": ("conv3d_wgrad", (L0, L0, (1, 3, 3), (1, 1, 1))),
    "k6_level2_3x3x3_64to64": ("conv3d_wgrad", (L2, L2, (3, 3, 3), (1, 1, 1))),
    "k6_level3_3x3x3_128to128": ("conv3d_wgrad", (L3, L3, (3, 3, 3), (1, 1, 1))),
    "k6_level0_flat_16to16": ("conv3d_wgrad", (L0, L0, (1, 1, 1), (1, 1, 1))),
    "k6_level3_k2_128to256": ("conv3d_wgrad", (L3, (2, 5, 10, 10, 256), (3, 3, 3), (2, 2, 2))),
}
STAMP_PHASES = ("setup", "issue", "wait", "mma", "epilogue", "producer_wait",
                "producer_load", "convert")
STAMP_ENTRIES = ("pmr_conv3d_wgmma_stamps", "pmr_conv3d_wgrad_stamps")


def stamp_shapes(cs, cv, cuda_lib, dtype, gen, kernels=None):
    """{shape label: mean cycles a block by phase, blocks, stamped ms} of
    each STAMP_SHAPES call (of ``kernels``, default all) in ``dtype``, from
    the stamps build's counters (csrc/stamps.cuh: 4096 slots of 9 unsigned
    64-bit counters, the last the blocks)."""
    import torch

    lib = cuda_lib.library()
    buf = torch.zeros((4096, len(STAMP_PHASES) + 1), dtype=torch.int64, device="cuda")
    for entry in STAMP_ENTRIES:
        if hasattr(lib, entry):
            cuda_lib.check(getattr(lib, entry)(buf.data_ptr()), entry)
    out = {}
    for label, (name, sig) in STAMP_SHAPES.items():
        if kernels and name not in kernels:
            continue
        run, _ = _calls(cs, cv, None, name, sig, dtype, gen)
        run()
        torch.cuda.synchronize()
        buf.zero_()
        run()
        torch.cuda.synchronize()
        tot = buf.sum(dim=0).tolist()
        blocks = max(tot[-1], 1)
        row = {"blocks": tot[-1], "cycles_per_block": {
            ph: tot[i] / blocks for i, ph in enumerate(STAMP_PHASES) if tot[i]}}
        row["ms_stamped"] = cs.time_ms(run, 3, capture=False)
        out[label] = row
    torch.cuda.synchronize()
    for entry in STAMP_ENTRIES:  # the buffer is freed on return: no kernel may write it
        if hasattr(lib, entry):
            cuda_lib.check(getattr(lib, entry)(None), entry)
    return out


def kernel_split(cs, run, reps):
    """{CUDA kernel name: device us a call} over ``reps`` calls of ``run``
    under torch.profiler, after one warm-up call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
    return {k: v / reps for k, v in cs.device_time(prof)[1].items()}


def _calls(cs, cv, nm, name, sig, dtype, gen):
    """(the kernel call, its library call or None) at one path signature."""
    import torch

    if name == "conv3d":
        parts, kernel, bias, st = cs._conv_case(sig, dtype, gen)
        return (lambda: cv.conv3d(parts, kernel, bias, st)), cs._conv_library(parts, kernel, st)
    if name == "conv3d_transpose":
        x, kernel, bias, st = cs._convt_case(sig, dtype, gen)
        return ((lambda: cv.conv3d_transpose(x, kernel, bias, st)),
                cs._convt_library(x, kernel, st))
    if name == "conv3d_wgrad":
        a, b, ks, st = cs._wgrad_case(sig, dtype, gen)
        return (lambda: cv.conv3d_wgrad(a, b, ks, st)), cs._wgrad_library(a, b, ks, st)
    x, scale, bias = cs._in_case(sig[0], dtype, gen)
    if name == "in_backward":
        gy = torch.randn(x.shape, generator=gen, device="cuda").to(dtype)
        stats = nm.in_stats_plain(x)
        return (lambda: nm.in_backward(x, gy, stats, scale, bias, sig[1])), None
    if name == "in_stats":
        return (lambda: nm.in_stats(x)), (
            lambda: torch.var_mean(x, dim=(1, 2, 3), correction=0))
    stats = nm.in_stats_plain(x)
    return (lambda: nm.in_apply(x, stats, scale, bias, sig[1])), None


def _held_plan(plan, pingpong, *args, **kwargs):
    """K6's plan on one schedule of its warpgroups (ping-pong where a plan's
    rows fit one warpgroup, else split)."""
    try:
        return plan(*args, **kwargs, schedules=(pingpong,))
    except ValueError:
        return plan(*args, **kwargs, schedules=(False,))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--step", choices=["forward", "train"], default="forward")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--model", choices=["cfg1", "prob", "prob_dense"], default="cfg1")
    ap.add_argument("--dtypes", nargs="+", default=["float32", "bfloat16"])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--kernels", nargs="+", default=None)
    ap.add_argument("--library", action="store_true")
    ap.add_argument("--split", action="store_true")
    ap.add_argument("--host", action="store_true")
    ap.add_argument("--stamps", action="store_true")
    ap.add_argument("--wgrad-schedule", choices=["auto", "split", "pingpong"], default="auto")
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device is available", file=sys.stderr)
        return 2
    if args.stamps:
        os.environ["PMR_STAMPS"] = "1"
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    from prostatemr_3d_cad_cspca_tpu_torch.ops import convolution as cv
    from prostatemr_3d_cad_cspca_tpu_torch.ops import cuda_lib
    from prostatemr_3d_cad_cspca_tpu_torch.ops import normalization as nm

    if args.wgrad_schedule != "auto":  # K6's plans held to one schedule of its warpgroups
        cv.wgrad_plan = functools.partial(_held_plan, cv.wgrad_plan,
                                          args.wgrad_schedule == "pingpong")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    cuda_lib.library()
    out = {"checkout": os.getcwd(), "card": smi, "step": args.step, "batch": args.batch,
           "model": args.model, "wgrad_schedule": args.wgrad_schedule,
           "ptxas": ptxas_variants(cuda_lib.build_log)}
    gen = torch.Generator(device="cuda").manual_seed(1234)
    if args.host:
        out["host_us"] = cs.host_us_per_call()
    if args.stamps:
        out["stamps"] = {dn: stamp_shapes(cs, cv, cuda_lib, getattr(torch, dn), gen,
                                          args.kernels) for dn in args.dtypes}
    models = {"cfg1": cs.CFG1, "prob": cs.PROB, "prob_dense": cs.PROB_DENSE}
    for dn in args.dtypes:
        dtype = getattr(torch, dn)
        if args.step == "train":
            calls = cs.trace_model_calls(cs.TRAIN_CFG, args.batch, dtype, head="train")
        elif args.model == "cfg1":
            calls = cs.trace_path_calls(args.batch, dtype)
        else:
            calls = cs.trace_model_calls(models[args.model], args.batch, dtype,
                                         head="forward")
        per = {}
        for (name, sig), count in sorted(calls.items(), key=lambda kv: str(kv[0])):
            if args.kernels and name not in args.kernels:
                continue
            run, lib = _calls(cs, cv, nm, name, sig, dtype, gen)
            row = {"sig": sig, "count": count, "ms": cs.time_ms(run, args.reps)}
            if name == "conv3d_wgrad":
                ash, bsh, ks, st = sig
                tma = tuple(s[-1] * dtype.itemsize % 16 == 0 for s in (ash, bsh))
                row["pingpong"] = cv.wgrad_plan(tuple(ash), bsh[-1], tuple(ks), tuple(st), dtype,
                                                tma)["pingpong"]
            if args.library and lib is not None:
                row["library_ms"] = cs.time_ms(lib, args.reps)
            if args.split:
                row["kernels_us"] = kernel_split(cs, run, args.reps)
            per.setdefault(name, []).append(row)
        out[dn] = {}
        for name, rows in per.items():
            out[dn][name] = {"sum_ms": sum(r["ms"] * r["count"] for r in rows), "shapes": rows}
            if args.library and all("library_ms" in r for r in rows):
                out[dn][name]["library_sum_ms"] = sum(r["library_ms"] * r["count"] for r in rows)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f)
    print(json.dumps({**{k: out[k] for k in ("checkout", "card", "step", "batch", "model")
                         if k in out},
                      **{k: out[k] for k in ("host_us", "stamps") if k in out},
                      **{dn: {name: {k: v for k, v in s.items() if k != "shapes"}
                              for name, s in out[dn].items()} for dn in args.dtypes}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
