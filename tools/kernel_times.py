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
CLI's default recipe, ``port_support.TRAIN_CFG``) at ``--batch``, traced on
the meta device, is timed by ``port_support.time_ms`` (10 calls captured in
one CUDA graph, replayed between CUDA events, after warm-up) and weighted by
its count;
``--library`` also times the one torch call computing the same function
(cuDNN: ``F.conv3d``, ``F.conv_transpose3d`` for K2 and the data gradients
it computes, ``torch.nn.grad.conv3d_weight`` for K6; fp32 with TF32 off)
and, in a forward, K8 (``se_tail``: its sums and masked apply) at the SE
blocks' shapes of a served forward, bf16 at 32 volumes (cfg1, prob,
prob_dense) and fp32 at 64 (cfg1), beside the torch chain it replaces
(``se_tail_times``).
``--kernels`` times only the kernels named (wrapper names, e.g.
``in_backward``); ``--split`` adds each shape's device time by CUDA kernel
(``kernels_us``, a call's share of ``--reps`` calls under torch.profiler,
outside the graph), e.g. K7's two passes. ``--wgrad-schedule split |
pingpong`` holds K6's plans to one schedule of its consumer warpgroups
(``convolution.wgrad_plan``'s ``schedules``; ping-pong falls back to split
where no plan's rows fit one warpgroup; each row records the one it ran). ``--model`` traces the forward
of another model of ``port_support.py`` (``prob``: the probabilistic ladder,
``prob_dense``: its dense-skip form with the six-part stitch) instead of
cfg1's. ``--host`` adds the host us per call of K1 and K3, through the
direct call and through the registered operator (``host_us_per_call``).
``--stamps`` builds the diagnostic
library (``PMR_STAMPS=1``, ``csrc/stamps.cuh``) and, at each of
STAMP_SHAPES (those of ``--kernels`` where given: ``--kernels conv3d_wgrad``
stamps K6's three), runs the K1/K2 or K6 call once with its blocks'
clock64 counters installed: the mean cycles a block spends in each phase
of the kernel (stamped times are not the kernel's times; they are its own
account).
Inputs are drawn on the
card from a fixed seed. Run it from the root of a checkout: it uses that
checkout's package and ``port_support.py``, and builds that checkout's
kernels, so ``ptxas`` lists each compiled variant's registers and spills
(from the log kept beside the library where it was already built). To
compare two versions, unpack one into a directory of the other and run the
script from each root in turns, on one card: A, B, B, A. Prints one JSON line: the card, then
per dtype and kernel the sum over the forward (ms); ``--out`` gets the same
with each shape's time and the ptxas report.
"""

import argparse
import contextlib
import functools
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.getcwd())

PTXAS_KERNELS = ("conv3d_wgmma_kernel", "wgmma_splitk_reduce_kernel", "in_stats_kernel",
                 "in_apply_kernel", "wgrad_wgmma_kernel", "wgrad_reduce_kernel",
                 "wgrad_split_kernel",
                 "in_bwd_reduce_kernel", "in_bwd_apply_kernel", "se_sums_kernel",
                 "se_apply_kernel")


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


def stamp_shapes(ps, cv, cuda_lib, dtype, gen, kernels=None):
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
        run, _ = _calls(ps, cv, None, name, sig, dtype, gen)
        run()
        torch.cuda.synchronize()
        buf.zero_()
        run()
        torch.cuda.synchronize()
        tot = buf.sum(dim=0).tolist()
        blocks = max(tot[-1], 1)
        row = {"blocks": tot[-1], "cycles_per_block": {
            ph: tot[i] / blocks for i, ph in enumerate(STAMP_PHASES) if tot[i]}}
        row["ms_stamped"] = ps.time_ms(run, 3, capture=False)
        out[label] = row
    torch.cuda.synchronize()
    for entry in STAMP_ENTRIES:  # the buffer is freed on return: no kernel may write it
        if hasattr(lib, entry):
            cuda_lib.check(getattr(lib, entry)(None), entry)
    return out


def kernel_split(ps, run, reps):
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
    return {k: v / reps for k, v in ps.device_time(prof)[1].items()}


@contextlib.contextmanager
def operator_route():
    """K1-K4's wrappers call their registered ``pmr::`` operators, as they do
    while ``torch.export`` traces, in place of the direct call."""
    from prostatemr_3d_cad_cspca_tpu_torch.ops import cuda_lib

    direct = cuda_lib.exporting
    cuda_lib.exporting = lambda: True
    try:
        yield
    finally:
        cuda_lib.exporting = direct


def host_us_per_call(n=2000):
    """Host us per call of K3 and K1 through the direct call and through the
    operator, at a shape whose kernel is shorter than its dispatch (16x16x16
    voxels, 16 channels, bf16): wall time of n calls over n, in turns
    (direct, operator, operator, direct)."""
    import torch
    from prostatemr_3d_cad_cspca_tpu_torch.ops import convolution as cv
    from prostatemr_3d_cad_cspca_tpu_torch.ops import normalization as nm

    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((1, 16, 16, 16, 16), generator=gen, device="cuda").bfloat16()
    k = (0.1 * torch.randn((1, 3, 3, 16, 16), generator=gen, device="cuda")).bfloat16()
    b = torch.zeros(16, device="cuda")
    fns = {"in_stats": lambda: nm.in_stats(x), "conv3d": lambda: cv.conv3d([x], k, b)}
    out = {}
    for name, fn in fns.items():
        times = {"direct": [], "operator": []}
        for route in ("direct", "operator", "operator", "direct"):
            with (operator_route() if route == "operator" else contextlib.nullcontext()):
                for _ in range(50):
                    fn()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
                times[route].append((time.perf_counter() - t0) / n * 1e6)
        out[name] = times
    return out


def _calls(ps, cv, nm, name, sig, dtype, gen):
    """(the kernel call, its library call or None) at one path signature."""
    import torch

    if name == "conv3d":
        parts, kernel, bias, st = ps._conv_case(sig, dtype, gen)
        return (lambda: cv.conv3d(parts, kernel, bias, st)), ps._conv_library(parts, kernel, st)
    if name == "conv3d_pair":  # an SE block's first and projection convs in one launch
        parts, k1, b1, k4, b4, st = ps._pair_case(sig, dtype, gen)
        return ((lambda: cv.conv3d_pair(parts, k1, b1, k4, b4, st)),
                ps._conv_library(parts, torch.cat([k4, k1], dim=4), st))
    if name == "conv3d_transpose":
        x, kernel, bias, st = ps._convt_case(sig, dtype, gen)
        return ((lambda: cv.conv3d_transpose(x, kernel, bias, st)),
                ps._convt_library(x, kernel, st))
    if name == "conv3d_wgrad":
        a, b, ks, st = ps._wgrad_case(sig, dtype, gen)
        return (lambda: cv.conv3d_wgrad(a, b, ks, st)), ps._wgrad_library(a, b, ks, st)
    x, scale, bias = ps._in_case(sig[0], dtype, gen)
    if name == "in_backward":
        gy = torch.randn(x.shape, generator=gen, device="cuda").to(dtype)
        stats = nm.in_stats_plain(x)
        return (lambda: nm.in_backward(x, gy, stats, scale, bias, sig[1])), None
    if name == "in_stats":
        return (lambda: nm.in_stats(x)), (
            lambda: torch.var_mean(x, dim=(1, 2, 3), correction=0))
    stats = nm.in_stats_plain(x)
    return (lambda: nm.in_apply(x, stats, scale, bias, sig[1])), None


SE_TAIL_BATCH = {"bfloat16": 32, "float32": 64}  # a serve cell's MC-4 forward, a gland one's
SE_TAIL_MODELS = {"bfloat16": ("cfg1", "prob", "prob_dense"), "float32": ("cfg1",)}


def se_tail_times(ps, k8, dtype, models, reps):
    """K8 at each SE output shape of the serving forward of ``models``
    ({name: config}) at SE_TAIL_BATCH volumes, beside the torch chain it
    replaces: ms of the sums (``se_mean``; plain: the fp32 mean) and of the
    masked apply at keep 0.5 (``se_tail``; plain: gate, shortcut, LReLU,
    compare, divide, where), a row a shape with its blocks a forward of each
    model, and each model's sums over its blocks. The draw and the squeeze
    MLP, the same on both sides, are left out."""
    import torch

    dn = ps._dn(dtype)
    counts = {m: ps.trace_se_shapes(cfg, SE_TAIL_BATCH[dn]) for m, cfg in models.items()}
    gen = torch.Generator(device="cuda").manual_seed(25)
    rows = []
    for shape in sorted(set().union(*counts.values())):
        x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        res = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        s = torch.rand((shape[0], 1, 1, 1, shape[-1]), generator=gen, device="cuda").to(dtype)
        u = torch.rand(shape, generator=gen, device="cuda")
        rows.append({"shape": shape, "blocks": {m: counts[m][shape] for m in models},
                     "sums_ms": ps.time_ms(lambda: k8.se_mean(x), reps),
                     "apply_ms": ps.time_ms(lambda: k8.se_tail(x, s, res, u, 0.5), reps),
                     "plain_sums_ms": ps.time_ms(lambda: k8.se_mean_plain(x), reps),
                     "plain_apply_ms": ps.time_ms(
                         lambda: k8.se_tail_plain(x, s, res, u, 0.5), reps)})
        del x, res, s, u
    totals = {m: {k: sum(r[k] * r["blocks"][m] for r in rows)
                  for k in ("sums_ms", "apply_ms", "plain_sums_ms", "plain_apply_ms")}
              for m in models}
    return {"batch": SE_TAIL_BATCH[dn], "totals": totals, "shapes": rows}


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
    import port_support as ps
    from prostatemr_3d_cad_cspca_tpu_torch.ops import convolution as cv
    from prostatemr_3d_cad_cspca_tpu_torch.ops import cuda_lib
    from prostatemr_3d_cad_cspca_tpu_torch.ops import normalization as nm
    from prostatemr_3d_cad_cspca_tpu_torch.ops import se_tail as k8

    if args.wgrad_schedule != "auto":  # K6's plans held to one schedule of its warpgroups
        cv.wgrad_plan = functools.partial(_held_plan, cv.wgrad_plan,
                                          args.wgrad_schedule == "pingpong")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    cuda_lib.library()
    out = {"checkout": os.getcwd(), "card": smi, "step": args.step, "batch": args.batch,
           "model": args.model, "wgrad_schedule": args.wgrad_schedule,
           "ptxas": {v["name"]: [v["registers"], v["spill_bytes"]]
                     for v in ps.ptxas_variants(cuda_lib.build_log)
                     if any(k in v["name"] for k in PTXAS_KERNELS)}}
    gen = torch.Generator(device="cuda").manual_seed(1234)
    if args.host:
        out["host_us"] = host_us_per_call()
    if args.stamps:
        out["stamps"] = {dn: stamp_shapes(ps, cv, cuda_lib, getattr(torch, dn), gen,
                                          args.kernels) for dn in args.dtypes}
    models = {"cfg1": ps.CFG1, "prob": ps.PROB, "prob_dense": ps.PROB_DENSE}
    for dn in args.dtypes:
        dtype = getattr(torch, dn)
        if args.step == "train":
            calls = ps.trace_model_calls(ps.TRAIN_CFG, args.batch, dtype, head="train")
        elif args.model == "cfg1":
            calls = ps.trace_path_calls(args.batch, dtype)
        else:
            calls = ps.trace_model_calls(models[args.model], args.batch, dtype,
                                         head="forward")
        per = {}
        for (name, sig), count in sorted(calls.items(), key=lambda kv: str(kv[0])):
            if args.kernels and name not in args.kernels:
                continue
            run, lib = _calls(ps, cv, nm, name, sig, dtype, gen)
            row = {"sig": sig, "count": count, "ms": ps.time_ms(run, args.reps)}
            if name == "conv3d_wgrad":
                ash, bsh, ks, st = sig
                tma = tuple(s[-1] * dtype.itemsize % 16 == 0 for s in (ash, bsh))
                row["pingpong"] = cv.wgrad_plan(tuple(ash), bsh[-1], tuple(ks), tuple(st), dtype,
                                                tma)["pingpong"]
            if args.library and lib is not None:
                row["library_ms"] = ps.time_ms(lib, args.reps)
            if args.split:
                row["kernels_us"] = kernel_split(ps, run, args.reps)
            per.setdefault(name, []).append(row)
        out[dn] = {}
        if args.library and args.step == "forward" and (not args.kernels
                                                        or "se_tail" in args.kernels):
            out[dn]["se_tail"] = se_tail_times(
                ps, k8, dtype, {m: models[m] for m in SE_TAIL_MODELS[dn]}, args.reps)
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
