#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths on one NVIDIA GPU (deterministic,
Monte-Carlo and sliding-window M1 serving, and the GEMM-rate probe) and hold
every hand-written kernel against its plain twin.

    python3 chip_smoke.py [--seed 0] [--out FILE]

Phases (each raises on failure, so the script exits non-zero and prints no
"ok" line):

  1. build     nvidia-smi name and power limit; TF32 off for fp32 references;
               nvcc builds csrc/*.cu for sm_90a.
  2. kernels   K1 conv3d, K2 conv3d_transpose, K3 in_stats, K4 in_apply at
               every distinct shape the cfg1 forward gives them at the serving
               batch, in bf16 (K1/K2: the mma.sync tensor-core kernel) and
               fp32 (K1/K2: the FMA kernel), against their plain twins on the
               card; device times in bf16 beside each shape's bound and,
               where one torch call computes the same function, that call's
               time. Kernel, twin and library call are each timed alike: 10
               calls captured in one CUDA graph, replayed between CUDA
               events, so host dispatch stays out. At one split-K shape each,
               K1 and K2 run twice on the same inputs and must give the same
               bits; so does K3 at its largest path shape. K5 gemm_loop at the
               probe's 8 (shape, iterations): checked with 3 iterations and
               with the probe's own count (|diff|/max(1,|ref|) <= 2**-7), run
               twice where gemm_plan splits a tile (the same bits), timed at
               the probe's count beside its bound and the time of cuBLAS
               torch.mm calls, one per iteration, as one CUDA graph.
  3. serve     a cfg1 checkpoint in the JAX npz format (weights drawn by numpy
               from --seed, dropout 0) -> M1.load(dtype=bfloat16) ->
               InferenceSession, 3 requests of 2 volumes of 20x160x160x3;
               launch counters must rise by exactly 50/4/37/37 per forward.
               Then one more request under torch.profiler, outside the counted
               run: device busy share and device time by kernel, which must
               show conv3d_mma_kernel, splitk_reduce_kernel and
               in_stats_kernel.
  4. parity    one fp32 volume through the card model and the same model on
               the CPU (plain twins): softmax max |diff| <= 1e-3; bf16 vs fp32
               on the card: mean |diff| <= 1e-2.
  5. serve_mc  the same weights with the CLI's default dropout (monte-carlo,
               0.5), bf16, 3 requests of 2 volumes at mc_iter=4 (one forward
               of 8 each); std > 0, the same seed the same outputs; at rate 0
               std exactly 0 and the mean equal to the deterministic model's
               output on the same stacked batch. One more request profiled.
  6. serve_sw  serve.run on two 24x256x256x3 cases (18 tiles each) with
               --MC_ITER 2 --TTA 1 and a 2-member fold ensemble, fp32; then
               one 20x192x192 case of the deterministic model on the card and
               on the CPU: max |diff| <= 1e-3.
  7. probe     probes/gemm_rate.py's mm, loop and conv modes in-process: K5's
               and cuBLAS's TFLOP/s per shape, K1 at conv_probe's geometry
               beside cuDNN.
  8. paths     K1-K4 against their twins at the distinct shapes of the
               serve_mc (batch 8, bf16) and serve_sw (batch 16, fp32)
               forwards.

Each path's launch counters are set to 0 just before it and read just
after. The last line is {"ok": true, "device": {...}}; the line before it
lists every kernel with its launches on its path, error and times, and
ptxas's registers, static shared memory and spills of its CUDA kernels; for
K1 and K2 also the route by dtype.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

# cfg1: the CLI's default architecture (bench cfg1), 93.2 GFLOP per volume
CFG1 = dict(
    input_spatial_dims=(20, 160, 160), input_channels=3, num_classes=2,
    filters=(16, 32, 64, 128, 256),
    strides=((1, 1, 1), (1, 2, 2), (1, 2, 2), (2, 2, 2), (2, 2, 2)),
    kernel_sizes=((1, 3, 3), (1, 3, 3), (3, 3, 3), (3, 3, 3), (3, 3, 3)),
    se_reduction=(8, 8, 8, 8, 8),
    att_sub_samp=((1, 1, 1), (1, 1, 1), (1, 1, 1), (1, 1, 1)),
    dropout_rate=0.0, dropout_mode="standard")
LAUNCHES_PER_FORWARD = {"conv3d": 50, "conv3d_transpose": 4, "in_stats": 37,
                        "in_apply": 37}
PKG = "prostatemr_3d_cad_cspca_tpu_torch"
KERNEL_INFO = {  # name: (source, TPU kernel replaced, path it launches on)
    "conv3d": (f"{PKG}/csrc/conv3d_mma.cu", "benchmarks/r2_probe_pallas_mxu.py:80",
               "serve"),
    "conv3d_transpose": (f"{PKG}/csrc/conv3d_mma.cu",
                         "benchmarks/r2_probe_pallas_mxu.py:80", "serve"),
    "in_stats": (f"{PKG}/csrc/instance_norm.cu", "benchmarks/r2_probe_conv.py:198",
                 "serve"),
    "in_apply": (f"{PKG}/csrc/instance_norm.cu", "benchmarks/r2_probe_conv.py:198",
                 "serve"),
    "gemm_loop": (f"{PKG}/csrc/gemm_loop.cu", "benchmarks/r2_probe_pallas_mxu.py:56",
                  "probe"),
}
ALSO_REPLACES = {"gemm_loop": "benchmarks/r2_probe_pallas_mm2.py:45"}
CONV_KERNELS = ("conv3d", "conv3d_transpose")
CONV_ROUTES = {"bfloat16": f"mma.sync bf16, {PKG}/csrc/conv3d_mma.cu",
               "float32": f"fma fp32, {PKG}/csrc/conv3d.cu"}
MMA_KERNEL_NAMES = ("conv3d_mma_kernel", "splitk_reduce_kernel")
PTXAS_NAMES = {  # kernel: the CUDA kernels (mangled-name substrings) it launches
    "conv3d": MMA_KERNEL_NAMES, "conv3d_transpose": MMA_KERNEL_NAMES,
    "in_stats": ("in_stats_kernel",), "in_apply": ("in_apply_kernel",),
    "gemm_loop": ("gemm_loop_kernel", "gemm_splitk_reduce_kernel")}
BUILT_KERNEL_NAMES = MMA_KERNEL_NAMES + ("conv3d_igemm_kernel", "in_stats_kernel",
                                         "in_apply_kernel", "gemm_loop_kernel",
                                         "gemm_splitk_reduce_kernel")
PROFILE_KERNEL_NAMES = MMA_KERNEL_NAMES + ("in_stats_kernel",)  # must show in a profile
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BF16_FLOP_PER_S = 989e12   # H100 SXM dense bf16 tensor-core peak
BF16_ULP = 2.0 ** -7       # bf16 spacing just below 1: one rounding step
REQUESTS, BATCH = 3, 2     # served requests, volumes per request
REPS = 10                  # timed launches per kernel shape
MC_ITER = 4                # posterior samples per served MC request
GEMM_CHECK_ITERS = 3       # K5 iterations for the check against its twin
SW_CASE, SW_DET_CASE = (24, 256, 256), (20, 192, 192)
SW_FORWARDS = 5 * 2 * 2 + 1  # 5 chunks x 2 views x 2 members, + 1 chunk


def emit(obj):
    print(json.dumps(obj), flush=True)


# ------------------------------------------------------------------ build
def phase_build():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from prostatemr_3d_cad_cspca_tpu_torch.ops import cuda_lib

    t0 = time.perf_counter()
    path = cuda_lib.build()
    cuda_lib.library()
    emit({"phase": "build", "library": os.path.basename(path),
          "seconds": round(time.perf_counter() - t0, 3),
          "ptxas": ptxas_report(cuda_lib.build_log, BUILT_KERNEL_NAMES)})
    return smi


# ------------------------------------------------- path shapes (meta trace)
def trace_path_calls(batch, dtype=None):
    """Every kernel call of one cfg1 forward at ``batch`` in ``dtype``
    (default bf16), found by running the model on the meta device with
    recording wrappers."""
    import torch
    from prostatemr_3d_cad_cspca_tpu_torch.models.m1 import m1
    from prostatemr_3d_cad_cspca_tpu_torch.ops import convolution, normalization

    calls = []
    originals = {}

    def record(mod, name, sig):
        orig = getattr(mod, name)
        originals[(mod, name)] = orig

        def wrapper(*a, **kw):
            calls.append((name, sig(*a, **kw)))
            return orig(*a, **kw)
        setattr(mod, name, wrapper)

    record(convolution, "conv3d", lambda parts, kernel, bias=None,
           strides=(1, 1, 1): (tuple(tuple(p.shape) for p in parts),
                               tuple(kernel.shape), tuple(strides)))
    record(convolution, "conv3d_transpose", lambda x, kernel, bias=None,
           strides=(1, 1, 1): (tuple(x.shape), tuple(kernel.shape), tuple(strides)))
    record(normalization, "in_stats", lambda x: (tuple(x.shape),))
    record(normalization, "in_apply", lambda x, stats, scale, bias, lrelu=False,
           epsilon=1e-3: (tuple(x.shape), bool(lrelu)))
    try:
        kw = {k: v for k, v in CFG1.items() if k != "input_spatial_dims"}
        with torch.device("meta"):
            net = m1(**kw, dtype=dtype or torch.bfloat16)
            x = torch.zeros((batch, *CFG1["input_spatial_dims"], 3))
            with torch.no_grad():
                net(x)
    finally:
        for (mod, name), orig in originals.items():
            setattr(mod, name, orig)
    counts = collections.Counter(name for name, _ in calls)
    if dict(counts) != LAUNCHES_PER_FORWARD:
        raise AssertionError(f"cfg1 forward calls {dict(counts)}, expected "
                             f"{LAUNCHES_PER_FORWARD}")
    return collections.Counter(calls)


# ---------------------------------------------------------------- timing
def time_ms(fn, reps, capture=True):
    """Device time of one call of ``fn``: ``reps`` calls captured in one CUDA
    graph and replayed between CUDA events, after one warm-up call and one
    warm-up replay. The capture takes each call's launches on the current
    stream and its ``torch.empty`` allocations; the host's work (numpy
    packing, ctypes, Python) stays outside the replay, so kernel, twin and
    library call are timed alike, on the device. ``capture=False`` is for a
    ``fn`` that already replays a graph: its calls are timed as they are."""
    import torch

    fn()
    torch.cuda.synchronize()
    if capture:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        run = graph.replay
    else:
        run = lambda: [fn() for _ in range(reps)]  # noqa: E731
    run()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def ptxas_report(log, names):
    """Per kernel of ``names`` (a substring of the mangled name): how many
    variants were compiled, their registers, static shared memory and spill
    bytes, from nvcc's ``-Xptxas -v`` report (None when nothing was built in
    this process)."""
    if not log:
        return None
    out, current = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            current = next((n for n in names if n in m.group(1)), None)
            if current:
                out.setdefault(current, {"variants": 0, "registers": [], "smem_bytes": [],
                                         "spill_bytes": 0})["variants"] += 1
            continue
        if current is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill:
            out[current]["spill_bytes"] += int(spill.group(1)) + int(spill.group(2))
        used = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if used:
            out[current]["registers"].append(int(used.group(1)))
            out[current]["smem_bytes"].append(int(used.group(2) or 0))
    return {k: {"variants": v["variants"],
                "registers": [min(v["registers"]), max(v["registers"])],
                "static_smem_bytes": max(v["smem_bytes"]), "spill_bytes": v["spill_bytes"]}
            for k, v in out.items() if v["registers"]}


def bound_ms(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


# ------------------------------------------------------------- kernels
def _errors(got, ref):
    """(max |got - ref|, max |got - ref| / max(1, |ref|)), in fp32."""
    diff = (got.float() - ref.float()).abs()
    return float(diff.max()), float((diff / ref.float().abs().clamp(min=1.0)).max())


def _conv_case(sig, dtype, gen):
    import torch

    part_shapes, kshape, strides = sig
    parts = [torch.randn(s, generator=gen, device="cuda").to(dtype) for s in part_shapes]
    fan_in = kshape[0] * kshape[1] * kshape[2] * kshape[3]
    kernel = (torch.randn(kshape, generator=gen, device="cuda") / fan_in ** 0.5).to(dtype)
    bias = torch.randn(kshape[4], generator=gen, device="cuda") * 0.1
    return parts, kernel, bias, strides


def _convt_case(sig, dtype, gen):
    import torch

    xshape, kshape, strides = sig
    x = torch.randn(xshape, generator=gen, device="cuda").to(dtype)
    fan_in = kshape[0] * kshape[1] * kshape[2] * kshape[4]
    kernel = (torch.randn(kshape, generator=gen, device="cuda") / fan_in ** 0.5).to(dtype)
    bias = torch.randn(kshape[3], generator=gen, device="cuda") * 0.1
    return x, kernel, bias, strides


def _in_case(shape, dtype, gen):
    import torch

    c = shape[-1]
    x = (torch.randn(shape, generator=gen, device="cuda") * 2 + 0.5).to(dtype)
    scale = 1 + 0.1 * torch.randn(c, generator=gen, device="cuda")
    bias = 0.1 * torch.randn(c, generator=gen, device="cuda")
    return x, scale, bias


def _conv_library(parts, kernel, strides):
    """One cuDNN call computing K1's function: the parts' concat and the XLA
    SAME asymmetric padding are prepared outside the timed call."""
    import torch
    import torch.nn.functional as F
    from prostatemr_3d_cad_cspca_tpu_torch.ops.convolution import same_pads

    x = torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0]
    pads = []
    for axis in (2, 1, 0):
        _, lo, hi = same_pads(x.shape[1 + axis], kernel.shape[axis], strides[axis])
        pads += [lo, hi]
    xp = F.pad(x.permute(0, 4, 1, 2, 3), pads).contiguous(
        memory_format=torch.channels_last_3d)
    w = kernel.permute(4, 3, 0, 1, 2).contiguous(memory_format=torch.channels_last_3d)
    return lambda: F.conv3d(xp, w, stride=strides)


def _convt_library(x, kernel, strides):
    """One cuDNN call computing K2's function: torch's full transposed conv,
    whose SAME window is a view."""
    import torch
    import torch.nn.functional as F

    xt = x.permute(0, 4, 1, 2, 3)
    w = kernel.permute(4, 3, 0, 1, 2).contiguous(memory_format=torch.channels_last_3d)
    return lambda: F.conv_transpose3d(xt, w, stride=strides)


def _conv_flops(sig, transposed):
    from prostatemr_3d_cad_cspca_tpu_torch.ops.convolution import (
        forward_plan, transpose_plan)

    if transposed:
        xshape, kshape, strides = sig
        plan = transpose_plan(tuple(kshape[:3]), tuple(strides), tuple(xshape[1:4]))
        rows = xshape[0] * int(np.prod(plan["grid"]))
        macs = sum(rows * len(taps) for _, taps in plan["phases"])
        return 2.0 * macs * kshape[3] * kshape[4]
    part_shapes, kshape, strides = sig
    plan = forward_plan(tuple(kshape[:3]), tuple(strides), tuple(part_shapes[0][1:4]))
    rows = part_shapes[0][0] * int(np.prod(plan["out"]))
    return 2.0 * rows * kshape[0] * kshape[1] * kshape[2] * kshape[3] * kshape[4]


def phase_kernels(calls, reps, dtypes=None, timed=True):
    """Each call's kernel against its plain twin in each of ``dtypes``
    (default fp32 and bf16); with ``timed``, bf16 times beside the bound."""
    import torch
    from prostatemr_3d_cad_cspca_tpu_torch.ops import convolution as cv
    from prostatemr_3d_cad_cspca_tpu_torch.ops import normalization as nm

    gen = torch.Generator(device="cuda").manual_seed(1234)
    tol = {torch.float32: 2e-4, torch.bfloat16: 2 * BF16_ULP}
    rows = collections.defaultdict(list)
    bit_checked = set()  # K1/K2: one split-K shape each, run twice; K3 its largest
    for (name, sig), count in sorted(calls.items(), key=lambda kv: str(kv[0])):
        row = {"count": count}
        for dtype in dtypes or (torch.float32, torch.bfloat16):
            dn = str(dtype).replace("torch.", "")
            if name == "conv3d":
                parts, kernel, bias, st = _conv_case(sig, dtype, gen)
                run = lambda: cv.conv3d(parts, kernel, bias, st)  # noqa: E731
                plain = lambda: cv.conv3d_plain(parts, kernel, bias, st)  # noqa: E731
                lib = _conv_library(parts, kernel, st)
                nbytes = _nbytes(*parts, kernel, bias) + _nbytes(run())
                flops = _conv_flops(sig, False)
                row["shape"] = {"parts": sig[0], "kernel": sig[1], "strides": sig[2]}
            elif name == "conv3d_transpose":
                x, kernel, bias, st = _convt_case(sig, dtype, gen)
                run = lambda: cv.conv3d_transpose(x, kernel, bias, st)  # noqa: E731
                plain = lambda: cv.conv3d_transpose_plain(x, kernel, bias, st)  # noqa: E731
                lib = _convt_library(x, kernel, st)
                nbytes = _nbytes(x, kernel, bias) + _nbytes(run())
                flops = _conv_flops(sig, True)
                row["shape"] = {"x": sig[0], "kernel": sig[1], "strides": sig[2]}
            elif name == "in_stats":
                x, _, _ = _in_case(sig[0], dtype, gen)
                run = lambda: nm.in_stats(x)  # noqa: E731
                plain = lambda: nm.in_stats_plain(x)  # noqa: E731
                lib = lambda: torch.var_mean(x, dim=(1, 2, 3), correction=0)  # noqa: E731
                nbytes = _nbytes(x) + x.shape[0] * 2 * x.shape[-1] * 4
                flops = 3.0 * x.numel()
                row["shape"] = {"x": sig[0]}
            else:
                x, scale, bias = _in_case(sig[0], dtype, gen)
                stats = nm.in_stats_plain(x)
                lr = sig[1]
                run = lambda: nm.in_apply(x, stats, scale, bias, lr)  # noqa: E731
                plain = lambda: nm.in_apply_plain(x, stats, scale, bias, lr)  # noqa: E731
                lib = None
                nbytes = 2 * _nbytes(x) + _nbytes(stats, scale, bias)
                flops = 3.0 * x.numel()
                row["shape"] = {"x": sig[0], "lrelu": lr}
            got = run()
            ref = plain()
            torch.cuda.synchronize()
            abs_err, rel_err = _errors(got, ref)
            limit = 1e-4 if name == "in_stats" else tol[dtype]
            if not (np.isfinite(rel_err) and rel_err <= limit):
                raise AssertionError(
                    f"{name} {dn} {sig}: error {rel_err} > {limit}")
            row[f"max_abs_err_{dn}"] = abs_err
            row[f"max_rel_err_{dn}"] = rel_err
            row[f"tol_{dn}"] = limit
            if timed and dtype == torch.bfloat16:  # the serving path's dtype
                row["kernel_ms"] = time_ms(run, reps)
                row["plain_ms"] = time_ms(plain, reps)
                row["library_ms"] = time_ms(lib, reps) if lib is not None else None
                row["bound_ms"], row["bound_by"] = bound_ms(nbytes, flops)
                if name == "in_stats":
                    row["blocks"] = nm.in_stats_plan(
                        x.shape[0], int(np.prod(x.shape[1:4])), x.shape[-1],
                        x.element_size(), x.data_ptr() % 16 == 0)["blocks"]
                    if sig == max((s for n, s in calls if n == name),
                                  key=lambda s: int(np.prod(s[0]))):
                        again = run()
                        torch.cuda.synchronize()
                        if not torch.equal(got, again):
                            raise AssertionError(f"in_stats {sig}: two runs on the same "
                                                 "inputs differ")
                        row["bit_equal"] = True
                        bit_checked.add(name)
                if name in CONV_KERNELS:
                    row["splits"] = _splits(name, sig)
                    if row["splits"] > 1 and name not in bit_checked:
                        again = run()
                        torch.cuda.synchronize()
                        if not torch.equal(got, again):
                            raise AssertionError(f"{name} {sig}: two split-K runs on the "
                                                 "same inputs differ")
                        row["bit_equal"] = True
                        bit_checked.add(name)
        rows[name].append(row)
    if timed and bit_checked != set(CONV_KERNELS + ("in_stats",)) & set(rows):
        raise AssertionError(f"no shape checked for determinism: {bit_checked}")
    return rows


def _splits(name, sig):
    """K-splits of the bf16 kernel at one K1/K2 call."""
    from prostatemr_3d_cad_cspca_tpu_torch.ops.convolution import igemm_schedule

    transposed = name == "conv3d_transpose"
    shapes = [sig[0]] if transposed else sig[0]
    return igemm_schedule(shapes, sig[1], sig[2], transposed)[1]["splits"]


def summarize_kernels(rows):
    out = {}
    for name, shape_rows in rows.items():
        tot = lambda key: sum(r[key] * r["count"] for r in shape_rows)  # noqa: E731
        lib = None if any(r["library_ms"] is None for r in shape_rows) \
            else tot("library_ms")
        by_bytes = sum(r["bound_ms"] * r["count"] for r in shape_rows
                       if r["bound_by"] == "bytes")
        out[name] = dict(
            launches_per_forward=sum(r["count"] for r in shape_rows),
            distinct_shapes=len(shape_rows),
            max_abs_err=max(max(r["max_abs_err_float32"], r["max_abs_err_bfloat16"])
                            for r in shape_rows),
            max_err=max(max(r["max_rel_err_float32"], r["max_rel_err_bfloat16"])
                        for r in shape_rows),
            tol={"float32": shape_rows[0]["tol_float32"],
                 "bfloat16": shape_rows[0]["tol_bfloat16"]},
            kernel_ms=tot("kernel_ms"), plain_ms=tot("plain_ms"),
            library_ms=lib, bound_ms=tot("bound_ms"),
            bound_by="bytes" if by_bytes >= tot("bound_ms") / 2 else "operations")
    return out


# ----------------------------------------------------------------- serve
def write_cfg1_checkpoint(path, seed, **overrides):
    """A cfg1 checkpoint in the JAX package's npz format, weights drawn by
    numpy from ``seed``; ``overrides`` change the config (e.g. dropout),
    never the weights."""
    from prostatemr_3d_cad_cspca_tpu_torch.models.m1 import M1
    from prostatemr_3d_cad_cspca_tpu_torch.utils.serialization import save_model

    model = M1(**{**CFG1, **overrides}, summary=False, init_params=False,
               device="meta")
    rng = np.random.default_rng(seed)
    flat = {}
    for name, p in model.net.named_parameters():
        key, shape = name.replace(".", "/"), tuple(p.shape)
        leaf = key.rsplit("/", 1)[-1]
        parent = key.rsplit("/", 2)[-2]
        if leaf == "kernel":
            fan_in = int(np.prod(shape[:3])) * (shape[4] if "convtd" in parent
                                                 else shape[3])
            val = rng.normal(0.0, 1.0 / np.sqrt(fan_in), shape)
        elif leaf == "scale":
            val = 1.0 + 0.1 * rng.normal(size=shape)
        else:
            val = 0.05 * rng.normal(size=shape)
        flat[key] = val.astype(np.float32)
    save_model(path, model.config, flat)


def counters():
    from prostatemr_3d_cad_cspca_tpu_torch.ops import convolution as cv
    from prostatemr_3d_cad_cspca_tpu_torch.ops import gemm
    from prostatemr_3d_cad_cspca_tpu_torch.ops import normalization as nm

    return {"conv3d": cv.conv3d, "conv3d_transpose": cv.conv3d_transpose,
            "in_stats": nm.in_stats, "in_apply": nm.in_apply,
            "gemm_loop": gemm.gemm_loop}


def reset_counts():
    """Every launch count to 0, just before a path is driven."""
    for fn in counters().values():
        fn.launches = 0


def read_counts():
    return {k: f.launches for k, f in counters().items()}


def forwards(n):
    """The launch counts of ``n`` cfg1 forwards."""
    return {**{k: v * n for k, v in LAUNCHES_PER_FORWARD.items()}, "gemm_loop": 0}


def _serve_requests(session, requests, mc):
    """Serve ``requests`` through ``session``; check each output and that it
    took exactly one forward. Returns latencies (ms), outputs, launches."""
    import torch

    latencies, outputs, per_request = [], [], []
    reset_counts()
    for req in requests:
        before = read_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        probs, unc = session(req)
        torch.cuda.synchronize()
        latencies.append((time.perf_counter() - t0) * 1e3)
        per_request.append({k: v - before[k] for k, v in read_counts().items()})
        shape = (len(req), *CFG1["input_spatial_dims"], 2)
        if probs.shape != shape or (unc is None) == mc or (mc and unc.shape != shape):
            raise AssertionError(f"serve output {probs.shape}, uncertainty "
                                 f"{None if unc is None else unc.shape}")
        if not (np.isfinite(probs).all() and (unc is None or np.isfinite(unc).all())):
            raise AssertionError("serve output is not finite")
        sum_err = float(np.abs(probs.sum(-1) - 1.0).max())
        if sum_err > 4 * BF16_ULP:  # two bf16-rounded channels
            raise AssertionError(f"softmax channels sum off by {sum_err}")
        outputs.append((probs, unc))
    for got in per_request:
        if got != forwards(1):
            raise AssertionError(f"launches per request {got}, expected {forwards(1)}")
    return latencies, outputs, read_counts()


def _median_after_first(latencies):
    steady = sorted(latencies[1:] or latencies)
    return steady[len(steady) // 2]


def _requests(seed):
    rng = np.random.default_rng(seed + 1)
    return [rng.normal(size=(BATCH, *CFG1["input_spatial_dims"], 3)).astype(np.float32)
            for _ in range(REQUESTS)]


def phase_serve(ckpt, seed, smi):
    import torch
    from prostatemr_3d_cad_cspca_tpu_torch.models.m1 import M1
    from prostatemr_3d_cad_cspca_tpu_torch.serve import InferenceSession

    session = InferenceSession(M1.load(ckpt, dtype=torch.bfloat16, device="cuda"),
                               device="cuda")
    requests = _requests(seed)
    latencies, outputs, launches = _serve_requests(session, requests, mc=False)
    med = _median_after_first(latencies)
    emit({"phase": "serve", "card": smi, "dtype": "bfloat16", "batch": BATCH,
          "requests": REQUESTS, "latency_ms": latencies,
          "median_latency_ms_after_first": med, "vol_per_s": BATCH / med * 1e3,
          "launches": launches,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30})
    return launches, requests[0]


def phase_serve_mc(tmp, seed, smi, det_ckpt):
    """The CLI's default dropout (monte-carlo, 0.5) on the serve path's
    weights, bf16, mc_iter=4; then the same seed again, and rate 0 against
    the deterministic model on the same stacked batch of 8 (the same
    forward, so the same bits)."""
    import torch
    from prostatemr_3d_cad_cspca_tpu_torch.models.m1 import M1
    from prostatemr_3d_cad_cspca_tpu_torch.serve import InferenceSession

    ckpt = os.path.join(tmp, "cfg1_mc.npz")
    write_cfg1_checkpoint(ckpt, seed, dropout_mode="monte-carlo", dropout_rate=0.5)

    def session(path):
        return InferenceSession(M1.load(path, dtype=torch.bfloat16, device="cuda"),
                                mc_iter=MC_ITER, seed=seed, device="cuda")

    requests = _requests(seed)
    torch.cuda.reset_peak_memory_stats()
    latencies, outputs, launches = _serve_requests(session(ckpt), requests, mc=True)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    phase_profile(ckpt, requests[0], mc_iter=MC_ITER, path="serve_mc")
    probs, std = outputs[0]
    if not (float(std.min()) >= 0.0 and float(std.max()) > 0.0):
        raise AssertionError(f"MC std in [{std.min()}, {std.max()}]")
    again = session(ckpt)(requests[0])
    if not (np.array_equal(again[0], probs) and np.array_equal(again[1], std)):
        raise AssertionError("the same seed gave other MC outputs")
    ckpt0 = os.path.join(tmp, "cfg1_mc0.npz")
    write_cfg1_checkpoint(ckpt0, seed, dropout_mode="monte-carlo", dropout_rate=0.0)
    mean0, std0 = session(ckpt0)(requests[0])
    det = InferenceSession(M1.load(det_ckpt, dtype=torch.bfloat16, device="cuda"),
                           device="cuda")
    det_probs = det(np.concatenate([requests[0]] * MC_ITER))[0][:BATCH]
    det_diff = float(np.abs(mean0 - det_probs).max())
    if not (np.all(std0 == 0.0) and det_diff == 0.0):
        raise AssertionError(f"rate 0: std max {std0.max()}, mean vs deterministic "
                             f"{det_diff}")
    med = _median_after_first(latencies)
    emit({"phase": "serve_mc", "card": smi, "dtype": "bfloat16", "batch": BATCH,
          "mc_iter": MC_ITER, "dropout": ["monte-carlo", 0.5], "requests": REQUESTS,
          "latency_ms": latencies, "median_latency_ms_after_first": med,
          "vol_per_s": BATCH / med * 1e3, "launches": launches,
          "std_max": float(std.max()), "std_mean": float(std.mean()),
          "rate0_std_max": float(std0.max()), "rate0_vs_deterministic_max": det_diff,
          "peak_mem_gib": peak})
    return launches


def _write_cases(tmp, name, shapes, seed):
    rng = np.random.default_rng(seed)
    lines = ["p-id,image_path"]
    for i, shape in enumerate(shapes):
        path = os.path.join(tmp, f"{name}{i}.npy")
        np.save(path, rng.normal(size=(*shape, 3)).astype(np.float32))
        lines.append(f"{name}{i},{path}")
    manifest = os.path.join(tmp, f"{name}.csv")
    with open(manifest, "w") as f:
        f.write("\n".join(lines) + "\n")
    return manifest


def blend_weight(full, window, overlap=0.5):
    """The sliding window's summed Gaussian weight per voxel. Where it is
    below the blend's 1e-8 floor (kept from the JAX package), the blended
    probabilities sum to less than 1."""
    import itertools
    from prostatemr_3d_cad_cspca_tpu_torch.infer import _gaussian_importance, _tile_starts

    w = _gaussian_importance(window)
    norm = np.zeros(full, np.float64)
    for c in itertools.product(*[_tile_starts(f, k, overlap) for f, k in zip(full, window)]):
        norm[tuple(slice(s, s + k) for s, k in zip(c, window))] += w
    return norm


def phase_serve_sw(tmp, seed, smi, det_ckpt):
    """serve.run on whole-gland cases: MC + TTA + a 2-member fold ensemble
    by sliding window, then deterministic card-vs-CPU parity."""
    import torch
    from prostatemr_3d_cad_cspca_tpu_torch import serve

    members = []
    for i in range(2):
        members.append(os.path.join(tmp, f"fold{i}.npz"))
        write_cfg1_checkpoint(members[-1], seed + i, dropout_mode="monte-carlo",
                              dropout_rate=0.5)
    manifest = _write_cases(tmp, "gland", [SW_CASE, SW_CASE], seed + 2)
    out_dir = os.path.join(tmp, "sw_out")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = serve.main(["--MODEL", ",".join(members), "--MANIFEST", manifest,
                          "--OUTPUT_DIR", out_dir, "--MC_ITER", "2", "--TTA", "1",
                          "--SEED", str(seed), "--DEVICE", "cuda"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    floored = blend_weight(SW_CASE, CFG1["input_spatial_dims"]) < 1e-8
    for r in results:
        det, unc = np.load(r["detection_path"]), np.load(r["uncertainty_path"])
        if det.shape != (*SW_CASE, 2) or unc.shape != det.shape:
            raise AssertionError(f"{r['p-id']}: outputs {det.shape}, {unc.shape}")
        if not (np.isfinite(det).all() and np.isfinite(unc).all()
                and float(unc.min()) >= 0.0 and float(unc.max()) > 0.0):
            raise AssertionError(f"{r['p-id']}: outputs not finite or std not >= 0")
        sums = det.sum(-1)
        if (float(np.abs(sums[~floored] - 1.0).max()) > 1e-4
                or float(sums.max()) > 1.0 + 1e-4):
            raise AssertionError(f"{r['p-id']}: probabilities do not sum to 1")
    if [r["p-id"] for r in results] != ["gland0", "gland1"]:
        raise AssertionError(f"manifest order lost: {[r['p-id'] for r in results]}")

    manifest = _write_cases(tmp, "det", [SW_DET_CASE], seed + 3)
    t1 = time.perf_counter()
    card = serve.main(["--MODEL", det_ckpt, "--MANIFEST", manifest, "--OUTPUT_DIR",
                       os.path.join(tmp, "det_card"), "--DEVICE", "cuda"])
    torch.cuda.synchronize()
    det_seconds = time.perf_counter() - t1
    launches = read_counts()
    if launches != forwards(SW_FORWARDS):
        raise AssertionError(f"sliding-window launches {launches}, expected "
                             f"{forwards(SW_FORWARDS)}")
    cpu = serve.main(["--MODEL", det_ckpt, "--MANIFEST", manifest, "--OUTPUT_DIR",
                      os.path.join(tmp, "det_cpu"), "--DEVICE", "cpu"])
    diff = float(np.abs(np.load(card[0]["detection_path"])
                        - np.load(cpu[0]["detection_path"])).max())
    emit({"phase": "serve_sw", "card": smi, "dtype": "float32",
          "cases": [list(SW_CASE)] * 2, "tiles_per_case": 18, "mc_iter": 2, "tta": 1,
          "members": 2, "seconds": seconds, "seconds_per_case": seconds / 2,
          "voxels_below_blend_floor": int(floored.sum()),
          "det_case": list(SW_DET_CASE), "det_case_seconds": det_seconds,
          "det_card_vs_cpu_max": diff, "launches": launches, "peak_mem_gib": peak})
    if not diff <= 1e-3:
        raise AssertionError(f"sliding window card vs CPU differs by {diff}")
    return launches


def phase_gemm(reps):
    """K5 at the probe's 8 (shape, iterations): checked against its twin
    with a few iterations and with the probe's count, run twice where the
    plan splits a tile (the same bits), then timed at the probe's count
    beside its bound, the twin and one cuBLAS torch.mm per iteration (the
    loop replayed as one CUDA graph)."""
    import torch
    from prostatemr_3d_cad_cspca_tpu_torch.ops import gemm
    from prostatemr_3d_cad_cspca_tpu_torch.probes import gemm_rate as gr

    cases = [(gr.MM_SHAPE, gr.MM_ITERS)] + [(s, gr.LOOP_ITERS[0]) for s in gr.LOOP_SHAPES]
    rows = []
    for (m, k, n), iters in cases:
        a, w = gr.operands(m, k, n, "cuda", seed=m + k + n)
        plan = gemm.gemm_plan(m, k, n, iters)
        row = {"shape": [m, k, n], "iters": iters, "tol": BF16_ULP}
        for label, it in (("check", GEMM_CHECK_ITERS), ("full", iters)):
            got = gemm.gemm_loop(a, w, it)
            ref = gemm.gemm_loop_plain(a, w, it)
            torch.cuda.synchronize()
            abs_err, rel_err = _errors(got, ref)
            if not (np.isfinite(rel_err) and rel_err <= BF16_ULP):
                raise AssertionError(f"gemm_loop {m}x{k}x{n} at {it} iterations: error "
                                     f"{rel_err} > {BF16_ULP}")
            row.update({f"{label}_iters": it, f"max_abs_err_{label}": abs_err,
                        f"max_rel_err_{label}": rel_err})
        if plan["split"]:
            again = gemm.gemm_loop(a, w, iters)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"gemm_loop {m}x{k}x{n}: two split runs differ")
            row["bit_equal"] = True
        library = gr.cublas_loop(a, w, iters)
        nbytes = _nbytes(a, w) + m * n * 2
        flops = 2.0 * m * k * n * iters
        bound, by = bound_ms(nbytes, flops)
        row.update({"kernel_ms": time_ms(lambda: gemm.gemm_loop(a, w, iters), reps),
                    "plain_ms": time_ms(lambda: gemm.gemm_loop_plain(a, w, iters), reps),
                    "library_ms": time_ms(library, reps, capture=False), "bound_ms": bound,
                    "bound_by": by, "split": plan["split"], "blocks": plan["blocks"],
                    "splits": plan["splits"], "units": len(gemm.plan_units(plan))})
        row["tflops"] = flops / row["kernel_ms"] / 1e9
        row["library_tflops"] = flops / row["library_ms"] / 1e9
        rows.append(row)
    if not any(r.get("bit_equal") for r in rows):
        raise AssertionError("no split K5 case checked for determinism")
    tot = lambda key: sum(r[key] for r in rows)  # noqa: E731
    return dict(launches_per_pass=len(rows), distinct_shapes=len(rows),
                max_abs_err=max(max(r["max_abs_err_check"], r["max_abs_err_full"])
                                for r in rows),
                max_err=max(max(r["max_rel_err_check"], r["max_rel_err_full"])
                            for r in rows), tol={"bfloat16": BF16_ULP},
                kernel_ms=tot("kernel_ms"), plain_ms=tot("plain_ms"),
                library_ms=tot("library_ms"), bound_ms=tot("bound_ms"),
                bound_by="operations"), rows


def phase_probe(smi):
    """The probe entry point's three modes, in-process, on the card."""
    from prostatemr_3d_cad_cspca_tpu_torch.probes import gemm_rate

    reset_counts()
    out = gemm_rate.run(gemm_rate.build_parser().parse_args(["mm", "loop", "conv"]))
    launches = read_counts()
    conv = out["conv"]
    emit({"phase": "probe", "card": smi, "launches": launches,
          "mm_tflops": out["mm"]["tflops"],
          "loop_tflops": {"x".join(map(str, r["shape"])): [r["tflops"], r["library_tflops"]]
                          for r in out["loop"]},
          "conv_ms": conv["ms"], "conv_tflops": conv["tflops"],
          "conv_library_ms": conv["library_ms"], "conv_max_rel_err": conv["max_rel_err"]})
    if not conv["max_rel_err"] <= conv["tol"]:
        raise AssertionError(f"K1 at conv_probe's geometry: error {conv['max_rel_err']}")
    if launches["gemm_loop"] == 0 or launches["conv3d"] == 0:
        raise AssertionError(f"the probe path launched {launches}")
    return launches, out


def phase_paths():
    """K1-K4 against their twins at the distinct shapes of the serve_mc
    (batch 2 x mc 4, bf16) and serve_sw (2 cases x 4 tiles x mc 2, fp32)
    forwards."""
    import torch

    out = {}
    for name, batch, dtype in (("serve_mc", BATCH * MC_ITER, torch.bfloat16),
                               ("serve_sw", 2 * 4 * 2, torch.float32)):
        rows = phase_kernels(trace_path_calls(batch, dtype), 0, dtypes=(dtype,),
                             timed=False)
        dn = str(dtype).replace("torch.", "")
        out[name] = {k: {"shapes": len(v), "max_rel_err": max(r[f"max_rel_err_{dn}"]
                                                              for r in v)}
                     for k, v in rows.items()}
    emit({"phase": "paths", "batch_checks": out})


def phase_profile(ckpt, volume, top=12, mc_iter=1, path="serve"):
    """One more bf16 request of ``path`` under torch.profiler (outside the
    counted run): device busy share of the request's wall time and device
    time by kernel name (the ``top`` names, and always the bf16 conv's main
    and split-K reduce kernels and K3's kernel, which must have run)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from prostatemr_3d_cad_cspca_tpu_torch.models.m1 import M1
    from prostatemr_3d_cad_cspca_tpu_torch.serve import InferenceSession

    session = InferenceSession(M1.load(ckpt, dtype=torch.bfloat16, device="cuda"),
                               mc_iter=mc_iter, device="cuda")
    session(volume)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        session(volume)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans, by_name = [], collections.Counter()
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA and evt.time_range.elapsed_us() > 0:
            spans.append((evt.time_range.start, evt.time_range.end))
            ident = re.search(r"(\w+)[<(]", evt.name)
            by_name[ident.group(1) if ident else evt.name[:40]] += \
                evt.time_range.elapsed_us()
    busy, end = 0.0, None
    for s, e in sorted(spans):  # union of device intervals
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    missing = [k for k in PROFILE_KERNEL_NAMES if k not in by_name]
    if missing:
        raise AssertionError(f"{path}: the profile shows no {missing}")
    shown = dict(by_name.most_common(top))
    shown.update({k: by_name[k] for k in PROFILE_KERNEL_NAMES})
    emit({"phase": "profile", "path": path, "wall_ms": wall_us / 1e3,
          "device_busy_ms": busy / 1e3,
          "device_busy_share": busy / wall_us if wall_us else None,
          "device_events": len(spans),
          "top_ms": {k: v / 1e3 for k, v in sorted(shown.items(), key=lambda kv: -kv[1])}})


def phase_parity(ckpt, volume):
    import torch
    from prostatemr_3d_cad_cspca_tpu_torch.models.m1 import M1

    x = volume[:1]
    card = M1.load(ckpt, device="cuda")
    cpu = M1.load(ckpt, device="cpu")
    card16 = M1.load(ckpt, device="cuda", dtype=torch.bfloat16)
    t0 = time.perf_counter()
    p_card = card.predict(x).float().cpu().numpy()
    p_cpu = cpu.predict(x).float().numpy()
    p_16 = card16.predict(x).float().cpu().numpy()
    fp32_err = float(np.abs(p_card - p_cpu).max())
    d16 = np.abs(p_16 - p_card)
    emit({"phase": "parity", "fp32_card_vs_cpu_max": fp32_err,
          "bf16_vs_fp32_card_max": float(d16.max()),
          "bf16_vs_fp32_card_mean": float(d16.mean()),
          "seconds": round(time.perf_counter() - t0, 3)})
    if not fp32_err <= 1e-3:
        raise AssertionError(f"fp32 card vs CPU softmax differs by {fp32_err}")
    if not float(d16.mean()) <= 1e-2:
        raise AssertionError(f"bf16 vs fp32 mean difference {float(d16.mean())}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the checkpoint's weights and the requests")
    ap.add_argument("--out", type=str, default=None,
                    help="also write every result as one JSON file here")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    import prostatemr_3d_cad_cspca_tpu_torch  # noqa: F401  (fails outside the repo)

    smi = phase_build()
    calls = trace_path_calls(BATCH)
    rows = phase_kernels(calls, REPS)
    summary = summarize_kernels(rows)
    summary["gemm_loop"], rows["gemm_loop"] = phase_gemm(REPS)
    for name, s in summary.items():
        emit({"kernel": name, "card": smi, "dtype": "bfloat16", **s,
              "shapes": rows[name]})

    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "cfg1.npz")
        write_cfg1_checkpoint(ckpt, args.seed)
        launches["serve"], volume = phase_serve(ckpt, args.seed, smi)
        phase_profile(ckpt, volume)
        phase_parity(ckpt, volume)
        launches["serve_mc"] = phase_serve_mc(tmp, args.seed, smi, ckpt)
        launches["serve_sw"] = phase_serve_sw(tmp, args.seed, smi, ckpt)
    launches["probe"], probe = phase_probe(smi)
    phase_paths()

    kernels = []
    from prostatemr_3d_cad_cspca_tpu_torch.ops import cuda_lib

    for name, s in summary.items():
        src, replaces, path = KERNEL_INFO[name]
        n = launches[path][name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "path": path, "launches": n,
                        "max_abs_err": s["max_abs_err"], "ms": s["kernel_ms"],
                        "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
                        "bound_by": s["bound_by"], "library_ms": s["library_ms"],
                        **({"also_replaces": ALSO_REPLACES[name]}
                           if name in ALSO_REPLACES else {}),
                        "ptxas": ptxas_report(cuda_lib.build_log, PTXAS_NAMES[name]),
                        **({"routes": CONV_ROUTES} if name in CONV_KERNELS else {})})
        if n == 0:
            raise AssertionError(f"{name} never launched on the {path} path")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": smi, "summary": summary, "rows": rows,
                       "launches": launches, "probe": probe}, f, indent=1)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
