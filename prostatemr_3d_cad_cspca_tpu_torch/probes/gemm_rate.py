"""GEMM-rate probe: what a hand-written tensor-core loop (K5) and the conv
kernel K1 sustain at the packed M1 conv's shapes. The port's copy of the TPU
package's ``benchmarks/r2_probe_pallas_mxu.py`` and
``benchmarks/r2_probe_pallas_mm2.py``.

    python -m prostatemr_3d_cad_cspca_tpu_torch.probes.gemm_rate \\
        [mm] [loop] [conv] [--DEVICE cuda]

K5 (``ops/gemm.py``, ``csrc/gemm_loop.cu``) keeps each 64-deep slab of A and
W resident in shared memory for all the iterations of its work range, as the
TPU kernels kept A and W in VMEM, and spreads the (tile, step) space over the
card's 132 SMs with TMA loads feeding wgmma. One K5 call lasts tens of
microseconds, so on a card its timings replay ``GRAPH_CALLS`` calls captured
in one CUDA graph: the host's launch work stays out.

Modes (all three when none is named):

  mm    ``bf16(sum_{i<200} A.W)`` at 640x1152x128 through K5: ms per
        iteration and TFLOP/s (``mm_probe``).
  loop  the same loop at the seven shapes of ``r2_probe_pallas_mm2.py``, the
        time per iteration taken as the slope between 100 and 800 iterations
        (``_slope``; K5's cost per call is not quite fixed, since its work
        ranges and their partial sums follow the iteration count, so the
        slope is a marginal rate); beside it the library yardstick
        (``xla_loop_mm``'s counterpart): one cuBLAS ``torch.mm`` bf16 per
        iteration, the loop captured in one CUDA graph so that its replay
        times the library's kernels and no Python dispatch between them.
  conv  ``conv_probe``'s geometry through K1: a (1,3,3) SAME conv with bias on
        x = (64, 20, 160, 20, 128) bf16, 128 -> 128 channels, checked against
        K1's plain twin on the first 4 slices and timed beside cuDNN
        ``F.conv3d`` on the same padded input. The TPU probe's ``th`` sweep
        was a VMEM tiling knob and has no counterpart here.

Every printed line names the device it ran on (on a card: its name and power
limit as ``nvidia-smi`` gives them). ``--DEVICE cpu`` runs the plain twins
and times them on the host clock; such numbers say nothing of a card.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops.convolution import conv3d, conv3d_plain
from ..ops.gemm import gemm_loop

MODES = ("mm", "loop", "conv")
MM_SHAPE, MM_ITERS = (640, 1152, 128), 200
LOOP_SHAPES = ((640, 1152, 128), (1280, 1152, 128), (2560, 1152, 128),
               (5120, 1152, 128), (2560, 1152, 256), (640, 144, 128),
               (2560, 144, 128))
LOOP_ITERS = (100, 800)
CONV_SHAPE = (64, 20, 160, 20, 128)  # (B, D, H, W, C): the packed res0 geometry
CONV_CHECK_SLICES = 4
BF16_ULP = 2.0 ** -7
GRAPH_CALLS = 10  # K5 calls a timed CUDA graph holds (its calls last microseconds)


def device_label(device: torch.device) -> str:
    """The card's name and power limit, or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return f"{torch.cuda.get_device_name(device)}, power limit not read"
    lines = out.strip().splitlines()
    index = device.index if device.index is not None else torch.cuda.current_device()
    return lines[index].strip() if index < len(lines) else out.strip()


def operands(m: int, k: int, n: int, device, seed: int = 0):
    """A ~ N(0, 1) and W ~ N(0, 0.05^2), bf16, as the TPU probes draw them."""
    gen = torch.Generator(device=device).manual_seed(seed)
    a = torch.randn((m, k), generator=gen, device=device).to(torch.bfloat16)
    w = (torch.randn((k, n), generator=gen, device=device) * 0.05).to(torch.bfloat16)
    return a, w


def timed_ms(fn: Callable, device: torch.device, reps: int = 3,
             graph_calls: int = 1) -> float:
    """Best of ``reps`` calls after one warm-up (the probes' ``timed``):
    CUDA events on a card, the host clock on the CPU. On a card with
    ``graph_calls`` > 1, that many calls of ``fn`` are captured in one CUDA
    graph and a timing is one replay divided by ``graph_calls``, so that the
    host's work before each launch stays out of a call of microseconds."""
    fn()
    run, per = fn, 1
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        if graph_calls > 1:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                for _ in range(graph_calls):
                    fn()
            run, per = graph.replay, graph_calls
            run()
            torch.cuda.synchronize(device)
    best = math.inf
    for _ in range(reps):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            stop.record()
            stop.synchronize()
            best = min(best, start.elapsed_time(stop) / per)
        else:
            t0 = time.perf_counter()
            fn()
            best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


def slope_ms(make_fn: Callable[[int], Callable], device, iters: Sequence[int],
             graph_calls: int = 1) -> float:
    """Time per iteration as the slope between two iteration counts, which
    cancels the fixed cost of a launch (the probes' ``_slope``)."""
    k1, k2 = iters
    t1 = timed_ms(make_fn(k1), device, graph_calls=graph_calls)
    t2 = timed_ms(make_fn(k2), device, graph_calls=graph_calls)
    return (t2 - t1) / (k2 - k1)


def _tflops(flop: float, ms: Optional[float]) -> Optional[float]:
    return flop / (ms * 1e-3) / 1e12 if ms and ms > 0 else None


def _report(row: Dict, label: str) -> Dict:
    row = {"device": label, **row}
    print(json.dumps(row), flush=True)
    return row


def mm_probe(device, shape=MM_SHAPE, iters: int = MM_ITERS,
             label: Optional[str] = None) -> Dict:
    """``mm_probe``: one K5 launch of ``iters`` iterations, resident operands."""
    device = torch.device(device)
    m, k, n = shape
    a, w = operands(m, k, n, device)
    ms = timed_ms(lambda: gemm_loop(a, w, iters), device, graph_calls=GRAPH_CALLS)
    per = ms / iters
    return _report({"mode": "mm", "shape": [m, k, n], "iters": iters,
                    "ms": ms, "ms_per_iter": per,
                    "tflops": _tflops(2.0 * m * k * n, per)},
                   label or device_label(device))


def cublas_loop(a: torch.Tensor, w: torch.Tensor, iters: int) -> Callable:
    """The library yardstick of ``iters`` loop iterations: one cuBLAS
    ``torch.mm`` per iteration into one output, captured in a CUDA graph.
    Returns the graph's ``replay``, one call that launches only the
    library's kernels, as ``xla_loop_mm`` is one program on the TPU."""
    if a.device.type != "cuda":
        raise ValueError(f"the cuBLAS yardstick runs on a card, not {a.device}")
    out = torch.empty((a.shape[0], w.shape[1]), dtype=a.dtype, device=a.device)
    side = torch.cuda.Stream(a.device)
    side.wait_stream(torch.cuda.current_stream(a.device))
    with torch.cuda.stream(side):  # warm cuBLAS outside the capture
        torch.mm(a, w, out=out)
    torch.cuda.current_stream(a.device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            torch.mm(a, w, out=out)
    return graph.replay


def loop_probe(device, shapes=LOOP_SHAPES, iters=LOOP_ITERS, library: bool = True,
               label: Optional[str] = None) -> List[Dict]:
    """``pallas_loop_mm`` beside ``xla_loop_mm``: per-iteration time of K5 and
    of one cuBLAS ``torch.mm`` bf16, each as a slope between ``iters``."""
    device = torch.device(device)
    label = label or device_label(device)
    rows = []
    for m, k, n in shapes:
        a, w = operands(m, k, n, device)
        per = slope_ms(lambda it: (lambda: gemm_loop(a, w, it)), device, iters,
                       graph_calls=GRAPH_CALLS)
        lib = None
        if library:
            lib = slope_ms(lambda it: cublas_loop(a, w, it), device, iters)
        flop = 2.0 * m * k * n
        rows.append(_report({"mode": "loop", "shape": [m, k, n], "iters": list(iters),
                             "ms_per_iter": per, "tflops": _tflops(flop, per),
                             "library_ms_per_iter": lib,
                             "library_tflops": _tflops(flop, lib)}, label))
    return rows


def _cudnn_conv(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> Callable:
    """One cuDNN call computing the same (1,3,3) SAME conv: the padding and
    the channels-last layout are prepared outside the timed call."""
    xp = F.pad(x.permute(0, 4, 1, 2, 3), (1, 1, 1, 1)).contiguous(
        memory_format=torch.channels_last_3d)
    wt = kernel.permute(4, 3, 0, 1, 2).contiguous(memory_format=torch.channels_last_3d)
    b = bias.to(x.dtype)
    return lambda: F.conv3d(xp, wt, b)


def conv_probe(device, shape=CONV_SHAPE, check_slices: int = CONV_CHECK_SLICES,
               library: bool = True, label: Optional[str] = None) -> Dict:
    """``conv_probe``: the streaming (1,3,3) conv through K1, its error
    against K1's plain twin on the first ``check_slices`` depth slices of
    batch 0, and cuDNN's time on the same input."""
    device = torch.device(device)
    b, d, h, wd, c = shape
    gen = torch.Generator(device=device).manual_seed(2)
    x = torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)
    kernel = (torch.randn((1, 3, 3, c, c), generator=gen, device=device) * 0.05
              ).to(torch.bfloat16)
    bias = torch.randn((c,), generator=gen, device=device)
    with torch.no_grad():
        y = conv3d([x], kernel, bias)
        s = min(check_slices, d)
        ref = conv3d_plain([x[:1, :s].contiguous()], kernel, bias)
        diff = (y[:1, :s].float() - ref.float()).abs()
        err = float((diff / ref.float().abs().clamp(min=1.0)).max())
        del y, ref, diff
        ms = timed_ms(lambda: conv3d([x], kernel, bias), device)
        lib = None
        if library:
            lib = timed_ms(_cudnn_conv(x, kernel, bias), device)
    nbytes = 2 * x.numel() * x.element_size()
    flop = 2.0 * b * d * h * wd * 9 * c * c
    return _report({"mode": "conv", "shape": list(shape), "kernel": [1, 3, 3, c, c],
                    "max_rel_err": err, "tol": 2 * BF16_ULP, "ms": ms,
                    "gb_per_s": nbytes / (ms * 1e-3) / 1e9,
                    "tflops": _tflops(flop, ms), "library_ms": lib,
                    "library_tflops": _tflops(flop, lib)},
                   label or device_label(device))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="GEMM-rate probe of K5 and K1")
    p.add_argument("modes", nargs="*", choices=MODES, metavar="MODE",
                   help="any of mm, loop, conv (default: all three)")
    p.add_argument("--DEVICE", type=str, default="cuda",
                   help="'cuda' (default) or 'cpu' for the plain twins")
    return p


def run(args) -> Dict[str, object]:
    device = resolve_device(args.DEVICE)
    modes = list(dict.fromkeys(args.modes)) or list(MODES)
    label = device_label(device)
    library = device.type == "cuda"  # the yardsticks are card calls
    out: Dict[str, object] = {}
    if "mm" in modes:
        out["mm"] = mm_probe(device, label=label)
    if "loop" in modes:
        out["loop"] = loop_probe(device, library=library, label=label)
    if "conv" in modes:
        out["conv"] = conv_probe(device, library=library, label=label)
    return out


def main(argv=None):
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
