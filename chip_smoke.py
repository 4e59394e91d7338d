#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths on one NVIDIA GPU (deterministic,
Monte-Carlo and sliding-window M1 serving, an exported artifact served,
cfg2, the probabilistic and the cascaded M1, the GEMM-rate probe, the
augmentation and train steps of the CLI's default recipe fed by the data
layer, evaluate.run, a fold trained through the training CLI, and the
multi-GPU layer on meshes of the one card) and hold every hand-written
kernel against its plain twin.

    python3 chip_smoke.py [--seed 0] [--out FILE]

It checks the port. Per-kernel device times come from tools/kernel_times.py
(--library: beside cuDNN's), request rates from the benchmark (bench_port/);
the timings it keeps have no other home yet: the train step walls, fit's
epoch and checkpoint ms, the augmentation's ms, the data-parallel serving
latency and the sharded norms' core copies. What it shares with the tools
and the tests (model configurations, the meta-device trace, the fp64
references, the per-kernel cases) is port_support.py's.

Phases (each raises on failure, so the script exits non-zero and prints no
"ok" line):

  1. build     nvidia-smi name and power limit; TF32 off for fp32 references;
               nvcc builds csrc/*.cu for sm_90a; ptxas must give K7's CUDA
               kernels at most 64 registers and no spill, and K6's
               (wgrad_wgmma_kernel at every tile width and tile count of
               both dtypes, wgrad_reduce_kernel, fp32's wgrad_split_kernel)
               no spill.
  2. kernels   K1 conv3d, K2 conv3d_transpose, K3 in_stats, K4 in_apply at
               every distinct shape the cfg1 forward gives them at the serving
               batch, in bf16 and fp32 (K1/K2 on the wgmma kernel with halo
               tiles, bf16 directly and fp32 as 3xTF32; each row names its
               plan: tile, box, slabs, TMA or staged parts), and the K1 pair
               (conv3d_pair: an SE block's first and projection convs in one
               launch), against their plain twins on the card. At one
               split-K shape each, K1 and K2 run twice on
               the same inputs and must give the same bits; so does K3 at its
               largest path shape; in each dtype. fp32 K1 at its deepest and
               its largest path shape against the fp64 product (<= 2e-4,
               beside the twin's own error). K5 gemm_loop at the
               probe's 8 (shape, iterations): checked with 3 iterations and
               with the probe's own count (|diff|/max(1,|ref|) <= 2**-7), run
               twice where gemm_plan splits a tile (the same bits).
               K8 (se_tail.cu) at every SE output shape of the served
               models at the serving batch, in bf16 and fp32: the apply
               against its twin bit for bit, unmasked and masked at keep 0.5
               and 0.75; the mean within fp32 rounding of the twin's
               (torch's fp32 mean), twice the same bits.
  3. serve     a cfg1 checkpoint in the JAX npz format (weights drawn by numpy
               from --seed, dropout 0) -> M1.load(dtype=bfloat16) ->
               InferenceSession, 3 requests of 2 volumes of 20x160x160x3;
               launch counters must rise by exactly 40/5/4/37/37 per forward
               (K1, K1 pairs, K2, K3, K4: LAUNCHES_PER_FORWARD, bf16) and K8's
               se_tail.launches by 8 (se_tail.masked by 0: dropout 0).
               Then one more request under torch.profiler, outside the counted
               run: device busy share and device time by kernel, which must
               show conv3d_wgmma_kernel, wgmma_splitk_reduce_kernel,
               in_stats_kernel, in_apply_kernel, se_sums_kernel and
               se_apply_kernel, in an fp32 profile too.
  4. parity    one fp32 volume through the card model and the same model on
               the CPU (plain twins): softmax max |diff| <= 1e-3; bf16 vs fp32
               on the card: mean |diff| <= 1e-2.
  5. serve_mc  the same weights with the CLI's default dropout (monte-carlo,
               0.5), bf16, 3 requests of 2 volumes at mc_iter=4 (one forward
               of 8 each), 8 K8 applies a request, all masked; std > 0, the
               same seed the same outputs; at rate 0
               std exactly 0 and the mean equal to the deterministic model's
               output on the same stacked batch. One more request profiled.
  6. serve_sw  serve.run on two 24x256x256x3 cases (18 tiles each) with
               --MC_ITER 2 --TTA 1 and a 2-member fold ensemble, fp32; then
               one 20x192x192 case of the deterministic model on the card and
               on the CPU: max |diff| <= 1e-3. One serve_sw forward (fp32,
               16 volumes: 8 under MC 2) profiled as in phase 3.
  7. probe     probes/gemm_rate.py's mm, loop and conv modes in-process: K5's
               and cuBLAS's TFLOP/s per shape, K1 at conv_probe's geometry
               beside cuDNN.
  8. paths     K1-K4 against their twins at the distinct shapes of the
               serve_mc (batch 8, bf16 and fp32), serve_sw (batch 16,
               fp32), serve_prob (batch 8, bf16) and serve_cascade's
               whole-gland (batch 4, fp32) forwards.
  9. serve_cfg2     bench cfg2 (dense skips + deep supervision) at cfg1
               width: 3 bf16 requests of 2 volumes, fp32
               card vs CPU softmax <= 1e-3, bf16 vs fp32 mean <= 1e-2, one
               request profiled.
 10. serve_prob     the reference README's model (probabilistic, latent
               dims (3,2,1,0), deep supervision, monte-carlo dropout 0.5, 4
               input channels): 3 bf16 requests of 2 volumes at mc_iter 4;
               the same seed the same bits, std >= 0 and > 0 somewhere;
               fp32 card vs CPU <= 1e-3 of one forward with every dropout
               mask and latent drawn by numpy on the host and replayed on
               both (a CUDA and a CPU generator draw different bits); one
               request profiled.
 11. serve_cascade  the two-stage cascade (noisy-or), deterministic: 3 bf16
               requests of 2 two-exam volumes; serve.run on one 24x256x256
               two-exam case (an image_path_2 manifest, fp32); fp32 card vs
               CPU <= 1e-3 of one window; one request profiled.
 12. augment   the CLI's default --AUGM_PARAMS on a cfg1-window batch of 2
               (20x160x160x3 image, 2-channel label, its dist_map): card
               against CPU on the same host-drawn replayed draws, every gate
               forced on and every gate off, |diff| <= 1e-4 max(1, |ref|);
               a generator run twice, under torch.cuda.set_sync_debug_mode
               ("error"): the same bits, each voxel's label channels summing
               to 1 within 1e-5; device ms by CUDA events (generator runs)
               and replayed from a CUDA graph (draws on the card), and the
               device kernels of one pass from the profiler.
 13. train     the CLI's default recipe at cfg1 width (monte-carlo dropout
               0.5, focal (1, 1) gamma 2, Keras amsgrad 1e-3 on CALR, L2
               1e-5, augmentation AugmentParams.from_list of the default
               --AUGM_PARAMS), fp32: one step on the card against the same
               step on the CPU (batch 1, host-drawn keep-masks and
               augmentation draws replayed on both)
               and the CPU's fp64 evaluation: loss <= 1e-4 relative;
               every gradient leaf max|diff| / max(1, max|ref|) <= 5e-2
               and all leaves together <= 1e-3 (relative L2), each leaf's
               distance to fp64 and the leaves over 1e-3 reported (the
               CPU's own fp32 step lies up to ~2e-2 from fp64 on deep
               leaves); against an fp64 step that replays the card's
               branch decisions at every kink (BranchReplay), each leaf
               whose fp64 gradient reaches 1e-3 within 1e-3 and all leaves
               within 1e-4 (relative L2); the conv biases ahead of an
               instance norm (exact data gradient 0: the fp32 rounding of
               a sum of N = batch x voxels terms of the norm's input
               gradient dx) each channel within 4 * 2**-24 * sqrt(N) *
               ||dx||_2 of the fp64 dx; the rest reported;
               then 8 augmented steps at batch 2 fed by
               data.custom_data_generator -> batch_iterator(prefetch=2)
               over synthetic labelled .npy cases and their manifest, then
               8 pairs of steps in turns with augmentation off and on
               (off, on, on, off, ...), each step launching exactly what a
               meta trace of the step counts (K1-K4, K6 conv3d_wgrad, K7
               in_backward; augmentation launches none of them), every loss
               finite; the median step wall (steps 2-8) and the medians of
               the pairs' walls on and off, peak memory, one augmented step
               profiled (busy
               share; K6's and K7's CUDA kernels must show; the device ms
               of the kernels under the "augment" range and their share);
               one bf16 step with a finite loss and its own meta trace's
               launches.
 14. evaluate  evaluate.run (fp32, lesion task) on a cfg1 checkpoint and 4
               labelled window-sized cases, two with a lesion: the JAX
               package's metric keys, values in [0, 1], AUROC defined; each
               case's probabilities within 1e-3 of the CPU path's; one
               detect forward a case.
 15. fit       the training CLI (cli.main) at its own defaults (cfg1 width,
               the train phase's recipe, batch 2, fp32) on the fold
               manifests data.ingest writes from 8 raw 24x176x176 cases (2
               folds): 2 epochs of fold 1 (2 steps each) with validation on
               4 cases, npz weights and full-state checkpoints every epoch;
               --RESUME_TRAIN 1 to 3 epochs (the restored state equals the
               saved one bit for bit, one epoch trained, latest step 3);
               the same command again (the completed-fold skip: no
               launch); model_weights_003.npz served through
               InferenceSession (finite, softmax sums to 1 within 1e-4);
               one bf16 epoch (finite losses). Each epoch launches its
               steps times the train step's meta-trace counts plus its
               validation cases times the detect head's; epoch walls, step
               walls inside fit, validation seconds, the checkpoint's MiB,
               blocking, write and restore ms.

 16. export    (after serve_mc) export.main freezes serve_mc's checkpoint
               (monte-carlo 0.5) at --MC_ITER 4 --DTYPE bfloat16 into one
               artifact and validates it (<= 1e-4 from the live model on
               the same draws); serve.run --MODEL on the artifact (two
               window cases) and 3 requests of 2 volumes through
               serve.ExportedSession, each launching exactly one cfg1
               forward's 40/5/4/37/37 (K1-K4 as the registered pmr::
               operators) and giving the live session's bits for the same
               seed; one artifact request profiled
               (conv3d_wgmma_kernel, in_stats_kernel and in_apply_kernel must
               show); a deterministic fp32 artifact with a 24x256x256
               sliding-window program against the live session's
               predict_cases (<= 1e-4, 5 forwards for 2 cases); a tiny
               artifact traced on the CPU and run on the card (K1-K4
               launched, <= 1e-3 from the card's live model).

 17. parallel  (after fit) multi-GPU on the one card. Data-parallel serving:
               InferenceSession over a one-process mesh of data 2 whose
               devices are cuda:0 twice, 3 bf16 requests of 4 volumes
               (exactly 2 forwards a request: 80/10/8/74/74): the bits of the
               one-device session on each replica's rows, mean |diff| <=
               1e-2 from it on all 4 (K1's and K3's plans follow the batch);
               fp32 and MC 4 fp32 (the same seed's draws) <= 1e-5 from the
               one-device session; MC 4 bf16 its own bits for the same
               seed, another seed's apart; request ms beside the
               one-device session's. The CLI's default recipe at batch 2
               (fp32) through make_train_step(mesh=) over an NCCL group of
               one rank: parameters bit-equal to the step without a mesh;
               one step profiled (nccl:all_reduce, K6's and K7's CUDA
               kernels); the all-reduce ms of the 4.39 M-parameter
               gradient. Two gloo ranks, spawned, both computing on cuda:0:
               the DP step (the recipe with SGD) at a global batch of 2,
               each rank replaying the one-process step's branch decisions
               on its rows (BranchReplay; K4 and K7 without their fused
               LReLU, the recorded slope between them), against the
               one-process step (loss <= 1e-5 relative, parameters <= 1e-4
               relative L2); beside it the DP step that decides its kinks
               itself, the elements whose sides differ and the same step
               with Adam (reported); gloo's all-reduce ms;
               spatial_infer_m1 on a 24x256x256x3 volume in slabs of 128
               along H (halo 96) against the unsharded forward (<= 1e-4,
               argmax agreement >= 0.9999), s a case, and the device ms of
               the sharded norms' core copies; make_spatial_train_step on
               20x160x160 (slab 80, halo 96: the exchange spans two slabs)
               against the unsharded loss (<= 1e-5 relative).
 18. parallel_kernels  K1-K4, K6 and K7 against their twins at every
               (shape, dtype) that phase 17's runs gave them, recorded on
               the card: the slabs and the cores K3 takes, the spatial
               step, the DP step at a rank's batch of 1, the batch-4 and
               MC-stacked sessions, the unsharded whole-gland forward; one
               split-K K1/K2 shape, K3's largest and every K6 and K7 shape
               rerun for the same bits; the K1/K2 and K3 calls whose plan
               differs between a batch of 4 and of 2.

The train step's own shapes (its meta trace, batch 2) are checked after
the kernels phase, in both dtypes: the data gradients' K1/K2 calls (K2 of
the output gradient with K1's kernel; K1 for K2), K6 and K7, with K6 and K7
rerun for the same bits and fp32 K6 against the fp64 product per element at
its deepest shape and at level 0's 1x3x3 16 -> 16 (the longest K, within
K6_LEVEL0_FP64_LIMIT); a wgrad_shapes line gives K6's plan (box tile, slab,
taps a block, tile n, schedule, splits) and the routes of A and B (TMA or
staged) at each of its 40 shapes in both dtypes; a train_kernels line gives
each kernel's launches and largest errors over one step.

The kernels phase (2) also checks every K1-K4 shape of the three
model paths above (their detect heads, and the full forwards of cfg2 and of
the probabilistic model: deep-supervision heads, posterior) and of a
dense-skip probabilistic model (whose ladder stitches six parts), at batch 2
in both dtypes; those rows carry their calls per forward of each path.

Each path's launch counters are set to 0 just before it and read just
after; each request of the model paths must launch exactly what a
meta-device trace of its detect head counts. The last line is {"ok": true,
"device": {...}}; the line before it lists every kernel with its launches
on its path and on every path, its error, and ptxas's registers, static
shared memory and spills of its CUDA kernels, in bf16 on the serve path and
in fp32 on the serve_sw path; for K1 and K2 also the route.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

from port_support import (BACKWARD_KERNELS, CASCADE, CFG1, CFG2, FORWARD_KERNELS,
                          LAUNCHES_PER_FORWARD, PROB, PROB_DENSE, TRAIN_CFG, BranchReplay,
                          _conv_case, _conv_fp64, _conv_plan, _convt_case, _dn, _in_case,
                          _is_range, _pair_case, _wgrad_case, device_time, launch_counts,
                          ptxas_variants, recording, time_ms, trace_model_calls,
                          trace_path_calls, trace_se_shapes)

MODEL_PATHS = {"serve_cfg2": CFG2, "serve_prob": PROB, "serve_cascade": CASCADE}
CASCADE_CASE = (24, 256, 256)
PKG = "prostatemr_3d_cad_cspca_tpu_torch"
KERNEL_INFO = {  # name: (source, TPU kernel replaced, path it launches on)
    "conv3d": (f"{PKG}/csrc/conv3d_wgmma.cu", "benchmarks/r2_probe_pallas_mxu.py:80",
               "serve"),
    "conv3d_pair": (f"{PKG}/csrc/conv3d_wgmma.cu", "benchmarks/r2_probe_pallas_mxu.py:80",
                    "serve"),
    "conv3d_transpose": (f"{PKG}/csrc/conv3d_wgmma.cu",
                         "benchmarks/r2_probe_pallas_mxu.py:80", "serve"),
    "in_stats": (f"{PKG}/csrc/instance_norm.cu", "benchmarks/r2_probe_conv.py:198",
                 "serve"),
    "in_apply": (f"{PKG}/csrc/instance_norm.cu", "benchmarks/r2_probe_conv.py:198",
                 "serve"),
    "gemm_loop": (f"{PKG}/csrc/gemm_loop.cu", "benchmarks/r2_probe_pallas_mxu.py:56",
                  "probe"),
    "conv3d_wgrad": (f"{PKG}/csrc/conv3d_wgrad.cu", "benchmarks/r2_probe_pallas_mxu.py:80",
                     "train"),
    "in_backward": (f"{PKG}/csrc/instance_norm.cu", "benchmarks/r2_probe_conv.py:198",
                    "train"),
}
# K8, an SE block's squeeze-excite tail and its MC dropout: its own kernels
# phase, launch counter and kernels-line entry (no TPU kernel computes it)
SE_TAIL_INFO = (f"{PKG}/csrc/se_tail.cu", "none (XLA's fusion of the SE tail and dropout)",
                "serve_mc")
SE_KERNEL_NAMES = ("se_sums_kernel", "se_apply_kernel")
SE_KEEPS = (None, 0.5, 0.75)  # K8's apply: unmasked, and masked at each keep
SE_MEAN_TOL = 1e-5  # K8's mean vs its twin's, |diff| / (mean |x| over the sample)
ALSO_REPLACES = {"gemm_loop": "benchmarks/r2_probe_pallas_mm2.py:45",
                 "in_backward": "ops/pallas/fused_norm.py:181 (git cef1717^, the "
                                "custom_vjp backward of :47 and :70)"}
CONV_KERNELS = ("conv3d", "conv3d_pair", "conv3d_transpose")
# K1/K2's route in both dtypes and its CUDA kernels (main, split-K reduce)
CONV_ROUTE = "wgmma (bf16 directly, fp32 as 3xTF32), halo tiles (TMA or staged)"
CONV_KERNEL_NAMES = ("conv3d_wgmma_kernel", "wgmma_splitk_reduce_kernel")
DTYPE_NAMES = ("bfloat16", "float32")
FP32_PATH = "serve_sw"     # the path that runs K1-K4 in fp32
PTXAS_NAMES = {  # kernel: the CUDA kernels it launches
    "conv3d": CONV_KERNEL_NAMES, "conv3d_pair": CONV_KERNEL_NAMES,
    "conv3d_transpose": CONV_KERNEL_NAMES,
    "in_stats": ("in_stats_kernel",), "in_apply": ("in_apply_kernel",),
    "gemm_loop": ("gemm_loop_kernel", "gemm_splitk_reduce_kernel"),
    "conv3d_wgrad": ("wgrad_wgmma_kernel", "wgrad_reduce_kernel"),
    "in_backward": ("in_bwd_reduce_kernel", "in_bwd_apply_kernel")}
K7_MAX_REGISTERS = 64  # K7's CUDA kernels, no spill (phase_build)
TRAIN_KERNELS = (*FORWARD_KERNELS, *BACKWARD_KERNELS)
# the template argument's start in a mangled name, by element type
MANGLED_TYPE = {"bfloat16": "I13__nv_bfloat16", "float32": "If"}
BUILT_KERNEL_NAMES = {f"{k}[{dn}]": k + MANGLED_TYPE[dn] for dn in DTYPE_NAMES
                      for k in ("in_stats_kernel", "in_apply_kernel")
                      + PTXAS_NAMES["conv3d_wgrad"] + PTXAS_NAMES["in_backward"]
                      + CONV_KERNEL_NAMES}
BUILT_KERNEL_NAMES.update({k: k for k in ("gemm_loop_kernel", "gemm_splitk_reduce_kernel")})
# fp32 K6's split of A and B into bf16 planes (not a template: one variant)
K6_SPLIT_KERNEL = "wgrad_split_kernel"
BUILT_KERNEL_NAMES[f"{K6_SPLIT_KERNEL}[float32]"] = K6_SPLIT_KERNEL


def profile_kernel_names(splits=True):
    """The CUDA kernels a profiled forward must show: K1/K2's main kernel
    and, where the forward splits K, its split-K reduce; K3's and K4's."""
    return CONV_KERNEL_NAMES[:1 + splits] + ("in_stats_kernel", "in_apply_kernel")


TRAIN_PROFILE_NAMES = profile_kernel_names() + PTXAS_NAMES["conv3d_wgrad"] + \
    PTXAS_NAMES["in_backward"]
TRAIN_STEPS = 8
TRAIN_CASES = 6  # synthetic labelled cases behind the train phase's data layer
FIT_CASES, FIT_RAW = 8, (24, 176, 176)  # raw cases the fit phase ingests to the window
# the CLI's default --AUGM_PARAMS (prostatemr_3d_cad_cspca_tpu/cli.py:90-91)
AUGM_PARAMS = "1.00,0.25,0.15,10.0,1,1.20,0.10,0.025,1,0.50,1.50"
AUGMENT_TOL = 1e-4  # augmentation, card vs CPU: |diff| / max(1, |ref|)
GRAD_LEAF_TOL, GRAD_L2_TOL = 5e-2, 1e-3  # card vs CPU train-step gradients (phase_train)
# card vs the fp64 step that replays the card's branch decisions (phase_train): each
# leaf whose fp64 gradient reaches ZERO_GRAD within GRAD_REPLAY_TOL, all leaves
# together within GRAD_REPLAY_L2_TOL (relative L2); leaves below ZERO_GRAD (conv
# biases ahead of an instance norm, exact gradient 0) are reported
GRAD_REPLAY_TOL, GRAD_REPLAY_L2_TOL, ZERO_GRAD = 1e-3, 1e-4, 1e-3
# those conv biases, each channel against its fp32 rounding bound ZERO_BIAS_C *
# 2**-24 * sqrt(N) * ||dx||_2 (zero_grad_bias_ratios)
ZERO_BIAS_C = 4
TRAIN_STEPS_PER_EPOCH, TRAIN_EPOCHS = TRAIN_STEPS, 250
EVAL_CASES = 4
FP32_LIMIT = 2e-4          # fp32 kernel vs twin (and vs fp64), |diff|/max(1,|ref|)
# fp32 K6 vs fp64 at level 0's 1x3x3 16 -> 16 (1.02 M rows), per element as
# FP32_LIMIT: K6 read 2.4e-4 to 4.6e-4 there on an H100 and the fp32 twin's
# cuBLAS matmul 7.2e-4 (PERF.md); fp32 sums of a million products cannot
# hold the near-zero results to 2e-4
K6_LEVEL0_FP64_LIMIT = 6e-4
BF16_ULP = 2.0 ** -7       # bf16 spacing just below 1: one rounding step
REQUESTS, BATCH = 3, 2     # served requests, volumes per request
REPS = 10                  # timed calls of the augmentation and of each core copy
MC_ITER = 4                # posterior samples per served MC request
GEMM_CHECK_ITERS = 3       # K5 iterations for the check against its twin
SW_CASE, SW_DET_CASE = (24, 256, 256), (20, 192, 192)
SW_FORWARDS = 5 * 2 * 2 + 1  # 5 chunks x 2 views x 2 members, + 1 chunk
# the export phase's CPU-traced artifact: the tests' tiny M1 (cfg1's strides)
EXPORT_TINY = dict(CFG1, input_spatial_dims=(4, 16, 16), filters=(4, 8, 12, 16, 24),
                   se_reduction=(2, 2, 2, 2, 2), summary=False)


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
    ptxas = ptxas_summary(cuda_lib.build_log, BUILT_KERNEL_NAMES)
    emit({"phase": "build", "library": os.path.basename(path),
          "seconds": round(time.perf_counter() - t0, 3),
          "nvcc_seconds": cuda_lib.build_seconds, "ptxas": ptxas})
    check_k7_ptxas(ptxas)
    check_k6_ptxas(ptxas)
    return smi


def check_k7_ptxas(ptxas):
    """K7's CUDA kernels, each dtype's vector and scalar variants: at most
    K7_MAX_REGISTERS registers (four 256-thread blocks an SM) and no spill."""
    for k in PTXAS_NAMES["in_backward"]:
        for dn in DTYPE_NAMES:
            r = (ptxas or {}).get(f"{k}[{dn}]")
            if r is None or r["variants"] != 2:
                raise AssertionError(f"ptxas reported no 2 variants of {k}[{dn}]: {r}")
            if r["registers"][1] > K7_MAX_REGISTERS or r["spill_bytes"]:
                raise AssertionError(f"{k}[{dn}]: {r['registers'][1]} registers (at most "
                                     f"{K7_MAX_REGISTERS}), {r['spill_bytes']} spill bytes")


def check_k6_ptxas(ptxas):
    """K6's CUDA kernels in each dtype: the wgmma kernel at every tile width
    and count of 64-row tiles a warpgroup (bf16 nine, fp32 five), the reduce
    and fp32's split, none spilling."""
    import torch
    from prostatemr_3d_cad_cspca_tpu_torch.ops import convolution as cv

    for k in PTXAS_NAMES["conv3d_wgrad"]:
        for dn in DTYPE_NAMES:
            r = (ptxas or {}).get(f"{k}[{dn}]")
            want = (sum(cv.WGRAD_MT[getattr(torch, dn)].values())
                    if k == "wgrad_wgmma_kernel" else 1)
            if r is None or r["variants"] != want:
                raise AssertionError(f"ptxas reported no {want} variants of {k}[{dn}]: {r}")
            if r["spill_bytes"]:
                raise AssertionError(f"{k}[{dn}]: {r['spill_bytes']} spill bytes")
    r = (ptxas or {}).get(f"{K6_SPLIT_KERNEL}[float32]")
    if r is None or r["variants"] != 1 or r["spill_bytes"]:
        raise AssertionError(f"ptxas reported no spill-free {K6_SPLIT_KERNEL}: {r}")


def ptxas_summary(log, names):
    """nvcc's ``-Xptxas -v`` report ``log`` (port_support.ptxas_variants'
    entries) by label of ``names`` ({label: a substring of the mangled
    name}): how many variants were compiled, their registers (least, most),
    static shared memory (most) and spill bytes (sum); None when nothing
    was built in this process."""
    if not log:
        return None
    out = {}
    for v in ptxas_variants(log):
        label = next((n for n, sub in names.items() if sub in v["name"]), None)
        if label is None:
            continue
        r = out.setdefault(label, {"variants": 0, "registers": [], "smem_bytes": [],
                                   "spill_bytes": 0})
        r["variants"] += 1
        r["spill_bytes"] += v["spill_bytes"]
        if v["registers"] is not None:
            r["registers"].append(v["registers"])
            r["smem_bytes"].append(v["smem_bytes"])
    return {k: {"variants": v["variants"],
                "registers": [min(v["registers"]), max(v["registers"])],
                "static_smem_bytes": max(v["smem_bytes"]), "spill_bytes": v["spill_bytes"]}
            for k, v in out.items() if v["registers"]}


# ------------------------------------------------------------- kernels
def _errors(got, ref):
    """(max |got - ref|, max |got - ref| / max(1, |ref|)), in fp32."""
    diff = (got.float() - ref.float()).abs()
    return float(diff.max()), float((diff / ref.float().abs().clamp(min=1.0)).max())


def phase_kernels(calls, dtypes=None, per_path=None, bit_kernels=CONV_KERNELS + ("in_stats",),
                  rerun=True):
    """Each call's kernel against its plain twin in each of ``dtypes``
    (default fp32 and bf16); with ``rerun``, each call's plan, and in each
    dtype one K1/K2 split-K shape (where none of the calls splits K in that
    dtype, its first shape), K3's largest shape, every K6 shape and every
    K7 shape run twice on the same inputs (the same bits), and each of
    ``bit_kernels`` present must have had one. ``per_path`` ({path:
    calls}) adds each row's calls per forward of each path."""
    import torch
    from prostatemr_3d_cad_cspca_tpu_torch.ops import convolution as cv
    from prostatemr_3d_cad_cspca_tpu_torch.ops import normalization as nm

    gen = torch.Generator(device="cuda").manual_seed(1234)
    dtypes = dtypes or (torch.float32, torch.bfloat16)
    tol = {torch.float32: FP32_LIMIT, torch.bfloat16: 2 * BF16_ULP}
    rows = collections.defaultdict(list)
    bit_checked = set()  # (kernel, dtype): a K1/K2 split-K shape; K3's largest
    largest_in = max((s for n, s in calls if n == "in_stats"), key=lambda s: int(np.prod(s[0])),
                     default=None)
    splitting = {(n, _dn(d)) for n, s in calls if n in CONV_KERNELS for d in dtypes
                 if _splits(n, s, d) > 1}
    for (name, sig), count in sorted(calls.items(), key=lambda kv: str(kv[0])):
        row = {"count": count, "sig": sig}
        if per_path:
            row["per_forward"] = {p: c[(name, sig)] for p, c in per_path.items()
                                  if (name, sig) in c}
        for dtype in dtypes:
            dn = _dn(dtype)
            if name == "conv3d":
                parts, kernel, bias, st = _conv_case(sig, dtype, gen)
                run = lambda: cv.conv3d(parts, kernel, bias, st)  # noqa: E731
                plain = lambda: cv.conv3d_plain(parts, kernel, bias, st)  # noqa: E731
                row["shape"] = {"parts": sig[0], "kernel": sig[1], "strides": sig[2]}
            elif name == "conv3d_pair":  # compared as the kernel's columns [f | q]
                parts, k1, b1, k4, b4, st = _pair_case(sig, dtype, gen)
                kernel, bias = torch.cat([k4, k1], dim=4), torch.cat([b4, b1])
                run = lambda: cv.conv3d_pair(parts, k1, b1, k4, b4, st)  # noqa: E731
                plain = lambda: cv.conv3d_pair_plain(  # noqa: E731
                    parts, kernel, bias, sig[3], st)[::-1]
                row["shape"] = {"parts": sig[0], "kernel": sig[1], "strides": sig[2],
                                "split": sig[3]}
            elif name == "conv3d_transpose":
                x, kernel, bias, st = _convt_case(sig, dtype, gen)
                run = lambda: cv.conv3d_transpose(x, kernel, bias, st)  # noqa: E731
                plain = lambda: cv.conv3d_transpose_plain(x, kernel, bias, st)  # noqa: E731
                row["shape"] = {"x": sig[0], "kernel": sig[1], "strides": sig[2]}
            elif name == "conv3d_wgrad":
                a, b, ks, st = _wgrad_case(sig, dtype, gen)
                run = lambda: cv.conv3d_wgrad(a, b, ks, st)  # noqa: E731
                plain = lambda: cv.conv3d_wgrad_plain(a, b, ks, st)  # noqa: E731
                row["shape"] = {"a": sig[0], "b": sig[1], "kernel": sig[2], "strides": sig[3]}
            elif name == "in_backward":
                x, scale, bias = _in_case(sig[0], dtype, gen)
                gy = torch.randn(x.shape, generator=gen, device="cuda").to(dtype)
                stats = nm.in_stats_plain(x)
                lr = sig[1]
                run = lambda: nm.in_backward(x, gy, stats, scale, bias, lr)  # noqa: E731
                plain = lambda: nm.in_backward_plain(x, gy, stats, scale, bias, lr)  # noqa: E731
                row["shape"] = {"x": sig[0], "lrelu": lr}
            elif name == "in_stats":
                x, _, _ = _in_case(sig[0], dtype, gen)
                run = lambda: nm.in_stats(x)  # noqa: E731
                plain = lambda: nm.in_stats_plain(x)  # noqa: E731
                row["shape"] = {"x": sig[0]}
            else:
                x, scale, bias = _in_case(sig[0], dtype, gen)
                stats = nm.in_stats_plain(x)
                lr = sig[1]
                run = lambda: nm.in_apply(x, stats, scale, bias, lr)  # noqa: E731
                plain = lambda: nm.in_apply_plain(x, stats, scale, bias, lr)  # noqa: E731
                row["shape"] = {"x": sig[0], "lrelu": lr}
            got = run()
            ref = plain()
            torch.cuda.synchronize()
            if name == "conv3d_pair":
                got, ref = torch.cat(got[::-1], -1), torch.cat(ref[::-1], -1)
            if name == "in_backward":  # dx in the dtype; the fp32 sums as K3's
                sums_err = _errors(got[1], ref[1])[1]
                if not (np.isfinite(sums_err) and sums_err <= 1e-4):
                    raise AssertionError(f"{name} {dn} {sig}: sums error {sums_err} > 1e-4")
                row[f"sums_rel_err_{dn}"] = sums_err
                if dtype == torch.float32 and not sig[1]:  # K7's sums against fp64
                    exact = nm.in_backward_plain(*(t.double() for t in (x, gy, stats, scale,
                                                                        bias)))[1]
                    row["sums_rel_err_vs_fp64"] = _errors(got[1], exact)[1]
                first_sums, got, ref = got[1], got[0], ref[0]
            abs_err, rel_err = _errors(got, ref)
            if name == "conv3d_wgrad":
                # each element sums up to 1 M products, whose rounding
                # scales with the sums' size, not the element's: held
                # against the largest |ref| of the output (the fp64 check
                # at the deepest shape stays per element)
                rel_err = abs_err / max(1.0, float(ref.float().abs().max()))
            limit = 1e-4 if name == "in_stats" else tol[dtype]
            if not (np.isfinite(rel_err) and rel_err <= limit):
                raise AssertionError(
                    f"{name} {dn} {sig}: error {rel_err} > {limit}")
            row[f"max_abs_err_{dn}"] = abs_err
            row[f"max_rel_err_{dn}"] = rel_err
            row[f"tol_{dn}"] = limit
            if not rerun:
                continue
            twice = False
            if name == "in_stats":
                row[f"blocks_{dn}"] = nm.in_stats_plan(
                    x.shape[0], int(np.prod(x.shape[1:4])), x.shape[-1], x.element_size(),
                    x.data_ptr() % 16 == 0)["blocks"]
                twice = sig == largest_in
            elif name == "in_apply":
                row[f"blocks_{dn}"] = nm.in_apply_plan(
                    x.shape[0], int(np.prod(x.shape[1:4])), x.shape[-1], x.element_size(),
                    x.data_ptr() % 16 == 0)["blocks"]
            elif name == "in_backward":  # every shape rerun for the same bits
                twice = True
            elif name == "conv3d_wgrad":  # every shape rerun for the same bits
                row[f"plan_{dn}"] = wgrad_plan_row(a, b, ks, st)
                row[f"routes_{dn}"] = list(cv.wgrad_routes(a, b))
                twice = True
            else:
                plan = _conv_plan(name, sig, dtype)
                row[f"splits_{dn}"] = plan["splits"]
                row[f"plan_{dn}"] = {
                    "tile": "flat" if plan["flat"] else list(plan["tile"]),
                    "box": list(plan["box"]), "slab": plan["widths"],
                    "tma": plan["tma"], "phase_loop": plan["phase_loop"], "bn": plan["bn"],
                    "units": plan["units"], "grid": plan["grid"], "smem": plan["smem"]}
                twice = (row[f"splits_{dn}"] > 1 or (name, dn) not in splitting) \
                    and (name, dn) not in bit_checked
            if twice:
                again = run()
                torch.cuda.synchronize()
                if name == "conv3d_pair":
                    again = torch.cat(again[::-1], -1)
                if name == "in_backward":
                    again = again[0] if torch.equal(again[1], first_sums) else None
                if again is None or not torch.equal(got, again):
                    raise AssertionError(f"{name} {dn} {sig}: two runs on the same inputs "
                                         "differ")
                row[f"bit_equal_{dn}"] = True
                bit_checked.add((name, dn))
        rows[name].append(row)
    want = {(n, _dn(d)) for n in bit_kernels if n in rows for d in dtypes}
    if rerun and want - bit_checked:
        raise AssertionError(f"no shape checked for determinism: {want - bit_checked}")
    return rows


def phase_se_tail(smi):
    """K8 against its twins at every SE output shape of the served models'
    forwards (cfg1, prob, prob_dense: ``port_support.trace_se_shapes``) at
    the serving batch, in bf16 and fp32: the apply bit for bit, unmasked
    and masked at each keep of SE_KEEPS, given the same gate; the mean
    within SE_MEAN_TOL of the twin's (torch's fp32 mean) and a second run's
    bits. Returns the largest mean error by dtype."""
    import torch
    from prostatemr_3d_cad_cspca_tpu_torch.ops import normalization as nm
    from prostatemr_3d_cad_cspca_tpu_torch.ops import se_tail as k8

    per_model = {name: trace_se_shapes(cfg, BATCH)
                 for name, cfg in (("cfg1", CFG1), ("prob", PROB), ("prob_dense", PROB_DENSE))}
    gen = torch.Generator(device="cuda").manual_seed(4321)
    rows, worst = [], {}
    for shape in sorted(set().union(*per_model.values())):
        row = {"shape": list(shape),
               "per_forward": {m: c[shape] for m, c in per_model.items() if shape in c}}
        b, spatial, c = shape[0], int(np.prod(shape[1:4])), shape[-1]
        for dtype in (torch.bfloat16, torch.float32):
            dn = _dn(dtype)
            x = (2 * torch.randn(shape, generator=gen, device="cuda")).to(dtype)
            res = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            s = torch.sigmoid(torch.randn((b, 1, 1, 1, c), generator=gen,
                                          device="cuda")).to(dtype)
            u = torch.rand(shape, generator=gen, device="cuda")
            for keep in SE_KEEPS:
                uu, kk = (None, 1.0) if keep is None else (u, keep)
                got, want = k8.se_tail(x, s, res, uu, kk), k8.se_tail_plain(x, s, res, uu, kk)
                if not torch.equal(got, want):
                    raise AssertionError(f"se_tail {dn} {shape} keep {keep}: "
                                         f"{int((got != want).sum())} elements off the twin")
            mean, ref = k8.se_mean(x), k8.se_mean_plain(x)
            scale = x.float().abs().mean(dim=(1, 2, 3), keepdim=True)
            err = float(((mean - ref).abs() / scale).max())
            if not err <= SE_MEAN_TOL:
                raise AssertionError(f"se_mean {dn} {shape}: error {err} > {SE_MEAN_TOL}")
            if not torch.equal(mean, k8.se_mean(x)):
                raise AssertionError(f"se_mean {dn} {shape}: two runs on the same inputs "
                                     "differ")
            aligned = x.data_ptr() % 16 == 0
            row[dn] = {"apply_bit_equal": True, "mean_err": err, "mean_bit_equal": True,
                       "blocks": [nm.in_stats_plan(b, spatial, c, x.element_size(),
                                                   aligned)["blocks"],
                                  nm.in_apply_plan(b, spatial, c, x.element_size(),
                                                   aligned)["blocks"]]}
            worst[dn] = max(worst.get(dn, 0.0), err)
        rows.append(row)
    emit({"phase": "kernels_se_tail", "card": smi, "batch": BATCH,
          "keeps": [k or 1.0 for k in SE_KEEPS], "mean_tol": SE_MEAN_TOL, "rows": rows})
    return worst


def _splits(name, sig, dtype):
    """K-splits of the kernel at one K1/K2 call in ``dtype``."""
    return _conv_plan(name, sig, dtype)["splits"]


def summarize_kernels(rows, dtypes=DTYPE_NAMES):
    """Per kernel: launches and shapes of one forward, and per dtype the
    largest errors over the forward's shapes."""
    out = {}
    for name, all_rows in rows.items():
        shape_rows = [r for r in all_rows if r["count"]]  # cfg1's forward
        out[name] = dict(launches_per_forward=sum(r["count"] for r in shape_rows),
                         distinct_shapes=len(shape_rows),
                         shapes_checked=len(all_rows))
        for dn in dtypes:
            out[name][dn] = dict(
                max_abs_err=max(r[f"max_abs_err_{dn}"] for r in shape_rows),
                max_err=max(r[f"max_rel_err_{dn}"] for r in shape_rows),
                tol=shape_rows[0][f"tol_{dn}"])
    return out


def train_summary(calls, rows, dtypes=DTYPE_NAMES):
    """Per kernel over one train step (``calls``: its meta trace), from the
    checked rows of each call's shape: launches, distinct shapes and per
    dtype the largest errors."""
    by_sig = {(name, r["sig"]): r for name, rs in rows.items() for r in rs}
    out = {}
    for (name, sig), n in calls.items():
        r = by_sig[(name, sig)]
        o = out.setdefault(name, {"launches_per_step": 0, "distinct_shapes": 0})
        o["launches_per_step"] += n
        o["distinct_shapes"] += 1
        for dn in dtypes:
            d = o.setdefault(dn, {"max_abs_err": 0.0, "max_err": 0.0, "tol": r[f"tol_{dn}"]})
            d["max_abs_err"] = max(d["max_abs_err"], r[f"max_abs_err_{dn}"])
            d["max_err"] = max(d["max_err"], r[f"max_rel_err_{dn}"])
    return out


def wgrad_plan_row(a, b, ks, st):
    """K6's plan of one call, as the wgrad_shapes line gives it: the box's
    tile, the slab, taps a block, tile n, the blocks' tiles (tap groups,
    slabs, channel tiles), the warpgroups' schedule, splits, blocks and
    stages."""
    from prostatemr_3d_cad_cspca_tpu_torch.ops import convolution as cv

    p = cv.wgrad_plan(tuple(a.shape), int(b.shape[-1]), tuple(ks), tuple(st), a.dtype,
                      tuple(r == "tma" for r in cv.wgrad_routes(a, b)))
    return {"tile": "flat" if p["flat"] else list(p["tile"]), "slab": p["width"],
            "taps_a_block": p["tpb"], "bn": p["bn"],
            "units": [p["tap_groups"], p["slabs"], p["n_tiles"]],
            "schedule": "pingpong" if p["pingpong"] else "split", "splits": p["splits"],
            "blocks": p["blocks"], "stages": p["stages"]}


def wgrad_shape_table(calls, rows):
    """K6's train-step shapes: A, B, kernel, strides, calls a step, and per
    dtype the plan and the routes of A and B."""
    return [{"a": r["sig"][0], "b": r["sig"][1], "kernel": r["sig"][2], "strides": r["sig"][3],
             "calls": calls[("conv3d_wgrad", r["sig"])],
             **{f"{k}_{dn}": r[f"{k}_{dn}"] for dn in DTYPE_NAMES for k in ("plan", "routes")}}
            for r in rows]


def phase_wgrad_fp64(calls):
    """fp32 K6 against the fp64 product (its twin in fp64: one cuBLAS matmul
    a tap) at two train-path shapes, per element (|diff| / max(1, |ref|)):
    the deepest (most taps x CA x CB) within FP32_LIMIT, and the longest K,
    level 0's 1x3x3 16 -> 16 (1.02 M rows at batch 2), within
    K6_LEVEL0_FP64_LIMIT (its near-zero results are sums of a million
    products of size ~1, which fp32 sums hold to a few 1e-4 absolute: the
    fp32 twin's own matmul is reported beside it)."""
    import torch
    from prostatemr_3d_cad_cspca_tpu_torch.ops import convolution as cv

    gen = torch.Generator(device="cuda").manual_seed(4322)
    sigs = [s for n, s in calls if n == "conv3d_wgrad"]
    deepest = max(sigs, key=lambda s: (int(np.prod(s[2])) * s[0][-1] * s[1][-1],
                                       int(np.prod(s[1][:4]))))
    longest = max((s for s in sigs if tuple(s[2]) == (1, 3, 3) and s[0][-1] == s[1][-1] == 16),
                  key=lambda s: int(np.prod(s[1][:4])))
    out = []
    for label, sig in (("deepest", deepest), ("level0_1x3x3_16to16", longest)):
        a, b, ks, st = _wgrad_case(sig, torch.float32, gen)
        got = cv.conv3d_wgrad(a, b, ks, st)
        exact = cv.conv3d_wgrad_plain(a.double(), b.double(), ks, st)
        twin = cv.conv3d_wgrad_plain(a, b, ks, st)
        torch.cuda.synchronize()
        scale = max(1.0, float(exact.abs().max()))
        row = {"shape": label, "a": sig[0], "b": sig[1], "kernel": sig[2], "strides": sig[3],
               "kernel_vs_fp64": _errors(got.double(), exact)[1],
               "twin_vs_fp64": _errors(twin.double(), exact)[1],
               "kernel_vs_fp64_of_max": float((got.double() - exact).abs().max()) / scale,
               "twin_vs_fp64_of_max": float((twin.double() - exact).abs().max()) / scale,
               "tol": FP32_LIMIT if label == "deepest" else K6_LEVEL0_FP64_LIMIT}
        emit({"phase": "wgrad_fp32_vs_fp64", **row})
        if not row["kernel_vs_fp64"] <= row["tol"]:
            raise AssertionError(f"fp32 K6 at {label}: {row} from the fp64 product")
        out.append(row)
    return out


def phase_fp64(calls):
    """fp32 K1 at its deepest path shape (most taps x channels) and its
    largest (most output elements, then deepest) against the fp64 product;
    the twin's own error beside it."""
    import torch
    from prostatemr_3d_cad_cspca_tpu_torch.ops import convolution as cv

    gen = torch.Generator(device="cuda").manual_seed(4321)
    sigs = [s for n, s in calls if n == "conv3d"]
    depth = lambda s: int(np.prod(s[1][:4]))  # noqa: E731
    size = lambda s: s[0][0][0] * int(np.prod(  # noqa: E731
        cv.forward_plan(tuple(s[1][:3]), tuple(s[2]), tuple(s[0][0][1:4]))["out"])) * s[1][4]
    out = {}
    for label, sig in (("deepest", max(sigs, key=depth)),
                       ("largest", max(sigs, key=lambda s: (size(s), depth(s))))):
        parts, kernel, bias, st = _conv_case(sig, torch.float32, gen)
        got = cv.conv3d(parts, kernel, bias, st)
        twin = cv.conv3d_plain(parts, kernel, bias, st)
        exact = _conv_fp64(parts, kernel, bias, st)
        torch.cuda.synchronize()
        out[label] = {"parts": sig[0], "kernel": sig[1], "strides": sig[2], "k": depth(sig),
                      "kernel_vs_fp64": _errors(got.double(), exact)[1],
                      "twin_vs_fp64": _errors(twin.double(), exact)[1],
                      "kernel_vs_twin": _errors(got, twin)[1]}
        del parts, kernel, got, twin, exact
    emit({"phase": "fp32_vs_fp64", "tol": FP32_LIMIT, **out})
    for label, r in out.items():
        if not r["kernel_vs_fp64"] <= FP32_LIMIT:
            raise AssertionError(f"fp32 K1 at its {label} shape: {r['kernel_vs_fp64']} "
                                 "from the fp64 product")
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
            transposed = parent.startswith(("convtd", "dec_hi"))
            fan_in = int(np.prod(shape[:3])) * (shape[4] if transposed else shape[3])
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

    return {"conv3d": cv.conv3d, "conv3d_pair": cv.conv3d_pair,
            "conv3d_transpose": cv.conv3d_transpose,
            "in_stats": nm.in_stats, "in_apply": nm.in_apply,
            "gemm_loop": gemm.gemm_loop, "conv3d_wgrad": cv.conv3d_wgrad,
            "in_backward": nm.in_backward}


def reset_counts():
    """Every launch count to 0, just before a path is driven."""
    for fn in counters().values():
        fn.launches = 0


def read_counts():
    return {k: f.launches for k, f in counters().items()}


def forwards(n, dn="bfloat16"):
    """The launch counts of ``n`` cfg1 forwards in dtype ``dn``."""
    return {**{k: v * n for k, v in LAUNCHES_PER_FORWARD[dn].items()}, "gemm_loop": 0,
            **{k: 0 for k in BACKWARD_KERNELS}}


def _serve_requests(session, requests, mc, expect=None, se=None):
    """Serve ``requests`` through ``session``; check each output and that it
    took exactly one forward (``expect``: its launches, default cfg1's;
    ``se``: K8's (applies, masked applies) a request, where given).
    Returns latencies (ms), outputs, launches (with ``se``, also K8's
    ``se_tail`` and ``se_tail_masked``)."""
    import torch
    from prostatemr_3d_cad_cspca_tpu_torch.ops.se_tail import se_tail as k8

    expect = expect or forwards(1)
    latencies, outputs, per_request, se_per_request = [], [], [], []
    reset_counts()
    k8.launches = k8.masked = 0
    for req in requests:
        before = read_counts()
        se_before = (k8.launches, k8.masked)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        probs, unc = session(req)
        torch.cuda.synchronize()
        latencies.append((time.perf_counter() - t0) * 1e3)
        per_request.append({k: v - before[k] for k, v in read_counts().items()})
        se_per_request.append((k8.launches - se_before[0], k8.masked - se_before[1]))
        shape = (len(req[0] if isinstance(req, tuple) else req),
                 *CFG1["input_spatial_dims"], 2)
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
        if got != expect:
            raise AssertionError(f"launches per request {got}, expected {expect}")
    counts = read_counts()
    if se is not None:
        if any(got != tuple(se) for got in se_per_request):
            raise AssertionError(f"K8 (applies, masked) per request {se_per_request}, "
                                 f"expected {tuple(se)}")
        counts.update(se_tail=k8.launches, se_tail_masked=k8.masked)
    return latencies, outputs, counts


def _requests(seed, channels=3):
    rng = np.random.default_rng(seed + 1)
    return [rng.normal(size=(BATCH, *CFG1["input_spatial_dims"], channels)).astype(np.float32)
            for _ in range(REQUESTS)]


def phase_serve(ckpt, seed, smi):
    import torch
    from prostatemr_3d_cad_cspca_tpu_torch.models.m1 import M1
    from prostatemr_3d_cad_cspca_tpu_torch.serve import InferenceSession

    session = InferenceSession(M1.load(ckpt, dtype=torch.bfloat16, device="cuda"),
                               device="cuda")
    requests = _requests(seed)
    _, _, launches = _serve_requests(session, requests, mc=False, se=(8, 0))
    emit({"phase": "serve", "card": smi, "dtype": "bfloat16", "batch": BATCH,
          "requests": REQUESTS, "launches": launches,
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
    _, outputs, launches = _serve_requests(session(ckpt), requests, mc=True, se=(8, 8))
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
    emit({"phase": "serve_mc", "card": smi, "dtype": "bfloat16", "batch": BATCH,
          "mc_iter": MC_ITER, "dropout": ["monte-carlo", 0.5], "requests": REQUESTS,
          "launches": launches,
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
    if launches != forwards(SW_FORWARDS, "float32"):
        raise AssertionError(f"sliding-window launches {launches}, expected "
                             f"{forwards(SW_FORWARDS, 'float32')}")
    cpu = serve.main(["--MODEL", det_ckpt, "--MANIFEST", manifest, "--OUTPUT_DIR",
                      os.path.join(tmp, "det_cpu"), "--DEVICE", "cpu"])
    diff = float(np.abs(np.load(card[0]["detection_path"])
                        - np.load(cpu[0]["detection_path"])).max())
    window = np.random.default_rng(seed + 4).normal(
        size=(8, *CFG1["input_spatial_dims"], 3)).astype(np.float32)
    phase_profile(members[0], window, mc_iter=2, path="serve_sw", dtype=torch.float32)
    emit({"phase": "serve_sw", "card": smi, "dtype": "float32",
          "cases": [list(SW_CASE)] * 2, "tiles_per_case": 18, "mc_iter": 2, "tta": 1,
          "members": 2, "seconds": seconds, "seconds_per_case": seconds / 2,
          "voxels_below_blend_floor": int(floored.sum()),
          "det_case": list(SW_DET_CASE), "det_case_seconds": det_seconds,
          "det_card_vs_cpu_max": diff, "launches": launches, "peak_mem_gib": peak})
    if not diff <= 1e-3:
        raise AssertionError(f"sliding window card vs CPU differs by {diff}")
    return launches


def phase_gemm():
    """K5 at the probe's 8 (shape, iterations): checked against its twin
    with a few iterations and with the probe's count, run twice where the
    plan splits a tile (the same bits)."""
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
        row.update({"split": plan["split"], "blocks": plan["blocks"], "splits": plan["splits"],
                    "units": len(gemm.plan_units(plan))})
        rows.append(row)
    if not any(r.get("bit_equal") for r in rows):
        raise AssertionError("no split K5 case checked for determinism")
    return dict(launches_per_pass=len(rows), distinct_shapes=len(rows),
                bfloat16=dict(max_abs_err=max(max(r["max_abs_err_check"],
                                                  r["max_abs_err_full"]) for r in rows),
                              max_err=max(max(r["max_rel_err_check"], r["max_rel_err_full"])
                                          for r in rows), tol=BF16_ULP)), rows


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
    (batch 2 x mc 4; bf16 as served, and fp32), serve_sw (2 cases x 4
    tiles x mc 2, fp32), serve_prob (batch 2 x mc 4, bf16) and
    serve_cascade's whole-gland (4 tiles, fp32) forwards."""
    import torch

    out = {}
    for name, cfg, batch, dtype in (
            ("serve_mc", CFG1, BATCH * MC_ITER, torch.bfloat16),
            ("serve_mc", CFG1, BATCH * MC_ITER, torch.float32),
            ("serve_sw", CFG1, 2 * 4 * 2, torch.float32),
            ("serve_prob", PROB, BATCH * MC_ITER, torch.bfloat16),
            ("serve_cascade", CASCADE, 4, torch.float32)):
        calls = (trace_path_calls(batch, dtype) if cfg is CFG1
                 else trace_model_calls(cfg, batch, dtype))
        rows = phase_kernels(calls, dtypes=(dtype,), rerun=False)
        dn = _dn(dtype)
        out[f"{name}.{dn}"] = {k: {"shapes": len(v),
                                   "max_rel_err": max(r[f"max_rel_err_{dn}"] for r in v)}
                               for k, v in rows.items()}
    emit({"phase": "paths", "batch_checks": out})


# ------------------------------------------------------------- model paths
def _card_vs_cpu(ckpt, x, rng=None):
    """The detect head in fp32 on the card and on the CPU (plain twins),
    and in bf16 on the card, on the same input (and replayed draws): (max
    |fp32 card - cpu| over every output, bf16-vs-fp32 |diff| mean, max)."""
    import torch
    from prostatemr_3d_cad_cspca_tpu_torch.models.m1 import M1

    def run(device, dtype=None):
        out = M1.load(ckpt, device=device, dtype=dtype).predict(x, rng=rng)
        outs = out if isinstance(out, tuple) else (out,)
        return [o.float().cpu().numpy() for o in outs]

    card, cpu, card16 = run("cuda"), run("cpu"), run("cuda", torch.bfloat16)
    fp32 = max(float(np.abs(a - b).max()) for a, b in zip(card, cpu))
    d16 = np.concatenate([np.abs(a - b).ravel() for a, b in zip(card16, card)])
    if not all(np.isfinite(a).all() for a in card + cpu + card16):
        raise AssertionError("detect output is not finite")
    return fp32, float(d16.mean()), float(d16.max())


def _check_parity(name, fp32, d16_mean):
    if not fp32 <= 1e-3:
        raise AssertionError(f"{name}: fp32 card vs CPU differs by {fp32}")
    if not d16_mean <= 1e-2:
        raise AssertionError(f"{name}: bf16 vs fp32 mean difference {d16_mean}")


def _serve_model_path(name, ckpt, requests, smi, mc_iter=1, seed=0):
    """Requests through a bf16 session of ``ckpt``, each launching exactly
    one traced detect forward; then one profiled request."""
    import torch
    from prostatemr_3d_cad_cspca_tpu_torch.models.m1 import M1
    from prostatemr_3d_cad_cspca_tpu_torch.serve import InferenceSession

    cfg = MODEL_PATHS[name]
    expect = launch_counts(trace_model_calls(cfg, BATCH * mc_iter))
    torch.cuda.reset_peak_memory_stats()
    session = InferenceSession(M1.load(ckpt, dtype=torch.bfloat16, device="cuda"),
                               mc_iter=mc_iter, seed=seed, device="cuda")
    _, outputs, launches = _serve_requests(session, requests, mc_iter > 1, expect)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    phase_profile(ckpt, requests[0], mc_iter=mc_iter, path=name)
    result = {"card": smi, "dtype": "bfloat16", "batch": BATCH, "requests": REQUESTS,
              "launches": launches,
              "launches_per_request": expect, "peak_mem_gib": peak}
    return result, outputs, launches


def phase_serve_cfg2(tmp, seed, smi):
    """Bench cfg2 (dense skips + deep supervision) at cfg1 width: bf16
    requests; fp32 card vs CPU and bf16 vs fp32 on one volume."""
    ckpt = os.path.join(tmp, "cfg2.npz")
    write_cfg1_checkpoint(ckpt, seed, **CFG2)
    requests = _requests(seed)
    result, _, launches = _serve_model_path("serve_cfg2", ckpt, requests, smi)
    fp32, d16_mean, d16_max = _card_vs_cpu(ckpt, requests[0][:1])
    emit({"phase": "serve_cfg2", **result, "fp32_card_vs_cpu_max": fp32,
          "bf16_vs_fp32_card_mean": d16_mean, "bf16_vs_fp32_card_max": d16_max})
    _check_parity("serve_cfg2", fp32, d16_mean)
    return launches


def dropout_shapes(net, forward, key=lambda site: site):
    """The shape at each dropout site that ``forward()`` (a meta forward of
    ``net``) reaches, under ``key(site)``. Each dropout follows an SE block,
    which is handed it (its third argument, ``drop``) and applies it, on the
    block's output: a hook on the blocks sees every site, whether the
    dropout runs as its own ops or inside K8."""
    from prostatemr_3d_cad_cspca_tpu_torch.models.blocks import SEResNetBottleNeck

    shapes = {}

    def hook(_m, args, out):
        if len(args) > 2 and args[2] is not None:
            shapes[key(args[2][0].site)] = tuple(out.shape)

    hooks = [m.register_forward_hook(hook) for m in net.modules()
             if isinstance(m, SEResNetBottleNeck)]
    try:
        forward()
    finally:
        for h in hooks:
            h.remove()
    return shapes


def prob_detect_draws(cfg, batch, seed):
    """Every draw of one detect forward of the probabilistic model ``cfg``
    at ``batch``, made by numpy on the host: the prior trunk's and the
    sampling ladder's keep-masks and the ladder's latents, under the paths
    ``prng`` names (fused passes)."""
    import torch
    from prostatemr_3d_cad_cspca_tpu_torch.models.m1 import M1

    model = M1(**cfg, summary=False, init_params=False, device="meta")
    prior, dims = model.net.prior, model.net.prior.prob_latent_dims
    latents, hooks = {}, []
    for name, mod in prior.named_modules():
        if name.startswith("mu_logsig_") and "." not in name:
            hooks.append(mod.register_forward_hook(
                lambda _m, _i, out, key=f"p_sample/z_{name[-1]}":
                    latents.update({key: tuple(out.shape)})))
    x = torch.zeros((batch, *cfg["input_spatial_dims"], cfg["input_channels"]), device="meta")

    def forward():
        with torch.no_grad():
            model.net.detect(x, rng=torch.Generator().manual_seed(0))

    try:
        shapes = dropout_shapes(
            prior, forward,
            key=lambda site: f"{'p_sample' if site.startswith('dropp') else 'prior'}/{site}")
    finally:
        for h in hooks:
            h.remove()
    shapes.update(latents)
    rng = np.random.default_rng(seed)
    draws = {}
    for key, shape in sorted(shapes.items()):
        if "/z_" in key:
            d = dims[int(key[-1])]
            draws[key] = rng.standard_normal((*shape[:-1], d)).astype(np.float32)
        else:
            draws[key] = rng.random(shape) < 1.0 - cfg["dropout_rate"]
    return draws


def phase_serve_prob(tmp, seed, smi):
    """The reference README's probabilistic model: bf16 MC requests, the
    same seed the same bits, std >= 0 and > 0 somewhere; fp32 card vs CPU
    of one forward with host-drawn masks and latents replayed on both."""
    import torch
    from prostatemr_3d_cad_cspca_tpu_torch.models.m1 import M1
    from prostatemr_3d_cad_cspca_tpu_torch.serve import InferenceSession

    ckpt = os.path.join(tmp, "prob.npz")
    write_cfg1_checkpoint(ckpt, seed, **PROB)
    requests = _requests(seed, channels=PROB["input_channels"])
    result, outputs, launches = _serve_model_path("serve_prob", ckpt, requests, smi,
                                                  mc_iter=MC_ITER, seed=seed)
    probs, std = outputs[0]
    if not (float(std.min()) >= 0.0 and float(std.max()) > 0.0):
        raise AssertionError(f"serve_prob: std in [{std.min()}, {std.max()}]")
    again = InferenceSession(M1.load(ckpt, dtype=torch.bfloat16, device="cuda"),
                             mc_iter=MC_ITER, seed=seed, device="cuda")(requests[0])
    if not (np.array_equal(again[0], probs) and np.array_equal(again[1], std)):
        raise AssertionError("serve_prob: the same seed gave other outputs")
    draws = prob_detect_draws(PROB, 1, seed + 7)
    fp32, d16_mean, d16_max = _card_vs_cpu(ckpt, requests[0][:1], rng=draws)
    emit({"phase": "serve_prob", **result, "mc_iter": MC_ITER,
          "prob_latent_dims": list(PROB["prob_latent_dims"]),
          "std_max": float(std.max()), "std_mean": float(std.mean()),
          "replayed_draws": len(draws), "fp32_card_vs_cpu_max": fp32,
          "bf16_vs_fp32_card_mean": d16_mean, "bf16_vs_fp32_card_max": d16_max})
    _check_parity("serve_prob", fp32, d16_mean)
    return launches


def phase_serve_cascade(tmp, seed, smi):
    """The cascade (noisy-or): bf16 requests of two-exam volumes; serve.run
    on one whole-gland two-exam case (image_path_2, fp32); fp32 card vs
    CPU of one window."""
    import torch
    from prostatemr_3d_cad_cspca_tpu_torch import serve

    ckpt = os.path.join(tmp, "cascade.npz")
    write_cfg1_checkpoint(ckpt, seed, **CASCADE)
    first, second = _requests(seed), _requests(seed + 10)
    requests = list(zip(first, second))
    result, _, launches = _serve_model_path("serve_cascade", ckpt, requests, smi)

    rng = np.random.default_rng(seed + 5)
    paths = []
    for col in ("image_path", "image_path_2"):
        paths.append(os.path.join(tmp, f"cascade_{col}.npy"))
        np.save(paths[-1], rng.normal(size=(*CASCADE_CASE, 3)).astype(np.float32))
    manifest = os.path.join(tmp, "cascade.csv")
    with open(manifest, "w") as f:
        f.write(f"p-id,image_path,image_path_2\ngland,{paths[0]},{paths[1]}\n")
    from prostatemr_3d_cad_cspca_tpu_torch.infer import _tile_starts

    tiles = int(np.prod([len(_tile_starts(f, w, 0.5)) for f, w in
                         zip(CASCADE_CASE, CFG1["input_spatial_dims"])]))
    chunks = -(-tiles // 4)  # the sliding window's chunks of 4 tiles
    expect = launch_counts(trace_model_calls(CASCADE, 4, torch.float32), chunks)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = serve.main(["--MODEL", ckpt, "--MANIFEST", manifest, "--OUTPUT_DIR",
                      os.path.join(tmp, "cascade_out"), "--DEVICE", "cuda"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    sw_launches = read_counts()
    det = np.load(out[0]["detection_path"])
    floored = blend_weight(CASCADE_CASE, CFG1["input_spatial_dims"]) < 1e-8
    if det.shape != (*CASCADE_CASE, 2) or not np.isfinite(det).all() \
            or float(np.abs(det.sum(-1)[~floored] - 1.0).max()) > 1e-4:
        raise AssertionError(f"serve_cascade whole gland: output {det.shape} not a "
                             "finite softmax")
    if sw_launches != expect:
        raise AssertionError(f"serve_cascade whole gland: launches {sw_launches}, "
                             f"expected {expect}")
    fp32, d16_mean, d16_max = _card_vs_cpu(ckpt, (first[0][:1], second[0][:1]))
    emit({"phase": "serve_cascade", **result, "fusion": CASCADE["cascaded"],
          "gland_case": list(CASCADE_CASE), "gland_tiles": tiles, "gland_dtype": "float32",
          "gland_seconds": seconds, "gland_launches": sw_launches,
          "fp32_card_vs_cpu_max": fp32, "bf16_vs_fp32_card_mean": d16_mean,
          "bf16_vs_fp32_card_max": d16_max})
    _check_parity("serve_cascade", fp32, d16_mean)
    return launches


# ---------------------------------------------------------------- export
def phase_export(tmp, seed, smi, det_ckpt):
    """The export slice on the card: the CLI's MC checkpoint (serve_mc's,
    monte-carlo 0.5) frozen by export.main at MC 4 in bf16 and validated;
    serve.run from the artifact on two window cases; 3 requests of 2
    volumes through ExportedSession (one cfg1 forward each, the live
    session's bits for the same seed); one artifact request profiled; a
    sliding-window artifact against the live session; a CPU-traced artifact
    on the card."""
    import io

    import torch
    from prostatemr_3d_cad_cspca_tpu_torch import export, serve
    from prostatemr_3d_cad_cspca_tpu_torch.models.m1 import M1
    from torch.profiler import ProfilerActivity, profile

    ckpt = os.path.join(tmp, "cfg1_mc.npz")  # phase_serve_mc's checkpoint
    art = os.path.join(tmp, "cfg1_mc.zip")
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        export.main(["--MODEL", ckpt, "--OUT", art, "--MC_ITER", str(MC_ITER),
                     "--DTYPE", "bfloat16", "--DEVICE", "cuda"])
    main_s = time.perf_counter() - t0
    print(log.getvalue(), end="", flush=True)
    export_s = float(re.search(r"MB in ([\d.]+) s", log.getvalue()).group(1))
    validated = float(re.search(r"max \|diff\| ([-+.\de]+)", log.getvalue()).group(1))
    if not validated <= 1e-4:
        raise AssertionError(f"export: validated at {validated}")

    # the main path: serve.run from the artifact, then ExportedSession requests
    manifest = _write_cases(tmp, "export_win", [CFG1["input_spatial_dims"]] * 2, seed + 60)
    requests = _requests(seed)
    reset_counts()
    results = serve.main(["--MODEL", art, "--MANIFEST", manifest, "--OUTPUT_DIR",
                          os.path.join(tmp, "export_out"), "--SEED", str(seed),
                          "--DEVICE", "cuda"])
    run_launches = read_counts()
    if run_launches != forwards(1):
        raise AssertionError(f"serve.run from the artifact launched {run_launches}")
    for r in results:
        det, unc = np.load(r["detection_path"]), np.load(r["uncertainty_path"])
        if not (det.shape == unc.shape == (*CFG1["input_spatial_dims"], 2)
                and np.isfinite(det).all() and float(unc.min()) >= 0.0):
            raise AssertionError(f"serve.run from the artifact: {r}")
    session = serve.ExportedSession(export.ExportedModel.load(art, seed=seed, device="cuda"))
    _, outputs, launches = _serve_requests(session, requests, mc=True, se=(8, 8))
    launches = {k: v + run_launches.get(k, 0) for k, v in launches.items()}

    live = serve.InferenceSession(M1.load(ckpt, dtype=torch.bfloat16, device="cuda"),
                                  mc_iter=MC_ITER, seed=seed, device="cuda")
    for (gm, gs), req in zip(outputs, requests):
        lm, ls = live(req)
        if not (np.array_equal(gm, lm) and np.array_equal(gs, ls)):
            raise AssertionError("the artifact and the live session gave other bits "
                                 "for the same seed")

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        session(requests[0])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t1) * 1e6
    busy, by_name, events = device_time(prof)
    missing = [k for k in ("conv3d_wgmma_kernel", "in_stats_kernel", "in_apply_kernel",
                           *SE_KERNEL_NAMES) if k not in by_name]
    if missing:
        raise AssertionError(f"export: the artifact's profile shows no {missing}")

    # a deterministic fp32 artifact with a whole-gland sliding-window program
    sw_art = os.path.join(tmp, "cfg1_sw.zip")
    det = M1.load(det_ckpt, device="cuda")
    t2 = time.perf_counter()
    export.export_model(det, sw_art, sw_shapes=[SW_CASE])
    sw_export_s = time.perf_counter() - t2
    vols = [np.random.default_rng(seed + 61 + i).normal(size=(*SW_CASE, 3)).astype(np.float32)
            for i in range(2)]
    sw_model = export.ExportedModel.load(sw_art, device="cuda")
    reset_counts()
    got = sw_model.predict_cases(vols)
    sw_launches = read_counts()
    want = serve.InferenceSession(det, device="cuda").predict_cases(vols, group_size=2)
    sw_diff = max(float(np.abs(g[0] - w[0]).max()) for g, w in zip(got, want))
    if sw_launches != forwards(5, "float32") or not sw_diff <= 1e-4:
        raise AssertionError(f"export: sliding window {sw_diff} from the live session, "
                             f"launches {sw_launches}")

    # a tiny artifact traced on the CPU, run on the card
    tiny = M1(**EXPORT_TINY, device="cpu", seed=seed)
    tiny_art = os.path.join(tmp, "tiny_cpu.zip")
    export.export_model(tiny, tiny_art)
    moved = export.ExportedModel.load(tiny_art, device="cuda")
    x = np.random.default_rng(seed + 62).normal(
        size=(2, *EXPORT_TINY["input_spatial_dims"], 3)).astype(np.float32)
    from prostatemr_3d_cad_cspca_tpu_torch.ops.se_tail import se_tail as k8

    reset_counts()
    k8.launches = k8.masked = 0
    moved_out = moved.predict(x)
    moved_launches = read_counts()
    moved_se = (k8.launches, k8.masked)  # dropout 0: 8 applies, none masked
    card_out = tiny.to("cuda").predict(x).float().cpu().numpy()
    moved_diff = float(np.abs(moved_out - card_out).max())
    # its K1 pairs are the tiny widths' at the traced (symbolic) batch, taken as 1
    tiny_cfg = {k: v for k, v in EXPORT_TINY.items() if k != "summary"}
    moved_expect = launch_counts(trace_model_calls(tiny_cfg, 1, torch.float32))
    if moved_launches != moved_expect or moved_se != (8, 0) or not moved_diff <= 1e-3:
        raise AssertionError(f"export: a CPU-traced artifact on the card: {moved_diff} from "
                             f"the card's live model, launches {moved_launches}, K8 "
                             f"(applies, masked) {moved_se}")

    emit({"phase": "export", "card": smi, "dtype": "bfloat16", "mc_iter": MC_ITER,
          "batch": BATCH, "export_s": export_s, "export_main_s": main_s,
          "artifact_mb": os.path.getsize(art) / 1e6, "validated_max_abs": validated,
          "draws": len(session.model.meta["draws"]), "launches": launches,
          "profile": {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
                      "device_events": events,
                      "top_ms": {k: v / 1e3 for k, v in by_name.most_common(8)}},
          "sw": {"case": list(SW_CASE), "export_s": sw_export_s,
                 "artifact_mb": os.path.getsize(sw_art) / 1e6, "vs_live_max": sw_diff,
                 "launches": sw_launches},
          "cpu_traced": {"config": "filters 4-24, 4x16x16", "vs_card_live_max": moved_diff,
                         "launches": moved_launches, "se_tail": list(moved_se)}})
    return launches


# ----------------------------------------------------------------- train
class _CaptureOpt:
    """An optimizer that moves nothing and keeps the step's gradients as its
    state (the card-vs-CPU gradient check)."""

    def init(self, params):
        return None

    def update(self, grads, state, params):
        import torch

        return {k: torch.zeros_like(g) for k, g in grads.items()}, grads


def train_batch(seed, batch):
    """A synthetic labelled batch at the cfg1 window: normal images, a
    lesion block in every volume and a few scattered lesion voxels."""
    rng = np.random.default_rng(seed)
    spatial = CFG1["input_spatial_dims"]
    x = rng.normal(size=(batch, *spatial, 3)).astype(np.float32)
    lesion = (rng.random((batch, *spatial)) < 0.01).astype(np.float32)
    lesion[:, 8:12, 60:100, 70:110] = 1.0
    return {"image": x, "detection": np.stack([1.0 - lesion, lesion], -1)}


def train_draws(cfg, batch, seed):
    """The keep-masks of one training forward of ``cfg`` at ``batch``, drawn
    by numpy on the host, under the sites' names (``prng``)."""
    import torch
    from prostatemr_3d_cad_cspca_tpu_torch.models.m1 import M1

    model = M1(**cfg, summary=False, init_params=False, device="meta")
    x = torch.zeros((batch, *cfg["input_spatial_dims"], cfg["input_channels"]), device="meta")

    def forward():
        with torch.no_grad():
            model.net(x, train=True, rng=torch.Generator().manual_seed(0))

    shapes = dropout_shapes(model.net, forward)
    rng = np.random.default_rng(seed)
    return {k: rng.random(v) < 1.0 - cfg["dropout_rate"] for k, v in sorted(shapes.items())}


def _grad_step(ckpt, device, batch, draws, dtype=None, augment=None, out_grads=None):
    """(loss, {leaf: gradient on the host}) of one train step, fp32 unless
    ``dtype`` says otherwise (fp64: the CPU's exact evaluation). With
    ``out_grads`` (a dict), each biased conv's output gradient is noted
    there by module name: its per-channel fp64 L2 norms and sums over the
    batch and voxels, and the number N of terms a channel sums."""
    from prostatemr_3d_cad_cspca_tpu_torch.models.m1 import M1
    from prostatemr_3d_cad_cspca_tpu_torch.ops.convolution import Conv3d
    from prostatemr_3d_cad_cspca_tpu_torch.train import trainer as tt

    model, opt = M1.load(ckpt, device=device, dtype=dtype), _CaptureOpt()
    if out_grads is not None:
        def note(name):
            def keep(g):
                flat = g.double().reshape(-1, g.shape[-1])
                out_grads[name] = (flat.norm(dim=0).cpu(), flat.sum(0).cpu(), flat.shape[0])

            def hook(_mod, _inp, out):  # returns None: the output stays as it is
                out.register_hook(keep)
            return hook

        for name, mod in model.net.named_modules():
            if isinstance(mod, Conv3d) and mod.bias is not None:
                mod.register_forward_hook(note(name))
    state, metrics = tt.make_train_step(model, tt.make_loss(), opt, augment_params=augment)(
        tt.init_train_state(model, opt), batch, draws)
    return float(metrics["loss"]), {k: g.float().cpu() for k, g in state.opt_state.items()}


def zero_grad_bias_ratios(card_g, replay_g, out_grads):
    """Per conv bias whose output feeds an instance norm: the worst channel's
    |card - fp64| over the bound ZERO_BIAS_C * 2**-24 * sqrt(N) * ||dx||_2.

    Such a bias's data gradient is sum_i dx_i over the N = batch x voxels
    terms of the norm's input gradient dx, zero in exact arithmetic (the
    norm's backward removes each channel's mean; the leaf's fp64 value is
    its L2 term, 2 * l2 * bias). The card's fp32 value is the rounding of
    that sum: each term carries the roundings of K7's dx (its fp32
    coefficients and two fused multiply-adds) and its share of the fp32
    reduction, at most ZERO_BIAS_C units of 2**-24 of a term's size, so
    |error| <= ZERO_BIAS_C * u * sum_i |dx_i| <= ZERO_BIAS_C * u * sqrt(N) *
    ||dx||_2 (Cauchy-Schwarz), with dx the fp64 step's. The leaves are found
    by that identity: each channel of the fp64 output gradient sums to 0
    within fp64 rounding."""
    out = {}
    for name, (norm, total, n) in out_grads.items():
        key = f"{name}.bias"
        if not bool((total.abs() <= 1e-10 * n ** 0.5 * norm).all()):
            continue  # not ahead of an instance norm
        bound = ZERO_BIAS_C * 2.0 ** -24 * n ** 0.5 * norm
        err = (card_g[key].double() - replay_g[key].double()).abs()
        out[key] = float((err / bound).max())
    return out


def cli_augment_params():
    """``AugmentParams.from_list`` of the CLI's default --AUGM_PARAMS, parsed
    as the CLI parses it (cli.py:104-107)."""
    from prostatemr_3d_cad_cspca_tpu_torch.augment import AugmentParams

    v = [float(x) for x in AUGM_PARAMS.split(",")]
    return AugmentParams.from_list([v[0], v[1], v[2], v[3], bool(v[4]), v[5], v[6], v[7],
                                    bool(v[8]), (v[9], v[10])])


def augment_draws(params, shape, seed, force=None):
    """One augmentation pass's draws for a batch of ``shape`` (B, D, H, W, C),
    made by numpy on the host under the replay names of ``augment``: the
    gates' and coins' uniforms drawn, or all ``force`` (1.0: every gate on;
    0.0: every gate off), the values drawn in their ranges."""
    import math

    from prostatemr_3d_cad_cspca_tpu_torch.augment import DRAW_NAMES

    p, (B, D, H, W, _), n = params, shape, 3
    rng = np.random.default_rng(seed)

    def uniforms(*dims):
        u = rng.random((B, *dims)).astype(np.float32)
        return u if force is None else np.full_like(u, force)

    d = {k: uniforms() for k in DRAW_NAMES if k == "master" or k.endswith("_on")}
    mh, mw = math.ceil(H * p.translate_factor), math.ceil(W * p.translate_factor)
    ch, cw = math.ceil(H * p.chan_shift_factor), math.ceil(W * p.chan_shift_factor)
    d.update(zoom_scale=rng.integers(H, math.ceil(H * p.zoom_factor), B),
             rot_angle=rng.uniform(-p.rotation_degree, p.rotation_degree, B).astype(np.float32),
             trans_pads=np.stack([rng.integers(0, m, B) for m in (mh, mh, mw, mw)], 1),
             cs_pads=np.stack([rng.integers(0, m, B) for m in (ch, ch, cw, cw)], 1),
             cs_channel=rng.integers(0, 3, B),
             gamma=rng.uniform(*p.gamma_correct, B).astype(np.float32),
             gamma_channel=uniforms(n), poor_channel=uniforms(n),
             noise_std=rng.uniform(0, p.gauss_noise_stddev, B).astype(np.float32),
             noise=rng.standard_normal((B, D, H, W, n), dtype=np.float32))
    return d


def range_device_ms(prof, name):
    """(device ms, kernels) launched inside the ``record_function`` range
    ``name`` of a torch.profiler run, summed over its occurrences."""
    import torch

    def kernels(evt):
        return len(evt.kernels) + sum(kernels(c) for c in evt.cpu_children)

    found = [e for e in prof.events()
             if e.name == name and e.device_type == torch.autograd.DeviceType.CPU]
    return (sum(e.device_time_total for e in found) / 1e3,
            sum(kernels(e) for e in found))


def phase_augment(seed, smi):
    """The CLI's default augmentation at the cfg1 window, batch 2, fp32:
    card vs CPU on replayed draws (every gate on, every gate off); a
    generator run twice under the sync debug mode "error"; its times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from prostatemr_3d_cad_cspca_tpu_torch import augment as ta
    from prostatemr_3d_cad_cspca_tpu_torch import prng
    from prostatemr_3d_cad_cspca_tpu_torch.ops.edt import signed_distance_map

    p = cli_augment_params()
    host = train_batch(seed + 40, 2)
    host["dist_map"] = signed_distance_map(host["detection"][..., 1:])
    cpu = {k: torch.from_numpy(v) for k, v in host.items()}
    card = {k: v.cuda() for k, v in cpu.items()}
    shape = host["image"].shape
    errors = {}
    for label, force in (("gates_on", 1.0), ("gates_off", 0.0)):
        draws = augment_draws(p, shape, seed + 41, force)
        got = ta.augment_batch({k: torch.as_tensor(v).cuda() for k, v in draws.items()},
                               card, p)
        ref = ta.augment_batch({k: torch.as_tensor(v) for k, v in draws.items()}, cpu, p)
        errors[label] = {k: _errors(got[k].cpu(), ref[k])[1] for k in host}
        if force == 0.0 and not all(torch.equal(ref[k], cpu[k]) for k in host):
            raise AssertionError("augment: every gate off changed the batch")
        if force == 1.0 and torch.equal(ref["image"], cpu["image"]):
            raise AssertionError("augment: every gate on left the image as it was")
    worst = max(e for errs in errors.values() for e in errs.values())
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")  # a host sync inside the pass raises
    try:
        a = ta.augment_batch(prng.generator(seed, "cuda"), card, p)
        b = ta.augment_batch(prng.generator(seed, "cuda"), card, p)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    same_bits = all(torch.equal(a[k], b[k]) for k in host)
    label_sum_err = float((a["detection"].sum(-1) - 1.0).abs().max())
    on_card = {k: torch.as_tensor(v, device="cuda")
               for k, v in augment_draws(p, shape, seed + 42, 1.0).items()}
    graph_ms = time_ms(lambda: ta.augment_batch(on_card, card, p), REPS)
    gens = [prng.generator(seed + 100 + i, "cuda") for i in range(REPS + 1)]
    ta.augment_batch(gens[-1], card, p)
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for g in gens[:REPS]:
        ta.augment_batch(g, card, p)
    stop.record()
    torch.cuda.synchronize()
    events_ms = start.elapsed_time(stop) / REPS
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ta.augment_batch(prng.generator(seed + 1, "cuda"), card, p)
        torch.cuda.synchronize()
    range_ms, range_kernels = range_device_ms(prof, "augment")
    device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
              and not _is_range(e) and e.time_range.elapsed_us() > 0]
    emit({"phase": "augment", "card": smi, "batch": shape[0], "shape": list(shape[1:]),
          "params": AUGM_PARAMS, "card_vs_cpu": errors, "card_vs_cpu_worst": worst,
          "tol": AUGMENT_TOL, "generator_same_bits": same_bits,
          "label_sum_err": label_sum_err, "sync_debug": "error",
          "events_ms": events_ms, "graph_ms": graph_ms,
          "profiled_device_ms": sum(e.time_range.elapsed_us() for e in device) / 1e3,
          "profiled_kernels": len(device), "range_device_ms": range_ms,
          "range_kernels": range_kernels})
    if not worst <= AUGMENT_TOL:
        raise AssertionError(f"augment: card vs CPU differs by {errors}")
    if not same_bits:
        raise AssertionError("augment: the same generator seed gave other bits")
    if not label_sum_err <= 1e-5:
        raise AssertionError(f"augment: label channels sum to 1 +- {label_sum_err}")


def write_train_cases(tmp, seed, n):
    """``n`` synthetic labelled cases at the cfg1 window (an .npy image, an
    .npy of lesion grades: a block of grade 2 or 3 and scattered grade-3
    voxels) and their manifest; returns the manifest's path."""
    import csv

    rng = np.random.default_rng(seed)
    spatial = CFG1["input_spatial_dims"]
    rows = []
    for i in range(n):
        img_path = os.path.join(tmp, f"train{i}_image.npy")
        lab_path = os.path.join(tmp, f"train{i}_label.npy")
        np.save(img_path, rng.normal(size=(*spatial, 3)).astype(np.float32))
        grades = np.where(rng.random(spatial) < 0.01, 3.0, 0.0).astype(np.float32)
        grades[8:12, 50 + 5 * i:90 + 5 * i, 70:110] = 2.0 + i % 2
        np.save(lab_path, grades)
        rows.append({"p-id": f"train{i}", "image_path": img_path, "label_path": lab_path})
    path = os.path.join(tmp, "train-fold-0.csv")
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    return path


def profile_step(step, state, batch, rng, names=TRAIN_PROFILE_NAMES):
    """One train step under torch.profiler: (state, wall ms, device busy ms,
    device ms by kernel name, (device ms, kernels) under the "augment"
    range); raises unless every kernel of ``names`` ran."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, batch, rng)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy, by_name, _ = device_time(prof)
    missing = [k for k in names if k not in by_name]
    if missing:
        raise AssertionError(f"train: the profile shows no {missing}")
    return state, wall_us / 1e3, busy / 1e3, by_name, range_device_ms(prof, "augment")


def _timed_steps(steps, state, batches, gen, first):
    """One step of each of ``steps`` in turn on the next batches of
    ``batches``, step i with ``fold_in(gen, first + i)``: (state, losses,
    walls ms, launches a step)."""
    import torch
    from prostatemr_3d_cad_cspca_tpu_torch import prng

    walls, losses, per_step = [], [], []
    for i, step in enumerate(steps):
        bt = next(batches)
        before = read_counts()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, metrics = step(state, bt, prng.fold_in(gen, first + i))
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t1) * 1e3)
        per_step.append({k: v - before[k] for k, v in read_counts().items()})
    return state, losses, walls, per_step


def phase_train(tmp, seed, smi):
    """The CLI's default recipe at cfg1 width (TRAIN_CFG, the default
    augmentation), fp32: one step on the card against the same step on the
    CPU (batch 1, host-drawn keep-masks and augmentation draws replayed on
    both); TRAIN_STEPS augmented Keras-amsgrad steps at batch 2 fed by the
    data layer, then TRAIN_STEPS pairs with augmentation off and on in
    turns, each step launching what a meta trace of the step counts; one
    profiled step; one bf16 step."""
    import torch
    from prostatemr_3d_cad_cspca_tpu_torch import prng
    from prostatemr_3d_cad_cspca_tpu_torch.data import batch_iterator, custom_data_generator
    from prostatemr_3d_cad_cspca_tpu_torch.models.m1 import M1
    from prostatemr_3d_cad_cspca_tpu_torch.train import trainer as tt

    augment = cli_augment_params()
    ckpt = os.path.join(tmp, "train.npz")
    write_cfg1_checkpoint(ckpt, seed, **TRAIN_CFG)
    one, draws = train_batch(seed + 20, 1), train_draws(TRAIN_CFG, 1, seed + 21)
    draws.update({f"augment/{k}": v for k, v in
                  augment_draws(augment, one["image"].shape, seed + 22).items()})
    t0 = time.perf_counter()
    branches = BranchReplay()
    with branches.record():  # the card's branch decisions
        card_loss, card_g = _grad_step(ckpt, "cuda", one, draws, augment=augment)
    cpu_loss, cpu_g = _grad_step(ckpt, "cpu", one, draws, augment=augment)
    _, exact_g = _grad_step(ckpt, "cpu", one, draws, torch.float64, augment=augment)
    out_grads = {}
    with branches.replay():  # fp64 on the card's sides of every kink
        _, replay_g = _grad_step(ckpt, "cpu", one, draws, torch.float64, augment=augment,
                                 out_grads=out_grads)
    parity_s = time.perf_counter() - t0
    loss_rel = abs(card_loss - cpu_loss) / abs(cpu_loss)

    def leaf_err(got, want):
        return {k: float((got[k] - g).abs().max()) / max(1.0, float(g.abs().max()))
                for k, g in want.items()}

    grad_err, card_exact, cpu_exact = (leaf_err(card_g, cpu_g), leaf_err(card_g, exact_g),
                                       leaf_err(cpu_g, exact_g))
    over = sorted((k for k, e in grad_err.items() if e > 1e-3), key=grad_err.get, reverse=True)
    worst = over[0] if over else max(grad_err, key=grad_err.get)

    def l2(got, want):  # every leaf together
        d = sum(float((got[k].double() - want[k].double()).square().sum()) for k in want)
        return (d / sum(float(want[k].double().square().sum()) for k in want)) ** 0.5

    grad_l2 = {"card_vs_cpu": l2(card_g, cpu_g), "card_vs_fp64": l2(card_g, exact_g),
               "cpu_vs_fp64": l2(cpu_g, exact_g),
               "card_vs_replayed_fp64": l2(card_g, replay_g)}
    card_replayed = leaf_err(card_g, replay_g)
    over_replayed = sorted((k for k, e in card_replayed.items() if e > GRAD_REPLAY_TOL),
                           key=card_replayed.get, reverse=True)
    nonzero = {k: e for k, e in card_replayed.items()
               if float(replay_g[k].abs().max()) >= ZERO_GRAD}
    worst_nonzero = max(nonzero, key=nonzero.get)
    zero_bias = zero_grad_bias_ratios(card_g, replay_g, out_grads)
    worst_zero = max(zero_bias, key=zero_bias.get)

    expect = launch_counts(trace_model_calls(TRAIN_CFG, 2, torch.float32, head="train"))
    model = M1.load(ckpt, device="cuda")
    sched = tt.build_schedule("CALR", 1e-3, TRAIN_STEPS_PER_EPOCH, TRAIN_EPOCHS,
                              (2.0, 1.0, 1e-3))
    opt = tt.make_optimizer("adam", sched)
    loss = tt.make_loss("distribution_focal", (1.0, 1.0), 2.0)
    step = tt.make_train_step(model, loss, opt, augment_params=augment, train_obj="lesion")
    plain_step = tt.make_train_step(model, loss, opt)
    state, gen = tt.init_train_state(model, opt), prng.generator(seed, "cuda")
    manifest = write_train_cases(tmp, seed + 30, TRAIN_CASES)
    batches = batch_iterator(custom_data_generator(manifest, train_obj="lesion",
                                                   shuffle_seed=seed), 2, prefetch=2)
    try:
        first = next(batches)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        state, losses, walls, per_step = _timed_steps([step] * TRAIN_STEPS, state, batches,
                                                      gen, 0)
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        # then TRAIN_STEPS pairs in turns (off, on, on, off, ...): the walls
        # with augmentation off and on, compared within one run
        order = [(plain_step, step) if i % 2 == 0 else (step, plain_step)
                 for i in range(TRAIN_STEPS)]
        order = [fn for pair in order for fn in pair]
        state, pair_losses, pair_walls, pair_per_step = _timed_steps(
            order, state, batches, gen, TRAIN_STEPS)
    finally:
        batches.close()
    on_walls = [w for fn, w in zip(order, pair_walls) if fn is step]
    off_walls = [w for fn, w in zip(order, pair_walls) if fn is plain_step]
    state, prof_wall, busy, by_name, (aug_ms, aug_kernels) = profile_step(
        step, state, first, prng.fold_in(gen, 2 * TRAIN_STEPS))
    top = dict(by_name.most_common(12))
    top.update({k: by_name[k] for k in TRAIN_PROFILE_NAMES})

    model16 = M1.load(ckpt, device="cuda", dtype=torch.bfloat16)
    opt16 = tt.make_optimizer("adam", sched)
    reset_counts()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    _, m16 = tt.make_train_step(model16, tt.make_loss(), opt16)(
        tt.init_train_state(model16, opt16), first, prng.fold_in(gen, 99))
    loss16 = float(m16["loss"])
    torch.cuda.synchronize()
    bf16_ms = (time.perf_counter() - t2) * 1e3
    launches16 = read_counts()
    steady = sorted(walls[1:])

    def median(xs):
        xs = sorted(xs)
        return xs[len(xs) // 2]

    emit({"phase": "train", "card": smi, "dtype": "float32", "batch": 2, "steps": TRAIN_STEPS,
          "recipe": "monte-carlo 0.5, focal (1, 1) gamma 2, Keras amsgrad 1e-3 CALR, L2 1e-5, "
                    f"augmentation {AUGM_PARAMS}", "data": "custom_data_generator -> "
          f"batch_iterator(prefetch=2), {TRAIN_CASES} synthetic cases",
          "losses": losses, "step_ms": walls, "median_step_ms_after_first":
          steady[len(steady) // 2], "in_turns": {
              "order": ["on" if fn is step else "off" for fn in order],
              "losses": pair_losses, "on_step_ms": on_walls, "off_step_ms": off_walls,
              "median_on_ms": median(on_walls), "median_off_ms": median(off_walls)},
          "launches_per_step": per_step[-1], "expected_per_step": expect,
          "peak_mem_gib": peak, "profiled_step_wall_ms": prof_wall,
          "profiled_step_device_busy_ms": busy,
          "device_busy_share": busy / prof_wall if prof_wall else None,
          "augment_device_ms": aug_ms, "augment_kernels": aug_kernels,
          "augment_share_of_busy": aug_ms / busy if busy else None,
          "top_ms": {k: v / 1e3 for k, v in sorted(top.items(), key=lambda kv: -kv[1])},
          "card_vs_cpu": {"batch": 1, "replayed_masks": len([k for k in draws
                                                              if "augment/" not in k]),
                          "replayed_augment_draws": len([k for k in draws if "augment/" in k]),
                          "loss_card": card_loss,
                          "loss_cpu": cpu_loss, "loss_rel": loss_rel,
                          "worst_grad_leaf": worst, "worst_grad_err": grad_err[worst],
                          "grad_l2": grad_l2, "leaves": len(grad_err),
                          "n_over_1e-3": len(over), "leaves_over_1e-3": [
                              (k, grad_err[k], card_exact[k], cpu_exact[k]) for k in over[:12]],
                          "worst_card_vs_fp64": max(card_exact.values()),
                          "worst_cpu_vs_fp64": max(cpu_exact.values()),
                          "replayed_sides": {k: len(v) for k, v in branches.sides.items()},
                          "worst_card_vs_replayed_fp64": max(card_replayed.values()),
                          "worst_card_vs_replayed_fp64_leaf": max(card_replayed,
                                                                  key=card_replayed.get),
                          "n_over_1e-3_replayed": len(over_replayed),
                          "worst_nonzero_card_vs_replayed_fp64": (worst_nonzero,
                                                                  nonzero[worst_nonzero]),
                          "nonzero_leaves": len(nonzero),
                          "zero_grad_biases": len(zero_bias),
                          "worst_zero_grad_bias_over_bound": (worst_zero, zero_bias[worst_zero]),
                          "zero_grad_bias_over_bound": dict(sorted(
                              zero_bias.items(), key=lambda kv: -kv[1])[:8]),
                          "leaves_over_1e-3_replayed": [
                              (k, card_replayed[k], float(replay_g[k].abs().max()))
                              for k in over_replayed[:12]],
                          "seconds": parity_s},
          "bf16_loss": loss16, "bf16_step_ms": bf16_ms, "bf16_launches": launches16})
    if not loss_rel <= 1e-4:
        raise AssertionError(f"train: card vs CPU loss differs by {loss_rel} (relative)")
    # fp32 itself is the limit here: at cfg1 with monte-carlo dropout the CPU's
    # fp32 step lies up to ~2e-2 (a deep leaf) from its fp64 evaluation, so a
    # leaf of the card's step is held at GRAD_LEAF_TOL and the gradient as a
    # whole at GRAD_L2_TOL (relative L2); every number is reported
    if not grad_err[worst] <= GRAD_LEAF_TOL:
        raise AssertionError(f"train: card vs CPU gradient {worst} differs by {grad_err[worst]}")
    if not grad_l2["card_vs_cpu"] <= GRAD_L2_TOL:
        raise AssertionError(f"train: card vs CPU gradients differ by {grad_l2} (relative L2)")
    if not (nonzero[worst_nonzero] <= GRAD_REPLAY_TOL
            and grad_l2["card_vs_replayed_fp64"] <= GRAD_REPLAY_L2_TOL):
        raise AssertionError(f"train: card vs branch-replayed fp64: {worst_nonzero} "
                             f"{nonzero[worst_nonzero]}, relative L2 {grad_l2}")
    if not zero_bias[worst_zero] <= 1.0:
        raise AssertionError(f"train: the conv bias {worst_zero} ahead of an instance norm "
                             f"is {zero_bias[worst_zero]}x its rounding bound from fp64")
    if not all(np.isfinite(v) for v in losses + pair_losses + [loss16]):
        raise AssertionError(f"train: losses not finite: {losses}, {pair_losses}, bf16 {loss16}")
    for got in per_step + pair_per_step:
        if got != expect:
            raise AssertionError(f"train: launches per step {got}, expected {expect}")
    expect16 = launch_counts(trace_model_calls(TRAIN_CFG, 2, torch.bfloat16, head="train"))
    if launches16 != expect16:  # bf16 runs more SE blocks as K1 pairs
        raise AssertionError(f"train bf16: launches {launches16}, expected {expect16}")
    if not aug_kernels:
        raise AssertionError("train: the profile shows no kernel under the augment range")
    return launches, launches16


# -------------------------------------------------------------- evaluate
def phase_evaluate(tmp, seed, smi):
    """evaluate.run on the card: a cfg1 checkpoint (fp32, lesion task) on
    EVAL_CASES window-sized labelled cases, two with a lesion; each case's
    probabilities against the CPU path's; the metrics JSON's keys and
    ranges."""
    import torch
    from prostatemr_3d_cad_cspca_tpu_torch import evaluate
    from prostatemr_3d_cad_cspca_tpu_torch.data.manifest import read_manifest
    from prostatemr_3d_cad_cspca_tpu_torch.models.m1 import M1
    from prostatemr_3d_cad_cspca_tpu_torch.train.validation import _case_probs

    ckpt = os.path.join(tmp, "eval.npz")
    write_cfg1_checkpoint(ckpt, seed + 40)
    rng = np.random.default_rng(seed + 41)
    spatial = CFG1["input_spatial_dims"]
    lines = ["p-id,image_path,label_path"]
    for i in range(EVAL_CASES):
        img, lab = os.path.join(tmp, f"eval{i}_img.npy"), os.path.join(tmp, f"eval{i}_lab.npy")
        np.save(img, rng.normal(size=(*spatial, 3)).astype(np.float32))
        label = np.zeros(spatial, np.float32)
        if i < 2:
            label[6:14, 50:90, 60:100] = 3.0  # GGG 3: csPCa
        np.save(lab, label)
        lines.append(f"eval{i},{img},{lab}")
    manifest = os.path.join(tmp, "eval.csv")
    with open(manifest, "w") as f:
        f.write("\n".join(lines) + "\n")
    out = os.path.join(tmp, "eval_metrics.json")
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = evaluate.main(["--MODEL", ckpt, "--MANIFEST", manifest, "--OUTPUT", out,
                             "--DEVICE", "cuda"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counts()
    samples = evaluate._LazySamples(read_manifest(manifest), "lesion", False)
    probs = {}
    for dev in ("cuda", "cpu"):
        detect = M1.load(ckpt, device=dev).get_detect_model()
        from prostatemr_3d_cad_cspca_tpu_torch import prng

        probs[dev] = _case_probs(detect, None, samples, prng.generator(0, dev))[0]
    case_diff = [float(np.abs(a - b).max()) for a, b in zip(probs["cuda"], probs["cpu"])]
    emit({"phase": "evaluate", "card": smi, "dtype": "float32", "cases": EVAL_CASES,
          "metrics": metrics, "seconds": seconds, "case_seconds": seconds / EVAL_CASES,
          "launches": launches, "case_card_vs_cpu_max": case_diff})
    keys = {"auroc", "froc_pauc", "lesion_ap", "dice", "cases"}  # the JAX package's
    if set(metrics) != keys or metrics["cases"] != EVAL_CASES:
        raise AssertionError(f"evaluate: metrics {metrics}")
    if metrics["auroc"] is None or not all(0.0 <= metrics[k] <= 1.0 for k in keys - {"cases"}):
        raise AssertionError(f"evaluate: metrics out of range {metrics}")
    with open(out) as f:
        if json.load(f) != metrics:
            raise AssertionError("evaluate: the metrics file differs from the result")
    if not max(case_diff) <= 1e-3:
        raise AssertionError(f"evaluate: card vs CPU probabilities differ by {case_diff}")
    if launches != forwards(EVAL_CASES, "float32"):
        raise AssertionError(f"evaluate: launches {launches}, expected "
                             f"{forwards(EVAL_CASES, 'float32')}")
    return launches


# ------------------------------------------------------------------- fit
def write_raw_cases(tmp, seed, n, shape=FIT_RAW):
    """``n`` raw labelled cases larger than the window (an .npy image of
    scanner-like intensities, lesion grades with a GGG-2/3 block, zones) and
    their manifest; returns the manifest's path."""
    import csv

    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        paths = [os.path.join(tmp, f"raw{i}_{k}.npy") for k in ("image", "label", "zones")]
        image = (rng.normal(size=(*shape, 3)) * 60.0 + 300.0).astype(np.float32)
        grades = np.zeros(shape, np.uint8)
        if i % 2 == 0:  # every other case without a lesion
            grades[9:14, 50 + 6 * i:95 + 6 * i, 70:115] = 2 + i // 2 % 2
        zones = np.zeros(shape, np.uint8)
        zones[6:18, 40:140, 40:140] = 1
        zones[6:18, 60:120, 60:120] = 2
        for path, arr in zip(paths, (image, grades, zones)):
            np.save(path, arr)
        rows.append({"p-id": f"raw{i}", "image_path": paths[0], "label_path": paths[1],
                     "zones_path": paths[2]})
    path = os.path.join(tmp, "raw.csv")
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    return path


class _FitProbe:
    """Instruments the CLI's run from outside: the step walls (a StepTimer
    round each step fit takes, host clock, no synchronize), the launch
    counts and the time at each metrics event, the checkpoint's save
    (wall on the calling thread) and restore (device synchronized; the
    restored state copied to the host), and each fit's model and history."""

    def __init__(self):
        self.events, self.step_walls, self.saves, self.restores, self.fits = [], [], [], [], []
        self.snapshots = []  # ms of the host snapshot inside each save

    def __enter__(self):
        from prostatemr_3d_cad_cspca_tpu_torch.train import checkpoint, trainer
        from prostatemr_3d_cad_cspca_tpu_torch.utils import profiling

        import torch

        probe = self
        self._saved = [(trainer, "make_train_step", trainer.make_train_step),
                       (trainer, "fit", trainer.fit),
                       (profiling.MetricsLogger, "log", profiling.MetricsLogger.log),
                       (checkpoint.CheckpointManager, "save", checkpoint.CheckpointManager.save),
                       (checkpoint.CheckpointManager, "restore",
                        checkpoint.CheckpointManager.restore),
                       (checkpoint, "_snapshot", checkpoint._snapshot)]
        make_step, fit, log, save, restore, snapshot = (f for _, _, f in self._saved)

        def make_train_step(*a, **kw):
            step = make_step(*a, **kw)

            def timed(*sa, **skw):
                timer = profiling.StepTimer(skip_first=0)
                with timer:
                    out = step(*sa, **skw)
                probe.step_walls.append(timer.stats()["max_s"] * 1e3)
                return out
            return timed

        def fit_(model, *a, **kw):
            history = fit(model, *a, **kw)
            probe.fits.append((model, history))
            return history

        def log_(self_, event, **fields):
            probe.events.append((event, fields.get("epoch"), read_counts(), time.perf_counter()))
            return log(self_, event, **fields)

        def save_(self_, step, state, config=None):
            t0 = time.perf_counter()
            saved = save(self_, step, state, config)
            probe.saves.append({"step": step, "saved": saved,
                                "block_ms": (time.perf_counter() - t0) * 1e3, "manager": self_})
            return saved

        def restore_(self_, state_like=None, device="cuda"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, step = restore(self_, state_like, device)
            torch.cuda.synchronize()
            probe.restores.append({"step": step, "ms": (time.perf_counter() - t0) * 1e3,
                                   "state": host_state(state.params, state.opt_state,
                                                       state.step)})
            return state, step

        def snapshot_(tree):
            t0 = time.perf_counter()
            out = snapshot(tree)
            probe.snapshots.append((time.perf_counter() - t0) * 1e3)
            return out

        for (owner, name, _), fn in zip(self._saved, (make_train_step, fit_, log_, save_,
                                                      restore_, snapshot_)):
            setattr(owner, name, fn)
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self._saved:
            setattr(owner, name, fn)


def host_state(params, opt_state, step):
    """(params, optimizer state, step) of a train state, copied to the host."""
    import torch

    def host(tree):
        if isinstance(tree, dict):
            return {k: host(v) for k, v in tree.items()}
        return tree.detach().cpu().clone() if torch.is_tensor(tree) else tree

    return host(dict(params)), host(opt_state), int(step)


def states_equal(a, b):
    """Bit-equal (params, optimizer state, step) triples from host_state."""
    import torch

    def same(x, y):
        if isinstance(x, dict):
            return set(x) == set(y) and all(same(x[k], y[k]) for k in x)
        if torch.is_tensor(x):
            return torch.is_tensor(y) and x.dtype == y.dtype and torch.equal(x, y)
        return x == y

    return all(same(x, y) for x, y in zip(a, b))


def _epoch_launches(events, start):
    """Per epoch: (epoch, train launches, validation launches) from the
    metrics events' counts; ``start`` the counts before the run."""
    out, before = [], start
    for i, (event, epoch, counts, _) in enumerate(events):
        if event != "epoch":
            continue
        train = {k: v - before[k] for k, v in counts.items()}
        val = None
        if i + 1 < len(events) and events[i + 1][0] == "validation":
            before = events[i + 1][2]
            val = {k: v - counts[k] for k, v in before.items()}
        else:
            before = counts
        out.append((epoch, train, val))
    return out


def _val_seconds(events):
    return [b[3] - a[3] for a, b in zip(events, events[1:])
            if a[0] == "epoch" and b[0] == "validation"]


def phase_fit(tmp, seed, smi):
    """The port's CLI at its own default architecture (cfg1, monte-carlo 0.5,
    focal, Keras amsgrad on CALR, L2 1e-5, the default --AUGM_PARAMS), batch
    2, fp32: raw cases through data.ingest (2 folds), 2 epochs of fold 1
    with validation, npz weights and full-state checkpoints each epoch; a
    resume to 3 epochs from the checkpoint (bit-equal restore, one epoch);
    the completed-fold skip (no launch); the last npz served on the card;
    one bf16 epoch. Each epoch launches what the meta traces count."""
    import contextlib
    import io

    import torch
    from prostatemr_3d_cad_cspca_tpu_torch import cli
    from prostatemr_3d_cad_cspca_tpu_torch.data import ingest
    from prostatemr_3d_cad_cspca_tpu_torch.data.manifest import read_manifest
    from prostatemr_3d_cad_cspca_tpu_torch.models.m1 import M1
    from prostatemr_3d_cad_cspca_tpu_torch.serve import InferenceSession
    from prostatemr_3d_cad_cspca_tpu_torch.train.checkpoint import CheckpointManager

    os.makedirs(os.path.join(tmp, "raw"))
    raw = write_raw_cases(os.path.join(tmp, "raw"), seed + 50, FIT_CASES)
    feed = os.path.join(tmp, "feed")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        written = ingest.main(["--MANIFEST", raw, "--OUTPUT_DIR", feed, "--SIZE",
                               *map(str, CFG1["input_spatial_dims"]), "--FOLDS", "2"])
    ingest_s = time.perf_counter() - t0
    train_rows = read_manifest(os.path.join(feed, "train-fold-1.csv"))
    valid_rows = read_manifest(os.path.join(feed, "valid-fold-1.csv"))
    shapes = {tuple(np.load(r["image_path"]).shape) for r in train_rows + valid_rows}
    if len(written) != 4 or shapes != {(*CFG1["input_spatial_dims"], 3)}:
        raise AssertionError(f"fit: ingest wrote {written}, image shapes {shapes}")

    def args(name, epochs, *extra):
        return ["--TRAIN_OBJ", "lesion", "--NUM_EPOCHS", str(epochs), "--FOLDS", "0",
                "--TRAIN_XLSX_PREFIX", os.path.join(feed, "train-fold-"),
                "--VALID_XLSX_PREFIX", os.path.join(feed, "valid-fold-"),
                "--WEIGHTS_DIR", os.path.join(tmp, "weights") + "/", "--NAME", name,
                "--METRICS_DIR", os.path.join(tmp, "metrics"), "--BATCH_SIZE", "2",
                "--WEIGHTS_MIN_EPOCH", "1", "--STORE_WEIGHTS_PER_N_EPOCHS", "1",
                "--VALIDATE_MIN_EPOCH", "1", "--VALIDATE_PER_N_EPOCHS", "1",
                "--DEVICE", "cuda", *extra]

    def run(argv):
        """cli.main under the probe: (probe, seconds, launches, stdout lines)."""
        out = io.StringIO()
        reset_counts()
        start = read_counts()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with _FitProbe() as probe, contextlib.redirect_stdout(out):
            cli.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t1
        lines = [x for x in out.getvalue().splitlines()
                 if x.startswith(("epoch ", "validation", "Model Weights", "Restored",
                                  "Resume", "Begin"))]
        return probe, seconds, start, read_counts(), lines

    steps = -(-len(train_rows) // 2)

    def expected(dtype):  # an epoch's and its validation's launches (K1 pairs differ by dtype)
        step = launch_counts(trace_model_calls(TRAIN_CFG, 2, dtype, head="train"))
        case = launch_counts(trace_model_calls(TRAIN_CFG, 1, dtype))
        return ({k: steps * step[k] for k in step}, {k: len(valid_rows) * case[k] for k in case})

    expect_epoch, expect_val = expected(torch.float32)
    fold = os.path.join(tmp, "weights", "fit", "F1")
    ckpt_dir = os.path.join(fold, "checkpoints")

    first, first_s, start, after_first, log1 = run(args("fit", 2))
    (model1, hist1), = first.fits
    # what fit ended with, which epoch 2's checkpoint saved
    saved_state = host_state(dict(model1.net.named_parameters()), model1.opt_state,
                             model1.opt_state["count"])
    write_ms = first.saves[-1]["manager"].write_seconds * 1e3  # the last save's write
    alone_ms = []  # the same snapshot outside the loop: no prefetch thread beside it
    from prostatemr_3d_cad_cspca_tpu_torch.train import checkpoint as ckpt_mod

    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt_mod._snapshot({"params": dict(model1.net.named_parameters()),
                            "opt_state": model1.opt_state})
        alone_ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    ckpt_mib = os.path.getsize(os.path.join(ckpt_dir, "2.pt")) / 2 ** 20
    resumed, resumed_s, _, after_resume, log2 = run(args("fit", 3, "--RESUME_TRAIN", "1"))
    (_, hist2), = resumed.fits
    launches = {k: after_first[k] + after_resume[k] for k in after_first}
    skipped, skip_s, _, after_skip, _ = run(args("fit", 3, "--RESUME_TRAIN", "1"))

    npz = os.path.join(fold, "model_weights_003.npz")
    served = M1.load(npz, device="cuda")
    volumes = np.stack([np.load(r["image_path"]) for r in valid_rows[:BATCH]])
    probs, _ = InferenceSession(served)(volumes)
    sum_err = float(np.abs(probs.sum(-1) - 1.0).max())

    bf16, bf16_s, _, launches16, log3 = run(args("fit_bf16", 1, "--PRECISION", "bf16"))
    (_, hist3), = bf16.fits

    per_epoch = {"fit": _epoch_launches(first.events, start)
                 + _epoch_launches(resumed.events, start),
                 "fit_bf16": _epoch_launches(bf16.events, start)}
    restore = resumed.restores[0] if resumed.restores else None
    walls = sorted(first.step_walls[1:])
    emit({"phase": "fit", "card": smi, "dtype": "float32", "batch": 2,
          "recipe": "the CLI's defaults (cfg1 16-256, monte-carlo 0.5, focal (1, 1) gamma 2, "
                    "Keras amsgrad 1e-3 CALR, L2 1e-5, augmentation " + AUGM_PARAMS + ")",
          "ingest": {"raw_cases": FIT_CASES, "raw_shape": list(FIT_RAW), "folds": 2,
                     "seconds": ingest_s, "train_cases": len(train_rows),
                     "valid_cases": len(valid_rows)},
          "steps_per_epoch": steps, "epoch_s": hist1["epoch_time"],
          "losses": hist1["loss"], "lr": hist1["lr"], "val": hist1.get("val"),
          "step_wall_ms": first.step_walls,
          "median_step_wall_ms_after_first": walls[len(walls) // 2] if walls else None,
          "validation_s": _val_seconds(first.events), "run_s": first_s,
          "checkpoint": {"mib": ckpt_mib, "block_ms": [s["block_ms"] for s in first.saves],
                         "snapshot_ms": first.snapshots, "snapshot_alone_ms": alone_ms,
                         "last_write_ms": write_ms, "restore_ms": restore and restore["ms"],
                         "steps_kept": CheckpointManager(ckpt_dir).all_steps()},
          "resumed": {"epoch_s": hist2["epoch_time"], "losses": hist2["loss"],
                      "validation_s": _val_seconds(resumed.events), "run_s": resumed_s,
                      "restored_step": restore and restore["step"],
                      "step_wall_ms": resumed.step_walls},
          "skip": {"run_s": skip_s, "launches": after_skip, "fits": len(skipped.fits)},
          "serve": {"npz": os.path.basename(npz), "shape": list(probs.shape),
                    "softmax_sum_err": sum_err},
          "bf16": {"epoch_s": hist3["epoch_time"], "losses": hist3["loss"],
                   "validation_s": _val_seconds(bf16.events), "run_s": bf16_s},
          "launches": launches, "launches_bf16": launches16,
          "expected_epoch": expect_epoch, "expected_validation": expect_val,
          "log": log1 + log2 + log3})
    for path, epochs in per_epoch.items():
        want = expected(torch.bfloat16) if path == "fit_bf16" else (expect_epoch, expect_val)
        for epoch, train, val in epochs:
            if (train, val) != want:
                raise AssertionError(f"{path} epoch {epoch}: launches {train} + validation "
                                     f"{val}, expected {want[0]} + {want[1]}")
    if [e for e, _, _ in per_epoch["fit"]] != [1, 2, 3] or len(per_epoch["fit_bf16"]) != 1:
        raise AssertionError(f"fit: epochs {per_epoch}")
    if restore is None or restore["step"] != 2 or not states_equal(restore["state"], saved_state):
        raise AssertionError("fit: the resume did not restore epoch 2's saved state bit for bit")
    if len(hist2["loss"]) != 1 or CheckpointManager(ckpt_dir).latest_step() != 3:
        raise AssertionError(f"fit: the resume trained {hist2['loss']}")
    if any(after_skip.values()) or skipped.fits:
        raise AssertionError(f"fit: the completed fold was not skipped: {after_skip}")
    if not (np.isfinite(probs).all() and sum_err <= 1e-4):
        raise AssertionError(f"fit: served probabilities sum to 1 +- {sum_err}")
    losses = hist1["loss"] + hist2["loss"] + hist3["loss"]
    if not all(np.isfinite(v) for v in losses):
        raise AssertionError(f"fit: losses not finite: {losses}")
    return launches, launches16


# ------------------------------------------------------------- parallel
PAR_BATCH = 4                      # volumes a data-parallel request
PAR_SLABS = 2                      # ranks of the spatial meshes
PAR_SW_CASE = (24, 256, 256)       # the sharded forward's whole-gland volume (slab 128)
PAR_STEP_CASE = (20, 160, 160)     # the spatial train step's volume (slab 80 < halo 96)
PAR_FP32_TOL = 1e-5                # DP vs one-device session, fp32, max |diff|
BF16_MEAN_LIMIT = 1e-2             # the bf16 path's network-level limit, mean |diff|
PAR_SPATIAL_TOL, PAR_AGREE = 1e-4, 0.9999  # sharded vs unsharded softmax; argmax agreement
PAR_LOSS_RTOL = 1e-5               # gloo DP step vs one-process step, loss
PAR_PARAMS_L2 = 1e-4               # ... updated parameters (relative L2), kinks replayed
PAR_TIMEOUT_S = 600                # the two gloo ranks, joined


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _params(model):
    return {k: v.detach().clone() for k, v in model.net.named_parameters()}


def _norm(tree):
    return sum(float(v.double().square().sum()) for v in tree.values()) ** 0.5


def _rel_l2(got, want):
    return _norm({k: got[k] - want[k] for k in want}) / _norm(want)


def _scaled_err(got, ref):
    return float((np.abs(got - ref) / np.maximum(1.0, np.abs(ref))).max())


def _dp_serving(ckpt, mc_ckpt, seed, calls):
    """InferenceSession over a one-process mesh of data 2 on cuda:0 twice,
    against the one-device session. Deterministic bf16 (3 requests of 4):
    bit-equal to the one-device session run on each replica's rows (the
    same forwards), and within the bf16 path's limit of the one-device
    session over all 4 (K1's split-K and K3's plans follow the batch, so
    their bf16 rounding does too). fp32 and MC 4 fp32 (the same seed's
    draws) within PAR_FP32_TOL of the one-device session; MC 4 bf16 its
    own bits again for the same seed, another seed's output apart. The
    untimed forwards' kernel calls go to ``calls`` (``recording``)."""
    import torch
    from prostatemr_3d_cad_cspca_tpu_torch.models.m1 import M1
    from prostatemr_3d_cad_cspca_tpu_torch.parallel.mesh import make_mesh
    from prostatemr_3d_cad_cspca_tpu_torch.serve import InferenceSession

    mesh = make_mesh(n_data=2, devices=["cuda:0", "cuda:0"])
    rng = np.random.default_rng(seed + 60)
    requests = [rng.normal(size=(PAR_BATCH, *CFG1["input_spatial_dims"], 3)).astype(np.float32)
                for _ in range(REQUESTS)]
    bf16 = M1.load(ckpt, dtype=torch.bfloat16, device="cuda")
    one = InferenceSession(bf16, device="cuda")
    dp = InferenceSession(bf16, mesh=mesh, device="cuda")
    one_ms, one_out, _ = _serve_requests(one, requests, mc=False, expect=forwards(1))
    dp_ms, dp_out, launches = _serve_requests(dp, requests, mc=False, expect=forwards(2))
    half = PAR_BATCH // 2
    with recording(calls):
        one(requests[0])
        dp(requests[0])
        shards_equal = all(np.array_equal(d[0], np.concatenate([one(r[:half])[0],
                                                                one(r[half:])[0]]))
                           for d, r in zip(dp_out, requests))
        fp32 = M1.load(ckpt, device="cuda")
        f_one, _ = InferenceSession(fp32, device="cuda")(requests[0])
        f_dp, _ = InferenceSession(fp32, mesh=mesh, device="cuda")(requests[0])
        mc32 = M1.load(mc_ckpt, device="cuda")
        m_one = InferenceSession(mc32, mc_iter=MC_ITER, seed=seed, device="cuda")(requests[0])
        m_dp = InferenceSession(mc32, mc_iter=MC_ITER, seed=seed, mesh=mesh,
                                device="cuda")(requests[0])
        mc = M1.load(mc_ckpt, dtype=torch.bfloat16, device="cuda")
        outs = [InferenceSession(mc, mc_iter=MC_ITER, seed=s_, mesh=mesh,
                                 device="cuda")(requests[0]) for s_ in (seed, seed, seed + 1)]
        b_one = InferenceSession(mc, mc_iter=MC_ITER, seed=seed, device="cuda")(requests[0])
    bf16_diff = [np.abs(d[0] - o[0]) for d, o in zip(dp_out, one_out)]
    out = {"bf16_equals_one_device_on_each_shard": bool(shards_equal),
           "bf16_vs_one_device_mean_abs": float(np.mean([d.mean() for d in bf16_diff])),
           "bf16_vs_one_device_max_scaled": max(_scaled_err(d[0], o[0])
                                                for d, o in zip(dp_out, one_out)),
           "fp32_max_abs_err": float(np.abs(f_dp - f_one).max()),
           "mc_fp32_max_abs_err": max(float(np.abs(m_dp[i] - m_one[i]).max()) for i in (0, 1)),
           "mc_bf16_vs_one_device_mean_abs": float(np.abs(outs[0][0] - b_one[0]).mean()),
           "mc_bf16_vs_one_device_max_scaled": _scaled_err(outs[0][0], b_one[0]),
           "mc_same_seed_same_bits": bool(all(np.array_equal(a, b)
                                              for a, b in zip(outs[0], outs[1]))),
           "mc_other_seed_max_diff": float(np.abs(outs[2][0] - outs[0][0]).max()),
           "request_ms": dp_ms, "one_device_request_ms": one_ms,
           "median_request_ms": statistics.median(dp_ms[1:]),
           "median_one_device_request_ms": statistics.median(one_ms[1:])}
    if (not shards_equal or out["bf16_vs_one_device_mean_abs"] > BF16_MEAN_LIMIT
            or out["fp32_max_abs_err"] > PAR_FP32_TOL
            or out["mc_fp32_max_abs_err"] > PAR_FP32_TOL
            or out["mc_bf16_vs_one_device_mean_abs"] > BF16_MEAN_LIMIT):
        raise AssertionError(f"parallel: DP serving differs from one device: {out}")
    if not out["mc_same_seed_same_bits"] or out["mc_other_seed_max_diff"] <= 1e-3:
        raise AssertionError(f"parallel: DP MC draws do not follow the seed: {out}")
    return out, launches


def _train_parts(ckpt, optimizer="adam"):
    """The CLI's default recipe (TRAIN_CFG, its augmentation, Keras amsgrad
    on CALR, focal (1, 1) gamma 2) on a fresh load of ``ckpt``; or with
    ``optimizer="momentum"``, SGD + Nesterov on the same schedule."""
    from prostatemr_3d_cad_cspca_tpu_torch.models.m1 import M1
    from prostatemr_3d_cad_cspca_tpu_torch.train import trainer as tt

    model = M1.load(ckpt, device="cuda")
    sched = tt.build_schedule("CALR", 1e-3, TRAIN_STEPS_PER_EPOCH, TRAIN_EPOCHS,
                              (2.0, 1.0, 1e-3))
    return model, tt.make_optimizer(optimizer, sched), tt.make_loss(
        "distribution_focal", (1.0, 1.0), 2.0)


def _dp_step(ckpt, seed, batch, mesh, optimizer="adam"):
    """One augmented train step of the recipe: (parameters, loss, launches)."""
    import torch
    from prostatemr_3d_cad_cspca_tpu_torch import prng
    from prostatemr_3d_cad_cspca_tpu_torch.train import trainer as tt

    model, opt, loss = _train_parts(ckpt, optimizer)
    step = tt.make_train_step(model, loss, opt, mesh=mesh, augment_params=cli_augment_params(),
                              train_obj="lesion")
    reset_counts()
    _, met = step(tt.init_train_state(model, opt), batch, prng.generator(seed + 41, "cuda"))
    torch.cuda.synchronize()
    return _params(model), float(met["loss"]), read_counts()


def _allreduce_ms(group, numel, reps=10):
    """Device ms of one all-reduce of ``numel`` fp32 on the card: CUDA events
    around ``reps`` calls, after a warm-up, each call synchronized."""
    import torch
    import torch.distributed as dist

    buf = torch.ones(numel, device="cuda")
    dist.all_reduce(buf, group=group)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        dist.all_reduce(buf, group=group)
        stop.record()
        torch.cuda.synchronize()
        times.append((start.elapsed_time(stop), (time.perf_counter() - t0) * 1e3))
    dev = sorted(t[0] for t in times)[reps // 2]
    host = sorted(t[1] for t in times)[reps // 2]
    return dev, host


def _nccl_world1(train_ckpt, seed, calls):
    """One DP train step over an NCCL group of one rank against the step
    without a mesh: bit-equal parameters; the mesh step profiled (the NCCL
    all-reduce, K6 and K7); the all-reduce ms of the gradient's size. The
    mesh step's kernel calls go to ``calls``."""
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile
    from prostatemr_3d_cad_cspca_tpu_torch import prng
    from prostatemr_3d_cad_cspca_tpu_torch.parallel.mesh import make_mesh
    from prostatemr_3d_cad_cspca_tpu_torch.train import trainer as tt

    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh(n_data=1, devices=["cuda:0"])
        batch = train_batch(seed + 40, 2)
        plain_p, plain_loss, _ = _dp_step(train_ckpt, seed, batch, None)
        with recording(calls):
            mesh_p, mesh_loss, launches = _dp_step(train_ckpt, seed, batch, mesh)
        unequal = [k for k in plain_p if not torch.equal(plain_p[k], mesh_p[k])]
        if unequal or plain_loss != mesh_loss:
            raise AssertionError(f"parallel: the NCCL world-1 step differs from the plain "
                                 f"step: loss {mesh_loss} vs {plain_loss}, leaves {unequal[:5]}")
        model, opt, loss = _train_parts(train_ckpt)
        step = tt.make_train_step(model, loss, opt, mesh=mesh,
                                  augment_params=cli_augment_params(), train_obj="lesion")
        state = tt.init_train_state(model, opt)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step(state, batch, prng.generator(seed + 42, "cuda"))
            torch.cuda.synchronize()
        _, by_name, _ = device_time(prof)
        cpu_ops = {e.name for e in prof.events()}
        nccl_ops = sorted(n for n in cpu_ops if "nccl" in n.lower() and "all_reduce" in n)
        nccl_kernels = {k: v / 1e3 for k, v in by_name.items() if "nccl" in k.lower()}
        missing = [k for k in PTXAS_NAMES["conv3d_wgrad"] + PTXAS_NAMES["in_backward"]
                   if k not in by_name]
        if missing or not nccl_ops:
            raise AssertionError(f"parallel: the NCCL step's profile shows no {missing} "
                                 f"(NCCL ops {nccl_ops})")
        n_params = sum(p.numel() for p in model.net.parameters())
        dev_ms, host_ms = _allreduce_ms(mesh.group, n_params)
        return {"bit_equal": True, "loss": mesh_loss, "n_params": n_params,
                "grad_mbytes": n_params * 4 / 1e6, "nccl_ops": nccl_ops,
                "nccl_kernel_ms": nccl_kernels,
                "k6_k7_ms": {k: by_name[k] / 1e3 for k in PTXAS_NAMES["conv3d_wgrad"]
                             + PTXAS_NAMES["in_backward"]},
                "allreduce_device_ms": dev_ms, "allreduce_host_ms": host_ms}, launches
    finally:
        dist.destroy_process_group()


def _core_copy_ms(shapes):
    """Device ms of the contiguous copies of the cores that the sharded
    forward's K3 takes: each (x shape, dtype, narrow) recorded copied from a
    fresh tensor of its shape, 10 copies a shape between CUDA events."""
    import torch

    total = 0.0
    for shape, dtype, (dim, start, length) in shapes:
        x = torch.randn(shape, device="cuda").to(dtype)
        total += time_ms(lambda: x.narrow(dim, start, length).contiguous(), REPS,
                         capture=False)
    return total


def _gloo_rank(rank, port, train_ckpt, det_ckpt, seed, out_dir):
    """One of two gloo ranks that both compute on cuda:0: the DP step at a
    global batch of 2, the gloo all-reduce's ms, spatial_infer_m1 over a
    whole-gland volume in slabs of 128 and a spatial train step whose halo
    spans two slabs; every kernel call of those runs recorded
    (``recording``). Each rank runs the one-process step too, its branch
    decisions recorded (BranchReplay), and the DP step twice: deciding its
    kinks itself, and replaying the one-process step's sides on its rows.
    Rank 0 also runs the one-process references. The DP step is the
    recipe's with SGD in place of Adam: Adam moves each element by about
    lr whatever its gradient, so the conv biases ahead of an instance norm
    (gradient 0 but for rounding) step by lr with the sign of their
    rounding, which two summation orders do not share."""
    import torch
    import torch.distributed as dist
    from prostatemr_3d_cad_cspca_tpu_torch.losses import Focal
    from prostatemr_3d_cad_cspca_tpu_torch.models.m1 import M1
    from prostatemr_3d_cad_cspca_tpu_torch.ops import normalization as nm
    from prostatemr_3d_cad_cspca_tpu_torch.parallel.halo import (
        _halo_geometry, make_spatial_train_step, spatial_infer_m1)
    from prostatemr_3d_cad_cspca_tpu_torch.parallel.mesh import data_rows, make_mesh
    from prostatemr_3d_cad_cspca_tpu_torch.train.trainer import SGDNesterov

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=2,
                            rank=rank)
    res, launches, calls = {}, collections.Counter(), []
    try:
        dp_mesh = make_mesh(n_data=2, devices=["cuda:0"] * 2)
        batch = train_batch(seed + 50, 2)
        branches, flips = BranchReplay(), collections.Counter()
        with branches.record():
            ref_p, ref_loss, _ = _dp_step(train_ckpt, seed, batch, None, "momentum")
        with recording(calls):
            own_p, own_loss, n = _dp_step(train_ckpt, seed, batch, dp_mesh, "momentum")
        launches.update(n)
        with branches.replay_rows(data_rows(dp_mesh, 2), flips):
            params, loss, _ = _dp_step(train_ckpt, seed, batch, dp_mesh, "momentum")
        adam_p, _, _ = _dp_step(train_ckpt, seed, batch, dp_mesh, "adam")
        res["dp"] = {"loss": loss, "own_sides_loss": own_loss, "flips": dict(flips),
                     "replayed_sites": {k: len(v) for k, v in branches.sides.items()}}
        del branches
        if rank == 0:
            start = _params(M1.load(train_ckpt, device="cuda"))
            ref_adam, _, _ = _dp_step(train_ckpt, seed, batch, None, "adam")
            step = {k: ref_p[k] - start[k] for k in start}
            res["dp"].update(one_process_loss=ref_loss,
                             loss_rel=abs(loss - ref_loss) / abs(ref_loss),
                             params_rel_l2=_rel_l2(params, ref_p),
                             update_rel_l2=_rel_l2({k: params[k] - start[k] for k in start},
                                                   step),
                             own_sides_loss_rel=abs(own_loss - ref_loss) / abs(ref_loss),
                             own_sides_params_rel_l2=_rel_l2(own_p, ref_p),
                             update_over_params=_norm(step) / _norm(ref_p),
                             adam_params_rel_l2=_rel_l2(adam_p, ref_adam))
        n_params = sum(v.numel() for v in params.values())
        res["allreduce_device_ms"], res["allreduce_host_ms"] = _allreduce_ms(
            dp_mesh.group, n_params)

        sp_mesh = make_mesh(n_data=1, n_spatial=PAR_SLABS, devices=["cuda:0"] * 2)
        det = M1.load(det_ckpt, device="cuda")
        vol = np.random.default_rng(seed + 70).normal(
            size=(1, *PAR_SW_CASE, 3)).astype(np.float32)
        halo, slab = _halo_geometry(det, PAR_SLABS, PAR_SW_CASE[1], 2, None)
        shapes, orig = [], nm._sharded_instance_norm

        def note_core(x, scale, bias, epsilon, lrelu, sharded):
            h = nm._local_halo(x, sharded)
            shapes.append((tuple(x.shape), x.dtype,
                           (sharded.spatial_axis, h, x.shape[sharded.spatial_axis] - 2 * h)))
            return orig(x, scale, bias, epsilon, lrelu, sharded)

        nm._sharded_instance_norm = note_core
        try:  # warm-up; notes the cores and records the kernel calls
            with recording(calls):
                spatial_infer_m1(det, None, vol, sp_mesh)
        finally:
            nm._sharded_instance_norm = orig
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = spatial_infer_m1(det, None, vol, sp_mesh)
        torch.cuda.synchronize()
        res["spatial"] = {"s_per_case": time.perf_counter() - t0, "halo": halo, "slab": slab,
                          "core_copies": len(shapes), "core_copy_ms": _core_copy_ms(shapes)}
        launches.update(read_counts())
        if rank == 0:
            with torch.no_grad(), recording(calls):
                ref = det.net(torch.as_tensor(vol, device="cuda"))["y_softmax"]
            res["spatial"].update(
                max_abs_err=float((got - ref).abs().max()),
                argmax_agree=float((got.argmax(-1) == ref.argmax(-1)).float().mean()),
                finite=bool(torch.isfinite(got).all()))

        img = np.random.default_rng(seed + 80).normal(size=(1, *PAR_STEP_CASE, 3)).astype(
            np.float32)
        lesion = np.zeros((1, *PAR_STEP_CASE), np.float32)
        lesion[:, 8:12, 60:100, 70:110] = 1.0
        lab = np.stack([1.0 - lesion, lesion], -1)
        focal, tx = Focal((1.0, 1.0), 2.0), SGDNesterov(1e-5, momentum=0.0)
        step = make_spatial_train_step(det, focal, tx, sp_mesh)
        p = {k: v.detach() for k, v in det.net.named_parameters()}
        reset_counts()
        with recording(calls):
            _, _, sloss = step(p, tx.init(p), img, lab)
        launches.update(read_counts())
        res["spatial_step"] = {"loss": float(sloss), "halo": _halo_geometry(
            det, PAR_SLABS, PAR_STEP_CASE[1], 2, None)[0], "slab": PAR_STEP_CASE[1] // PAR_SLABS}
        if rank == 0:
            with torch.no_grad():
                y = det.net(torch.as_tensor(img, device="cuda"), train=True)["y_softmax"]
                ref_loss = float(torch.mean(focal.per_sample_sums(
                    torch.as_tensor(lab, device="cuda"), y)))
            res["spatial_step"].update(unsharded_loss=ref_loss,
                                       loss_rel=abs(float(sloss) - ref_loss) / abs(ref_loss))
        res["launches"] = dict(launches)
        res["calls"] = collections.Counter(calls)
        torch.save(res, os.path.join(out_dir, f"{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _gloo_world(train_ckpt, det_ckpt, seed, out_dir):
    """The two gloo ranks as spawned processes, joined within PAR_TIMEOUT_S
    (killed and failed beyond it); returns their results."""
    import multiprocessing as mp

    import torch

    ctx = mp.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_gloo_rank, args=(r, port, train_ckpt, det_ckpt, seed,
                                                   out_dir)) for r in range(2)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + PAR_TIMEOUT_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    if alive or any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"parallel: the gloo ranks failed (exit codes "
                             f"{[p.exitcode for p in procs]}, {len(alive)} killed)")
    return [torch.load(os.path.join(out_dir, f"{r}.pt"), weights_only=False)
            for r in range(2)]


def phase_parallel(tmp, seed, smi, det_ckpt):
    """Data-parallel serving on a one-process mesh of data 2 (cuda:0 twice);
    the DP train step through an NCCL group of one rank, bit-equal to the
    plain step; two gloo ranks both on cuda:0: the DP step at a global
    batch of 2, halo-sharded whole-gland inference and a multi-hop spatial
    train step. Returns the launches of the counted runs and the kernel
    calls that the runs recorded (``recording``)."""
    train_ckpt = os.path.join(tmp, "parallel_train.npz")
    mc_ckpt = os.path.join(tmp, "parallel_mc.npz")
    write_cfg1_checkpoint(train_ckpt, seed, **TRAIN_CFG)
    write_cfg1_checkpoint(mc_ckpt, seed, dropout_mode="monte-carlo", dropout_rate=0.5)
    t0 = time.perf_counter()
    calls = []
    serving, launches = _dp_serving(det_ckpt, mc_ckpt, seed, calls)
    launches = collections.Counter(launches)
    nccl, n = _nccl_world1(train_ckpt, seed, calls)
    launches.update(n)
    out_dir = os.path.join(tmp, "parallel")
    os.makedirs(out_dir, exist_ok=True)
    ranks = _gloo_world(train_ckpt, det_ckpt, seed, out_dir)
    calls = collections.Counter(calls)
    for r in ranks:
        launches.update(r["launches"])
        calls.update(r["calls"])
    dp, spatial, sstep = ranks[0]["dp"], ranks[0]["spatial"], ranks[0]["spatial_step"]
    emit({"phase": "parallel", "card": smi, "seconds": time.perf_counter() - t0,
          "serving": serving, "nccl_world1": nccl, "gloo_dp_step": dp,
          "gloo_allreduce_device_ms": [r["allreduce_device_ms"] for r in ranks],
          "gloo_allreduce_host_ms": [r["allreduce_host_ms"] for r in ranks],
          "spatial_infer": {**spatial, "s_per_case_ranks": [r["spatial"]["s_per_case"]
                                                            for r in ranks]},
          "spatial_step": {**sstep, "rank_losses": [r["spatial_step"]["loss"]
                                                    for r in ranks]},
          "launches": dict(launches)})
    if dp["loss_rel"] > PAR_LOSS_RTOL or dp["params_rel_l2"] > PAR_PARAMS_L2:
        raise AssertionError(f"parallel: the gloo DP step differs from one process: {dp}")
    if not spatial["finite"] or spatial["max_abs_err"] > PAR_SPATIAL_TOL \
            or spatial["argmax_agree"] < PAR_AGREE:
        raise AssertionError(f"parallel: the sharded forward differs: {spatial}")
    if sstep["loss_rel"] > PAR_LOSS_RTOL or sstep["halo"] <= sstep["slab"]:
        raise AssertionError(f"parallel: the spatial step: {sstep}")
    if len({r["spatial_step"]["loss"] for r in ranks}) != 1:
        raise AssertionError("parallel: the ranks' spatial step losses differ")
    return dict(launches), calls


def phase_parallel_kernels(calls, smi):
    """K1-K4, K6 and K7 against their twins at every distinct (shape,
    dtype) that the parallel phase's runs gave them (``calls``: recorded
    on the card): the sharded forward's slabs and the cores K3 takes, the
    spatial step, the DP step at a rank's batch of 1, the batch-4 and
    MC-stacked sessions and the unsharded whole-gland forward; one split-K
    K1/K2 shape, K3's largest and every K6 and K7 shape rerun for the same
    bits. Also the K1/K2 calls of the batch-4 one-device forward whose
    split-K count differs from the same layer's at a replica's batch of 2,
    and the K3 calls whose blocks a volume differ (the plans follow the
    batch)."""
    import torch
    from prostatemr_3d_cad_cspca_tpu_torch.ops import normalization as nm

    t0 = time.perf_counter()
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        dn = _dn(dtype)
        these = collections.Counter({(n, s): c for (n, s, d), c in calls.items() if d == dn})
        if not these:
            continue
        rows = phase_kernels(these, dtypes=(dtype,), bit_kernels=())
        out[dn] = {k: {"shapes": len(v),
                       "max_rel_err": max(r[f"max_rel_err_{dn}"] for r in v),
                       "max_abs_err": max(r[f"max_abs_err_{dn}"] for r in v),
                       "bit_equal_reruns": sum(bool(r.get(f"bit_equal_{dn}")) for r in v),
                       **({"max_sums_rel_err": max(r[f"sums_rel_err_{dn}"] for r in v),
                           "max_sums_rel_err_vs_fp64": max(
                               (r["sums_rel_err_vs_fp64"] for r in v
                                if "sums_rel_err_vs_fp64" in r), default=None)}
                          if k == "in_backward" else {})}
                   for k, v in rows.items()}
    c2, c4 = (trace_path_calls(b, torch.bfloat16) for b in (PAR_BATCH // 2, PAR_BATCH))

    def layer(n, s):  # a call's shapes without its batch
        return n, tuple(p[1:] for p in ((s[0],) if n == "conv3d_transpose" else s[0])), s[1:]

    splits2 = {layer(n, s): _splits(n, s, torch.bfloat16) for n, s in c2 if n in CONV_KERNELS}
    splits = [(n, s[1], splits2[layer(n, s)], _splits(n, s, torch.bfloat16))
              for n, s in c4 if n in CONV_KERNELS]

    def blocks(b, x):
        return nm.in_stats_plan(b, int(np.prod(x[1:4])), x[-1], 2, True)["blocks"] // b

    k3 = [(s[0][1:], blocks(PAR_BATCH // 2, s[0]), blocks(PAR_BATCH, s[0]))
          for n, s in c4 if n == "in_stats"]
    emit({"phase": "parallel_kernels", "card": smi, "seconds": time.perf_counter() - t0,
          "by_dtype": out,
          "k1_k2_splits_batch2_vs_batch4": [list(x) for x in splits if x[2] != x[3]],
          "k1_k2_calls_same_splits": sum(x[2] == x[3] for x in splits),
          "k3_blocks_a_volume_batch2_vs_batch4": [list(x) for x in k3 if x[1] != x[2]]})


def phase_profile(ckpt, volume, top=12, mc_iter=1, path="serve", dtype=None):
    """One more request of ``path`` (bf16 unless ``dtype`` says otherwise)
    under torch.profiler (outside the counted run): device busy share of
    the request's wall time and device time by kernel name (the ``top``
    names, and always the conv's main kernel, K3's, K4's and K8's two,
    which must have run, and the conv's split-K reduce where the request's own K1/K2
    calls, recorded on its warm-up, split K)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from prostatemr_3d_cad_cspca_tpu_torch.models.m1 import M1
    from prostatemr_3d_cad_cspca_tpu_torch.serve import InferenceSession

    dtype = dtype or torch.bfloat16
    session = InferenceSession(M1.load(ckpt, dtype=dtype, device="cuda"),
                               mc_iter=mc_iter, device="cuda")
    calls = []
    with recording(calls):
        session(volume)  # warm
    torch.cuda.synchronize()
    splits = any(_splits(n, s, getattr(torch, d)) > 1 for n, s, d in calls if n in CONV_KERNELS)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        session(volume)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy, by_name, events = device_time(prof)
    names = profile_kernel_names(splits) + SE_KERNEL_NAMES
    missing = [k for k in names if k not in by_name]
    if missing:
        raise AssertionError(f"{path}: the profile shows no {missing}")
    shown = dict(by_name.most_common(top))
    shown.update({k: by_name[k] for k in names})
    batch = len(volume[0] if isinstance(volume, tuple) else volume)
    emit({"phase": "profile", "path": path, "dtype": _dn(dtype),
          "volumes": batch * mc_iter, "wall_ms": wall_us / 1e3,
          "device_busy_ms": busy / 1e3,
          "device_busy_share": busy / wall_us if wall_us else None,
          "device_events": events,
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
    per_path = {"serve": calls}
    per_path.update({name: trace_model_calls(cfg, BATCH) for name, cfg in MODEL_PATHS.items()})
    per_path["prob_dense"] = trace_model_calls(PROB_DENSE, BATCH)
    for name in ("serve_cfg2", "serve_prob"):  # + deep-supervision heads, posterior
        per_path[f"{name}.forward"] = trace_model_calls(MODEL_PATHS[name], BATCH,
                                                         head="forward")
    every = collections.Counter({key: 0 for c in per_path.values() for key in c})
    every.update(calls)  # a row's count: its calls per cfg1 forward
    rows = phase_kernels(every, per_path=per_path)
    summary = summarize_kernels(rows)
    se_mean_err = phase_se_tail(smi)
    fp64 = phase_fp64(calls)
    summary["gemm_loop"], rows["gemm_loop"] = phase_gemm()
    for name, s in summary.items():
        emit({"kernel": name, "card": smi, **s, "shapes": rows[name]})
    # the train step's calls (its meta trace): the shapes the forward above
    # did not check (the data gradients' K1/K2 calls, K6, K7), then the step
    train_calls = trace_model_calls(TRAIN_CFG, BATCH, torch.float32, head="train")
    checked = {(n, r["sig"]) for n, rs in rows.items() if n in TRAIN_KERNELS for r in rs}
    train_rows = phase_kernels(
        collections.Counter({k: v for k, v in train_calls.items() if k not in checked}),
        per_path={"train": train_calls}, bit_kernels=BACKWARD_KERNELS)
    train_sum = train_summary(train_calls, {n: rows.get(n, []) + train_rows.get(n, [])
                                            for n in TRAIN_KERNELS})
    wgrad64 = phase_wgrad_fp64(train_calls)
    emit({"phase": "wgrad_shapes", "card": smi, "batch": BATCH,
          "rows": wgrad_shape_table(train_calls, train_rows["conv3d_wgrad"])})
    emit({"phase": "train_kernels", "card": smi, "batch": BATCH, "per_step": train_sum,
          "new_shapes": {n: rs for n, rs in train_rows.items()}})

    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "cfg1.npz")
        write_cfg1_checkpoint(ckpt, args.seed)
        launches["serve"], volume = phase_serve(ckpt, args.seed, smi)
        phase_profile(ckpt, volume)
        phase_parity(ckpt, volume)
        launches["serve_mc"] = phase_serve_mc(tmp, args.seed, smi, ckpt)
        launches["export"] = phase_export(tmp, args.seed, smi, ckpt)
        launches["serve_sw"] = phase_serve_sw(tmp, args.seed, smi, ckpt)
        launches["serve_cfg2"] = phase_serve_cfg2(tmp, args.seed, smi)
        launches["serve_prob"] = phase_serve_prob(tmp, args.seed, smi)
        launches["serve_cascade"] = phase_serve_cascade(tmp, args.seed, smi)
        phase_augment(args.seed, smi)
        launches["train"], launches["train_bf16"] = phase_train(tmp, args.seed, smi)
        launches["evaluate"] = phase_evaluate(tmp, args.seed, smi)
        launches["fit"], launches["fit_bf16"] = phase_fit(tmp, args.seed, smi)
        launches["parallel"], par_calls = phase_parallel(tmp, args.seed, smi, ckpt)
        phase_parallel_kernels(par_calls, smi)
    launches["probe"], probe = phase_probe(smi)
    phase_paths()

    kernels = []
    from prostatemr_3d_cad_cspca_tpu_torch.ops import cuda_lib

    # K6 and K7 over one train step in fp32 and in bf16; the others in bf16
    # on their own path, K1-K4 also in fp32 on FP32_PATH
    entries = [(name, dn, on, label, train_sum[name][dn]) for name in BACKWARD_KERNELS
               for dn, on, label in (("float32", "train", name),
                                     ("bfloat16", "train_bf16", f"{name}.bf16"))]
    entries += [(name, dn, KERNEL_INFO[name][2] if dn == "bfloat16" else FP32_PATH,
                 name if dn == "bfloat16" else f"{name}.fp32", s[dn])
                for name, s in summary.items() for dn in DTYPE_NAMES if dn in s]
    for name, dn, on, label, d in entries:
        src, replaces, _ = KERNEL_INFO[name]
        names = {k: k + (MANGLED_TYPE[dn] if name != "gemm_loop" else "")
                 for k in PTXAS_NAMES[name]}
        if name == "conv3d_wgrad" and dn == "float32":
            names[K6_SPLIT_KERNEL] = K6_SPLIT_KERNEL
        n = launches[on][name]
        kernels.append({"name": label, "dtype": dn, "route": "cuda", "source": src,
                        "replaces": replaces, "path": on, "launches": n,
                        "max_abs_err": d["max_abs_err"],
                        "launches_by_path": {p: c[name] for p, c in launches.items() if c[name]},
                        **({"also_replaces": ALSO_REPLACES[name]}
                           if name in ALSO_REPLACES else {}),
                        "ptxas": ptxas_summary(cuda_lib.build_log, names),
                        **({"conv_route": CONV_ROUTE} if name in CONV_KERNELS else {})})
        if n == 0:
            raise AssertionError(f"{name} never launched on the {on} path")
    src, replaces, on = SE_TAIL_INFO
    kernels.append({"name": "se_tail", "dtypes": list(DTYPE_NAMES), "route": "cuda",
                    "source": src, "replaces": replaces, "path": on,
                    "launches": launches[on]["se_tail"],
                    "masked": launches[on]["se_tail_masked"], "apply_vs_twin": "bit-equal",
                    "max_mean_err": se_mean_err,
                    "launches_by_path": {p: c["se_tail"] for p, c in launches.items()
                                         if c.get("se_tail")},
                    "ptxas": ptxas_summary(cuda_lib.build_log,
                                           {f"{k}[{dn}]": k + MANGLED_TYPE[dn]
                                            for k in SE_KERNEL_NAMES for dn in DTYPE_NAMES})})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": smi, "summary": summary, "rows": rows, "fp32_vs_fp64": fp64,
                       "train_summary": train_sum, "train_rows": train_rows,
                       "wgrad_fp32_vs_fp64": wgrad64, "se_mean_err": se_mean_err,
                       "launches": launches, "probe": probe},
                      f, indent=1)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
