"""Whole-gland cases through ``serve.InferenceSession.predict_cases`` over a
fold ensemble (``ensemble.M1Ensemble``) with flip TTA.

Traffic (the workload file): ``cases`` whole-gland volumes of
``case_shape`` drawn from the seed (the host arrays a deployment reads), a
``members``-member ensemble (member m's weights from ``seed + m``),
``mc_iter`` Monte-Carlo samples, sliding windows at ``overlap``, the
session's ``group_size`` cases a sliding-window call. Set-up builds the
members and the session and runs one group (the sliding-window program
and every shape of the window). The window calls ``predict_cases`` on the
group again and again for ``seconds`` (``trace_seconds`` when traced);
only whole calls count.

End to end: ``case_s``, the window over the cases it completed.

The tiles a forward are the program's: set-up counts the forwards of its
warm group and their rows (a forward holds ``mc`` samples of every case's
tiles of one chunk), so the reference and the counts follow whatever the
program chooses.

Check: every case of one group call of the window, drawn from the seed,
against the reference's blend of the same tiles with the same draws, in
fp32.
"""

from __future__ import annotations

import contextlib
import time
import traceback

import numpy as np
import torch

from bench_port.counts.m1 import detect_calls
from bench_port.harness import seeds
from bench_port.harness.session import (Reservoir, build_model, free, host_inputs,
                                        make_weights, model_config, reference_precision)
from bench_port.harness.trace import span
from bench_port.reference import compare, draws, sliding
from bench_port.reference.m1 import to_ncdhw

# what may replace the program: the control (the reference in TF32, in
# the program's place) and the faults the tests plant (in one case of a group)
VARIANTS = ("control", "alter_answer", "nan_answer")


class Cell:
    def __init__(self, cfg, wl, seed, device, variant=None):
        if variant not in (None, *VARIANTS):
            raise ValueError(f"unknown variant {variant!r}")
        self.cfg, self.wl, self.seed, self.device, self.variant = cfg, wl, seed, device, variant
        self.model_cfg = model_config(cfg, None)
        self.mc, self.k = int(wl["mc_iter"]), int(wl["group_size"])
        if int(wl["cases"]) != self.k:
            raise ValueError("the window sends its cases as one group: cases == group_size")

    def setup(self):
        from prostatemr_3d_cad_cspca_tpu_torch.ensemble import M1Ensemble
        from prostatemr_3d_cad_cspca_tpu_torch.serve import InferenceSession

        wl, dev = self.wl, self.device
        self.params = [make_weights(self.cfg, self.model_cfg, self.seed + m, dev)
                       for m in range(int(wl["members"]))]
        members = [build_model(self.model_cfg, p, wl["dtype"], dev) for p in self.params]
        self.session = InferenceSession(M1Ensemble(members), mc_iter=self.mc, seed=self.seed,
                                        tta=True, device=dev)
        if self.variant in ("alter_answer", "nan_answer"):
            self._plant(self.variant)
        shape = (*wl["case_shape"], self.model_cfg["input_channels"])
        self.cases = host_inputs(shape, int(wl["cases"]), seeds.child(self.seed, "cases"), dev)
        self.calls = 0
        self._observe(self._group)
        for _ in range(int(wl["warm"]) - 1):
            self._group()

    def _plant(self, variant):
        """A fault in the last case of each group call's answer."""
        run = self.session._sw_program

        def planted(*a, **kw):
            fn, mult = run(*a, **kw)

            def go(x, rng=None):
                out = fn(x, rng)
                if variant == "nan_answer":
                    out[-1, 0, 0, 0, 1] = float("nan")
                else:
                    out[-1, 0, 0, 0, 1] += 0.25
                return out
            return go, mult
        self.session._sw_program = planted

    def _observe(self, call):
        """Run ``call`` (one group) counting the program's forwards and
        their rows: the chunks a group and the tiles a chunk."""
        s, rows = self.session, []
        detect = s._detect

        def counted(params, x, rng=None):
            rows.append(int(x.shape[0]))
            return detect(params, x, rng=rng)
        s._detect = counted
        try:
            call()
        finally:
            s._detect = detect
        if len(set(rows)) != 1 or rows[0] % (self.mc * self.k):
            raise RuntimeError(f"a group's forwards hold {rows} rows, not mc x cases x tiles")
        self.chunks, self.tile_batch = len(rows), rows[0] // (self.mc * self.k)

    def _group(self):
        out = self.session.predict_cases(self.cases, sw_overlap=float(self.wl["overlap"]),
                                         group_size=self.k)
        self.calls += 1
        return out

    def window(self, seconds, tracer=None):
        wl = self.wl
        if tracer is not None:
            seconds = min(seconds, float(wl["trace_seconds"]))
        keep = Reservoir(1, seeds.child(self.seed, "sample"))
        attempted = failed = done = groups = 0
        with (tracer if tracer is not None else contextlib.nullcontext()):
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < seconds:
                attempted += len(self.cases)
                call = self.calls
                try:
                    with span("bench.group"):
                        out = self._group()
                except Exception:  # noqa: BLE001  (a failed call counts, the run goes on)
                    traceback.print_exc()
                    self.calls += 1
                    failed += len(self.cases)
                    continue
                done += len(out)
                groups += 1
                keep.offer(lambda: (call, out))
            window_s = time.perf_counter() - t0
        return dict(attempted=attempted, failed=failed, done=done, groups=groups,
                    window_s=window_s, sample=keep.items)

    def end_to_end(self, w):
        return {"case_s": w["window_s"] / w["done"] if w["done"] else None}

    def work(self, w):
        """A unit is one forward of the sliding window: a chunk's tiles of
        every case of the group, ``mc`` samples, one view, one member. The
        last chunk is padded with zero-weight copies of the first tile: the
        kernels do that work, the model's FLOPs (``model_share``) do not."""
        from bench_port.reference.sliding import tiles

        window = tuple(self.model_cfg["input_spatial_dims"])
        _, n = tiles(tuple(self.wl["case_shape"]), window, float(self.wl["overlap"]),
                     self.tile_batch)
        per_group = self.chunks * 2 * int(self.wl["members"])
        rows = self.k * self.tile_batch * self.mc
        return {"units": w["groups"] * per_group,
                "model_share": n / (self.chunks * self.tile_batch),
                "calls": detect_calls(self.model_cfg, rows, self.wl["dtype"])}

    def release(self):
        del self.session
        free(self.device)

    def check(self, w):
        """Every case of the sampled group call against the reference: the
        widest gap of the blended MC mean and of the blended MC std."""
        worst_mean = worst_std = float("inf") if not w["sample"] else 0.0
        for call, out in w["sample"]:
            vols = to_ncdhw(torch.from_numpy(np.stack(self.cases)).to(self.device))

            def reference(tf32):
                with torch.no_grad(), reference_precision(tf32):
                    mean, sd = sliding.group(
                        self.params, self.cfg["model"], vols, draws.fold_in(self.seed, call),
                        self.mc, float(self.wl["overlap"]), self.tile_batch)
                return mean.permute(0, 2, 3, 4, 1), sd.permute(0, 2, 3, 4, 1)

            mean_r, std_r = reference(False)
            if self.variant == "control":  # the reference in TF32 in the program's place
                out = list(zip(*(t.cpu().numpy() for t in reference(True))))
            for j, (probs, std) in enumerate(out):
                worst_mean = max(worst_mean, compare.max_abs(probs, mean_r[j]))
                worst_std = max(worst_std, compare.max_abs(std, std_r[j]))
        lim = self.wl["limits"]
        n = sum(len(out) for _, out in w["sample"])
        return [compare.check("mean_max_gap", worst_mean, lim["mean_max_gap"], cases=n),
                compare.check("std_max_gap", worst_std, lim["std_max_gap"], cases=n)]
