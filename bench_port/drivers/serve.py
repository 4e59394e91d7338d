"""Requests to ``serve.InferenceSession`` from one client in a closed loop.

Traffic (the workload file): ``batch`` window volumes a request at the
config's window, ``mc_iter`` Monte-Carlo samples, the cell's ``dtype``; a
pool of ``pool`` distinct requests drawn from the seed, sent in turn, each
as the host arrays a deployment reads from disk. Set-up builds the model
from the seed's weights, the session (its draws seeded with the run's
seed) and sends ``warm`` requests. The window sends the next request as
soon as the last has returned, for ``seconds`` (``trace_seconds`` when
traced), and times each on the host clock (``__call__`` returns host
arrays, so it ends synchronised).

End to end: ``request_p95_ms``, the 95th percentile of every request of
the window; ``vol_per_s``, the window's volumes over the window.

Check: a sample of ``check_requests`` requests of the window, drawn from
the seed, against the reference's MC mean and std over the same volumes
and the same draws (the session's ``fold_in(seed, n)`` for its n-th call),
in fp32: the mean |gap| over every voxel and class of a request, the
largest over the sample, for the MC mean and for the MC std (the widest
gap of one voxel is reported beside it; it does not separate bf16 from
the fp8 control, so it is not compared).
"""

from __future__ import annotations

import contextlib
import time
import traceback

import torch

from bench_port.counts.m1 import detect_calls
from bench_port.harness import seeds
from bench_port.harness.session import (Reservoir, build_model, free, host_inputs,
                                        make_weights, model_config, percentile,
                                        reference_precision)
from bench_port.harness.trace import span
from bench_port.reference import compare, draws
from bench_port.reference.m1 import mc_mean_std, to_ncdhw, to_ndhwc

# what may replace the program: the control (the program's own lower-
# precision path, the workload's ``control``) and the faults the tests plant
VARIANTS = ("control", "alter_answer", "nan_answer", "half_batch")


class Cell:
    def __init__(self, cfg, wl, seed, device, variant=None):
        if variant not in (None, *VARIANTS):
            raise ValueError(f"unknown variant {variant!r}")
        self.cfg, self.wl, self.seed, self.device, self.variant = cfg, wl, seed, device, variant
        self.model_cfg = model_config(cfg, variant, wl.get("control"))
        self.batch, self.mc = int(wl["batch"]), int(wl["mc_iter"])

    def setup(self):
        from prostatemr_3d_cad_cspca_tpu_torch.serve import InferenceSession

        wl, dev = self.wl, self.device
        self.params = make_weights(self.cfg, self.model_cfg, self.seed, dev)
        model = build_model(self.model_cfg, self.params, wl["dtype"], dev)
        self.session = InferenceSession(model, mc_iter=self.mc, seed=self.seed, device=dev)
        self._plant()
        shape = (self.batch, *self.model_cfg["input_spatial_dims"],
                 self.model_cfg["input_channels"])
        zero = self.model_cfg["num_classes"] - 1 if self.model_cfg.get("probabilistic") else 0
        self.pool = host_inputs(shape, int(wl["pool"]), seeds.child(self.seed, "inputs"), dev,
                                zero_channels=zero)
        self.calls = 0
        for i in range(int(wl["warm"])):
            self.session(self.pool[i % len(self.pool)])
            self.calls += 1

    def _plant(self):
        """The faults of the tests, planted in the session's forward."""
        s = self.session
        if self.variant == "alter_answer":
            body = s._body

            def altered(x, rng=None):  # the first volume gets the second's answer
                mean, std = body(x, rng)
                mean = mean.clone()
                mean[0] = mean[1]
                return mean, std
            s._body = altered
        elif self.variant == "nan_answer":
            body = s._body

            def spoiled(x, rng=None):  # one voxel of the first volume is not a number
                mean, std = body(x, rng)
                mean = mean.clone()
                mean[0, 0, 0, 0, 1] = float("nan")
                return mean, std
            s._body = spoiled
        elif self.variant == "half_batch":
            detect = s._detect

            def half(params, x, rng=None):
                n = x.shape[0] // 2
                out = detect(params, x[:n], rng=rng)
                return torch.cat([out, out], 0)
            s._detect = half

    def window(self, seconds, tracer=None):
        wl = self.wl
        if tracer is not None:
            seconds = min(seconds, float(wl["trace_seconds"]))
        keep = Reservoir(int(wl["check_requests"]), seeds.child(self.seed, "sample"))
        lat, attempted, failed = [], 0, 0
        with (tracer if tracer is not None else contextlib.nullcontext()):
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < seconds:
                k = attempted % len(self.pool)
                attempted += 1
                call = self.calls
                self.calls += 1
                t = time.perf_counter()
                try:
                    with span("bench.request"):
                        probs, std = self.session(self.pool[k])
                except Exception:  # noqa: BLE001  (a failed request counts, the run goes on)
                    traceback.print_exc()
                    failed += 1
                    continue
                lat.append(time.perf_counter() - t)
                keep.offer(lambda: (call, k, probs, std))
            window_s = time.perf_counter() - t0
        return dict(attempted=attempted, failed=failed, latencies=lat, window_s=window_s,
                    sample=keep.items)

    def end_to_end(self, w):
        done = len(w["latencies"])
        return {"request_p95_ms": percentile(w["latencies"], 95) * 1e3 if done else None,
                "vol_per_s": done * self.batch / w["window_s"]}

    def work(self, w):
        return {"units": len(w["latencies"]),
                "calls": detect_calls(self.model_cfg, self.batch * self.mc, self.wl["dtype"])}

    def release(self):
        del self.session
        free(self.device)

    def check(self, w):
        """The sampled requests against the reference: the widest gap of
        the MC mean and of the MC std, over every voxel and channel."""
        ref_cfg = dict(self.cfg["model"])
        gaps = {"mean_abs_gap": 0.0, "std_abs_gap": 0.0, "mean_max": 0.0, "std_max": 0.0}
        with torch.no_grad(), reference_precision(False):
            for call, k, probs, std in w["sample"]:
                x = to_ncdhw(torch.from_numpy(self.pool[k]).to(self.device))
                stream = draws.Stream(draws.fold_in(self.seed, call), self.device)
                mean_r, std_r = mc_mean_std(self.params, ref_cfg, x, stream, self.mc)
                mean_r, std_r = to_ndhwc(mean_r).cpu(), to_ndhwc(std_r).cpu()
                for name, got, want in (("mean", probs, mean_r), ("std", std, std_r)):
                    gaps[f"{name}_abs_gap"] = max(gaps[f"{name}_abs_gap"],
                                                  compare.mean_abs(got, want))
                    gaps[f"{name}_max"] = max(gaps[f"{name}_max"], compare.max_abs(got, want))
                del mean_r, std_r
        n = len(w["sample"])
        if not n:  # nothing came back to check
            gaps = {k: float("inf") for k in gaps}
        lim = self.wl["limits"]
        return [compare.check(f"{q}_abs_gap", gaps[f"{q}_abs_gap"], lim[f"{q}_abs_gap"],
                              widest=gaps[f"{q}_max"], requests=n) for q in ("mean", "std")]
