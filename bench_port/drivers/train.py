"""Train steps of ``train.trainer.make_train_step``, fed by the data layer.

Traffic (the workload file): ``cases`` synthetic labelled cases at the
config's window, written in set-up under ``TMPDIR`` (images standard
normal, fp32; lesion grades 2 or 3 in a block of each case, away from the
borders), read by ``data.generators.custom_data_generator`` (the
lesion task, shuffled by a seed child) into ``batch_iterator`` batches of
``batch`` with ``prefetch`` in flight; the config's recipe (Keras amsgrad,
focal loss, L2) with its augmentation on the device, in ``dtype``. Step i
draws from a generator seeded with a child of the seed.

Set-up builds the model from the seed's weights, the optimizer state and
the step, and takes the first ``compared_steps`` steps through the
window's own call and feed (their rows all differ: ``cases`` >= their
rows); it keeps the loss of each, the first moment after step 1 (the first
gradient as the optimizer got it, ``mu / (1 - b1)``) and the parameters
after the last. The window takes steps for ``seconds`` (``trace_seconds``
when traced) and ends synchronised.

End to end: ``train_vol_per_s``, the window's volumes over the window.

Check: the reference follows the compared steps from the same weights,
files and draws. Compared: the first step's loss (relative gap); the
first gradient and the change of the parameters after the compared steps,
each leaf by the gap of its norm (over the larger of its reference norm
and the median leaf's), the median leaf's gap. The later steps' losses
and the worst leaf's gaps are reported beside them: Adam's first updates
are +-lr an element whatever the gradient's size, so rounding flips the
sign of near-zero elements and those numbers read the same for sound runs
and for the TF32 control (``PERF.md``). The change is taken over the
leaves the reference's first gradient moves (a norm of 1e-3 of the median
leaf's or more): biases ahead of an instance norm have a gradient of
nought and move under Adam by rounding alone.
"""

from __future__ import annotations

import contextlib
import csv
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from bench_port.counts.m1 import train_calls
from bench_port.harness import seeds
from bench_port.harness.session import (build_model, free, make_weights, model_config,
                                        reference_precision)
from bench_port.harness.trace import span
from bench_port.reference import compare
from bench_port.reference import train as ref

B1 = 0.9  # the optimizer's first-moment decay: mu after one step is (1 - B1) g

# what may replace the program: the control (the reference in TF32, in the
# program's place) and the faults the tests plant
VARIANTS = ("control", "frozen_state", "half_batch")


def write_cases(root: str, n: int, spatial, channels: int, seed: int, device):
    """``n`` cases (image .npy fp32, lesion grades .npy uint8) and their
    manifest; returns (manifest, [(image, label)])."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    images = torch.randn((n, *spatial, channels), generator=gen, device=device)
    images = images.cpu().numpy()
    rng = np.random.default_rng(seeds.child(seed, "lesions"))
    d, h, w = spatial
    rows, files = [], []
    for i in range(n):
        grades = np.zeros(spatial, np.uint8)
        bd, bh, bw = max(1, d // 5), max(8, h // 6), max(8, w // 6)
        z0 = int(rng.integers(0, d - bd + 1))
        y0 = int(rng.integers(4, h - bh - 3))
        x0 = int(rng.integers(4, w - bw - 3))
        grades[z0:z0 + bd, y0:y0 + bh, x0:x0 + bw] = 2 + i % 2
        ip, lp = (os.path.join(root, f"case{i}_{k}.npy") for k in ("image", "label"))
        np.save(ip, images[i])
        np.save(lp, grades)
        rows.append({"p-id": f"case{i}", "image_path": ip, "label_path": lp})
        files.append((ip, lp))
    manifest = os.path.join(root, "train.csv")
    with open(manifest, "w", newline="") as f:
        wr = csv.DictWriter(f, fieldnames=list(rows[0]))
        wr.writeheader()
        wr.writerows(rows)
    return manifest, files


class Cell:
    def __init__(self, cfg, wl, seed, device, variant=None):
        if variant not in (None, *VARIANTS):
            raise ValueError(f"unknown variant {variant!r}")
        self.cfg, self.wl, self.seed, self.device, self.variant = cfg, wl, seed, device, variant
        self.model_cfg = model_config(cfg, None)
        self.batch = int(wl["batch"])
        self.shuffle_seed = seeds.child(seed, "shuffle")
        self.tmp = None

    def _gen(self, i: int):
        return torch.Generator(device=self.device).manual_seed(self.step_seed(i))

    def step_seed(self, i: int) -> int:
        return seeds.child(self.seed, "step", i)

    def setup(self):
        from prostatemr_3d_cad_cspca_tpu_torch.data.generators import (
            batch_iterator, custom_data_generator)
        from prostatemr_3d_cad_cspca_tpu_torch.train import trainer as tt

        wl, tr, dev = self.wl, self.cfg["train"], self.device
        if int(wl["cases"]) < self.batch * int(wl["compared_steps"]):
            raise ValueError("the compared steps' rows must all differ: cases < their rows")
        self.params = make_weights(self.cfg, self.model_cfg, self.seed, dev)
        model = build_model(self.model_cfg, self.params, wl["dtype"], dev)
        opt = tt.make_optimizer(tr["optimizer"], tr["learning_rate"])
        loss = tt.make_loss(tr["loss"], tuple(tr["focal_alpha"]), tr["focal_gamma"])
        step = tt.make_train_step(model, loss, opt, augment_params=tr["augm_params"],
                                  train_obj="lesion")
        self.state = tt.init_train_state(model, opt)
        self.step = self._plant(step)
        self.tmp = tempfile.mkdtemp(prefix="bench_port_train_")
        manifest, self.files = write_cases(
            self.tmp, int(wl["cases"]), self.model_cfg["input_spatial_dims"],
            self.model_cfg["input_channels"], seeds.child(self.seed, "cases"), dev)
        self.batches = batch_iterator(
            custom_data_generator(manifest, train_obj="lesion", shuffle_seed=self.shuffle_seed),
            self.batch, prefetch=int(wl["prefetch"]))
        self.steps = 0
        self.losses = []
        for i in range(int(wl["compared_steps"])):
            self.state, metrics = self.step(self.state, next(self.batches), self._gen(i))
            self.steps += 1
            self.losses.append(float(metrics["loss"]))
            if i == 0:
                self.first = {k: v.detach().clone() / (1 - B1)
                              for k, v in self.state.opt_state["mu"].items()}
        self.after = {k: v.detach().clone() for k, v in self.state.params.items()}

    def _plant(self, step):
        """The faults of the tests, planted around the program's step."""
        if self.variant == "frozen_state":
            def frozen(state, batch, rng=None):
                before = {k: v.detach().clone() for k, v in state.params.items()}
                state, metrics = step(state, batch, rng)
                with torch.no_grad():
                    for k, v in state.params.items():
                        v.copy_(before[k])
                return state, metrics
            return frozen
        if self.variant == "half_batch":
            def half(state, batch, rng=None):
                n = self.batch // 2
                return step(state, {k: v[:n] for k, v in batch.items()}, rng)
            return half
        return step

    def window(self, seconds, tracer=None):
        wl = self.wl
        if tracer is not None:
            seconds = min(seconds, float(wl["trace_seconds"]))
        attempted = 0
        with (tracer if tracer is not None else contextlib.nullcontext()):
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < seconds:
                with span("bench.next_batch"):
                    batch = next(self.batches)
                with span("bench.step"):
                    self.state, _ = self.step(self.state, batch, self._gen(self.steps))
                self.steps += 1
                attempted += 1
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            window_s = time.perf_counter() - t0
        return dict(attempted=attempted, failed=0, window_s=window_s)

    def end_to_end(self, w):
        return {"train_vol_per_s": w["attempted"] * self.batch / w["window_s"]}

    def work(self, w):
        return {"units": w["attempted"],
                "calls": train_calls(self.model_cfg, self.batch, self.wl["dtype"])}

    def release(self):
        self.batches.close()
        del self.state, self.step, self.batches
        free(self.device)

    def check(self, w):
        """The compared steps against the reference's."""
        n = int(self.wl["compared_steps"])
        order = ref.order(len(self.files), self.shuffle_seed, n * self.batch)
        batches = []
        for i in range(n):
            samples = [ref.sample(*self.files[j]) for j in order[i * self.batch:(i + 1) * self.batch]]
            batches.append((np.stack([s[0] for s in samples]), np.stack([s[1] for s in samples])))
        seeds_ = [self.step_seed(i) for i in range(n)]
        tr, model = self.cfg["train"], self.cfg["model"]
        with reference_precision(False):
            losses_r, first_r, after_r = ref.steps(self.params, model, tr, batches, seeds_,
                                                   self.device)
        losses, first, after = self.losses, self.first, self.after
        if self.variant == "control":  # the reference in TF32 in the program's place
            with reference_precision(True):
                losses, first, after = ref.steps(self.params, model, tr, batches, seeds_,
                                                 self.device)
        shutil.rmtree(self.tmp, ignore_errors=True)
        loss_gaps = [abs(a - b) / abs(b) for a, b in zip(losses, losses_r)]
        grad_gaps = compare.norm_gaps(first, first_r)
        moved = ref.moved_leaves(first_r)
        change = {k: after[k] - self.params[k] for k in moved}
        change_r = {k: after_r[k] - self.params[k] for k in moved}
        change_gaps = compare.norm_gaps(change, change_r)
        grad_leaf, grad_worst = compare.worst(grad_gaps)
        change_leaf, change_worst = compare.worst(change_gaps)
        lim = self.wl["limits"]
        top = sorted(grad_gaps.items(), key=lambda kv: -kv[1])[:6]
        return [compare.check("loss1_gap", loss_gaps[0], lim["loss1_gap"], per_step=loss_gaps),
                compare.check("grad_median_gap", float(np.median(list(grad_gaps.values()))),
                              lim["grad_median_gap"], worst=[grad_leaf, grad_worst],
                              whole=compare.whole_gap(first, first_r),
                              p90=float(np.percentile(list(grad_gaps.values()), 90)),
                              top=[[k, v, int(first_r[k].numel())] for k, v in top]),
                compare.check("change_median_gap", float(np.median(list(change_gaps.values()))),
                              lim["change_median_gap"], worst=[change_leaf, change_worst],
                              leaves=len(moved), of=len(first_r))]
