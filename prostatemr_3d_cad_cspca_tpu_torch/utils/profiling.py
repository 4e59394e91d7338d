"""Tracing and profiling hooks, port of the JAX package's
``utils/profiling.py``.

* ``trace(logdir)`` — context manager around ``torch.profiler``: host and
  (on a card) device activity, written as a Chrome/Perfetto trace
  ``trace_<time>.json`` into ``logdir``;
* ``annotate(name, args)`` — the program's one span: a named
  ``torch.profiler.record_function`` range while a profiler runs, a shared
  no-op context otherwise; ``SPANS`` names every span the program opens;
* ``StepTimer`` — per-step wall-clock statistics with a warm-up skip;
* ``MetricsLogger`` — a JSONL metric stream, one JSON object per event,
  flushed per write.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Dict, List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler


@contextlib.contextmanager
def trace(logdir: str, with_memory: bool = True):
    """Profile the body; yields the ``torch.profiler.profile`` object."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, profile_memory=with_memory) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{time.time_ns()}.json"))


# Every span the program opens, by layer. A span that launches kernels gets
# a device-side range on the profiler's clock (the innermost span of each
# launch owns its kernel), so its device time can be read from a trace;
# each span's host interval names what the host was doing meanwhile.
SPANS = (
    # serving (serve.py): a request, a sliding-window group and their parts
    "serve.request", "serve.group", "serve.upload", "serve.forward", "serve.readback",
    # inference (infer.py, ensemble.py): the work around the model calls,
    # never a model call itself
    "infer.mc_stack", "infer.mc_reduce", "sw.gather", "sw.blend", "sw.finish",
    "tta.flip", "ensemble.reduce",
    # model (models/): one detect-head call, the elementwise parts in it, the
    # dense skips' up-chain transposed convs and the convs over a stitch's
    # part list (args: the parts, their channels and whether the block's two
    # convs of them ran as one launch)
    "m1.forward", "m1.se", "m1.gate", "m1.dropout", "m1.dense", "m1.stitch",
    # training (augment.py)
    "augment",
)

_OFF = contextlib.nullcontext()


def annotate(name: str, args=None):
    """The span ``name`` (``args``: a string, or a value shown as one)
    while a ``torch.profiler`` profile runs; otherwise one shared no-op
    context, so an untraced call pays a flag check and no range."""
    # reads the private flag torch.autograd.profiler sets while a profile
    # is on: a bare record_function costs 10-12 us a span with no profile
    # running (x86 hosts, torch 2.11-2.13), the check ~0.2-0.5 us
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(name, None if args is None else str(args))


class StepTimer:
    """Wall-clock step statistics, skipping the first ``skip_first`` steps
    (warm-up). The port's steps run eagerly, so a step's wall is the time
    the host takes to enqueue it unless the device queue is full."""

    def __init__(self, skip_first: int = 2):
        self.skip_first = skip_first
        self._times: List[float] = []
        self._count = 0
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._count += 1
        if self._count > self.skip_first:
            self._times.append(dt)

    def stats(self) -> Dict[str, float]:
        if not self._times:
            return {"steps": 0}
        ts = sorted(self._times)
        n = len(ts)
        return {
            "steps": n,
            "mean_s": sum(ts) / n,
            "p50_s": ts[n // 2],
            "p90_s": ts[min(int(n * 0.9), n - 1)],
            "min_s": ts[0],
            "max_s": ts[-1],
        }


class MetricsLogger:
    """Append-only JSONL metric stream + stdout echo."""

    def __init__(self, path: Optional[str] = None, echo: bool = True):
        self.path = path
        self.echo = echo
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def log(self, event: str, **fields: Any):
        rec = {"event": event, "time": time.time(), **fields}
        line = json.dumps(rec, default=float)
        if self.path:
            with open(self.path, "a") as f:
                f.write(line + "\n")
        if self.echo:
            print(line, flush=True)
