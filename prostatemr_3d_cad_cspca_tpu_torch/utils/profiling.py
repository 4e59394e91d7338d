"""Tracing and profiling hooks, port of the JAX package's
``utils/profiling.py``.

* ``trace(logdir)`` — context manager around ``torch.profiler``: host and
  (on a card) device activity, written as a Chrome/Perfetto trace
  ``trace_<time>.json`` into ``logdir``;
* ``annotate(name)`` — a named ``torch.profiler.record_function`` range;
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


@contextlib.contextmanager
def trace(logdir: str, with_memory: bool = True):
    """Profile the body; yields the ``torch.profiler.profile`` object."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, profile_memory=with_memory) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{time.time_ns()}.json"))


def annotate(name: str):
    import torch

    return torch.profiler.record_function(name)


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
