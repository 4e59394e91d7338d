"""The traced run: ``torch.profiler`` over the traced window, read into a
``TraceView`` that the per-layer readers (``metrics/``) take.

The view holds the device's operations (kernels, copies and sets, each
with its name and interval), the device-side spans of the driver's ranges
(``record_function`` ranges named ``bench.*``) and of the program's
(``augment``), the host events of the thread that drives the window, the window's bounds on
the profiler's clock, the work the driver did in the window (``work``:
units such as requests or steps, and the kernel calls a unit makes, from
``counts``), and the card's peaks.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import json
import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
WINDOW_SPAN = "bench.window"
PROGRAM_RANGES = ("augment",)


def kernel_name(name: str) -> str:
    """A device operation's short name: a kernel's identifier before its
    template arguments or parameters; a copy or set as named."""
    if name.startswith(("Memcpy", "Memset")):
        return name.split(" (")[0]
    ident = re.search(r"(\w+)[<(]", name)
    return ident.group(1) if ident else name[:60]


def peaks() -> dict:
    with open(os.path.join(os.path.dirname(HERE), "counts", "peaks.json")) as f:
        return json.load(f)


def union_seconds(spans: Sequence[Tuple[float, float]]) -> float:
    """Seconds covered by the union of (start, end) intervals in us."""
    busy, end = 0.0, None
    for s, e in sorted(spans):
        if end is None or s > end:
            busy, end = busy + e - s, e
        elif e > end:
            busy, end = busy + e - end, e
    return busy / 1e6


def merged(spans: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


@dataclass
class TraceView:
    ops: List[Tuple[str, float, float]]           # device operations: (short name, start, end) us
    ranges: Dict[str, List[Tuple[float, float]]]  # name -> its device-side spans
    host: List[Tuple[str, float, float, int]]     # the driving thread's events: (name, start, end, thread)
    window: Tuple[float, float]                   # the window span on the profiler's clock (us)
    work: dict = field(default_factory=dict)      # units and calls of the driver's work
    peaks: dict = field(default_factory=dict)

    def in_window(self, s, e):
        return e > self.window[0] and s < self.window[1]

    def device_ops(self, names: Optional[Sequence[str]] = None):
        return [(n, s, e) for n, s, e in self.ops
                if self.in_window(s, e) and (names is None or n in names)]

    @property
    def traced_s(self) -> float:
        """The window's length on the profiler's clock."""
        return (self.window[1] - self.window[0]) / 1e6

    @property
    def busy_s(self) -> float:
        lo, hi = self.window
        return union_seconds([(max(s, lo), min(e, hi)) for _, s, e in self.device_ops()])

    def seconds(self, names: Sequence[str]) -> float:
        """Device seconds of the operations named ``names`` in the window."""
        return sum(e - s for _, s, e in self.device_ops(names)) / 1e6

    def range_seconds(self, name: str) -> float:
        """Device seconds of the operations inside the device-side spans of
        the range ``name`` (one stream: a range's kernels run inside its
        span)."""
        spans = [(s, e) for s, e in self.ranges.get(name, []) if self.in_window(s, e)]
        if not spans:
            return 0.0
        spans = merged(spans)
        starts = [s for s, _ in spans]
        total = 0.0
        for _, s, e in self.device_ops():
            i = bisect.bisect_right(starts, s) - 1
            if i >= 0 and e <= spans[i][1]:
                total += e - s
        return total / 1e6

    def calls(self, kinds: Sequence[str]):
        """(call, count) of the window's kernel calls of ``kinds``."""
        units = self.work.get("units", 0)
        return [(c, units) for c in self.work.get("calls", []) if c.kind in kinds]

    def least_seconds(self, kinds: Sequence[str]) -> float:
        """The least time the card could take for the window's calls of
        ``kinds``: each call's larger of operations over its peak and bytes
        over HBM's."""
        p = self.peaks
        total = 0.0
        for c, n in self.calls(kinds):
            rate = (p["tensor_flop_per_s"][c.dtype] if c.kind in ("K1", "K2", "K6")
                    else p["vector_flop_per_s"])
            total += n * max(c.flops / rate, c.bytes / p["hbm_bytes_per_s"])
        return total

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle gaps of
        the window summed by what the host was doing (the innermost host
        event of the driving thread over the gap's middle)."""
        by_name = collections.Counter()
        for n, s, e in self.device_ops():
            by_name[n] += (e - s) / 1e6
        lo, hi = self.window
        busy = merged([(max(s, lo), min(e, hi)) for _, s, e in self.device_ops()])
        gaps, prev = [], lo
        for s, e in busy:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        if hi > prev:
            gaps.append((prev, hi))
        host = sorted(self.host, key=lambda h: h[1])
        starts = [h[1] for h in host]
        by_host = collections.Counter()
        for gs, ge in gaps:
            mid, name = (gs + ge) / 2, "(no host event)"
            i = bisect.bisect_right(starts, mid) - 1
            # events of one thread nest: the latest-starting one that covers
            # the middle is the innermost
            for j in range(i, max(i - 5000, -1), -1):
                if host[j][2] >= mid:
                    name = host[j][0]
                    break
            by_host[name] += (ge - gs) / 1e6
        return {"device_ops": [[k, v] for k, v in by_name.most_common(top)],
                "idle_gaps": [[k, v] for k, v in by_host.most_common(top)]}


class Tracer:
    """``with tracer:`` profiles its body (the traced window, one span
    ``bench.window``); ``view(work)`` reads the profile."""

    def __init__(self):
        self.prof = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize()
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.span = torch.profiler.record_function(WINDOW_SPAN)
        self.span.__enter__()
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.span.__exit__(*exc)
        self.prof.__exit__(*exc)
        return False

    def view(self, work: dict) -> TraceView:
        """The profile's raw events (no event tree is built: a window holds
        hundreds of thousands) read into a view; times in us."""
        ops, ranges, host, window = [], collections.defaultdict(list), [], None
        cuda = torch.autograd.DeviceType.CUDA
        for evt in self.prof.profiler.kineto_results.events():
            name = evt.name()
            s, e = evt.start_ns() / 1e3, (evt.start_ns() + evt.duration_ns()) / 1e3
            if evt.device_type() == cuda:
                if evt.is_user_annotation() or name.startswith("bench.") \
                        or name in PROGRAM_RANGES:
                    ranges[name].append((s, e))
                elif e > s:
                    ops.append((kernel_name(name), s, e))
                continue
            if name == WINDOW_SPAN:
                window = (s, e)
            host.append((name, s, e, evt.start_thread_id()))
        if window is None:
            raise RuntimeError("the trace lacks the window's span")
        # the gaps are named by the thread that drives the window
        main = [t for n, s, e, t in host if n == WINDOW_SPAN][0]
        host = [h for h in host if h[3] == main]
        return TraceView(ops=ops, ranges=dict(ranges), host=host, window=window, work=work,
                         peaks=peaks())


@contextlib.contextmanager
def span(name: str):
    """A driver's span around a call into a layer of the program."""
    with torch.profiler.record_function(name):
        yield
