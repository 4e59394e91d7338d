"""Device time inside the program's own spans (``annotate`` in the
program's ``utils/profiling.py``, whose ``SPANS`` names them all).

Each span that launches kernels has device-side ranges in the trace
(``TraceView.ranges``, by name): the innermost span open at a launch owns
its kernel, so the spans the readers here take (the model's elementwise
parts, the inference layer's work around the model calls) hold no other
span's kernels. A reader sums the device time of the operations inside the
union of its spans' ranges, so an operation inside two of them counts
once. Where the program opens none of these spans (before they were
added), the ranges are absent and the reading is None.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence


def program_ms(v, names: Sequence[str]) -> Optional[float]:
    """Device ms of the window's operations inside the device-side ranges
    of the spans ``names`` (each operation once), or None without ranges."""
    spans = [sp for n in names for sp in v.ranges.get(n, [])]
    if not any(v.in_window(s, e) for s, e in spans):
        return None
    # the view's own reading of one range, over the union of these
    return dataclasses.replace(v, ranges={"": spans}).range_seconds("") * 1e3


def ms_per_unit(v, names: Sequence[str]) -> Optional[float]:
    """``program_ms`` over the driver's units (requests, or window forwards
    of the sliding window), or None where either is missing."""
    units = v.work.get("units", 0)
    ms = program_ms(v, names)
    if not units or ms is None:
        return None
    return ms / units
