"""The numbers that decide ``correct``: gaps between what the program
produced and what the reference computes from the same inputs."""

from __future__ import annotations

import math

import numpy as np
import torch


def finite(value: float) -> float:
    """``value``, or inf where it is NaN or infinite: a gap that is not a
    number is as wide as a gap can be (``max(0.0, nan)`` would read 0)."""
    value = float(value)
    return value if math.isfinite(value) else math.inf


def _gaps(got, want) -> torch.Tensor:
    g = got if torch.is_tensor(got) else torch.from_numpy(np.asarray(got))
    w = want if torch.is_tensor(want) else torch.from_numpy(np.asarray(want))
    return (g.double().to(w.device) - w.double()).abs()


def max_abs(got, want) -> float:
    """The largest |got - want| (fp64); inf where either holds a NaN."""
    return finite(_gaps(got, want).max())


def mean_abs(got, want) -> float:
    return finite(_gaps(got, want).mean())


def norm_gaps(got: dict, want: dict) -> dict:
    """Per leaf: |‖got‖ - ‖want‖| over the larger of ‖want‖ and the median
    leaf's ‖want‖ (the gap between the two norms, not the norm of the
    difference)."""
    wn = {k: float(want[k].double().norm()) for k in want}
    med = float(np.median(list(wn.values())))
    return {k: finite(abs(float(got[k].double().norm()) - wn[k]) / max(wn[k], med, 1e-30))
            for k in want}


def whole_gap(got: dict, want: dict) -> float:
    """|‖got‖ - ‖want‖| / ‖want‖ over every leaf together."""
    g = sum(float(got[k].double().square().sum()) for k in want) ** 0.5
    w = sum(float(want[k].double().square().sum()) for k in want) ** 0.5
    return finite(abs(g - w) / w)


def worst(gaps: dict):
    """(leaf, gap) of the largest gap."""
    k = max(gaps, key=gaps.get)
    return k, gaps[k]


def check(name: str, value: float, limit: float, **extra) -> dict:
    return {"name": name, "value": finite(value), "limit": float(limit), **extra}
