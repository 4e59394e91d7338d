"""What the per-layer readers share: a share of a roofline, of the peak,
and of the window the device idled. Each returns None where the trace
holds nothing to read."""

from __future__ import annotations

from typing import Optional, Sequence

from ..counts.m1 import CONV_KINDS


def roofline(v, kernels: Sequence[str], kinds: Sequence[str]) -> Optional[float]:
    """% : the least time of the window's calls of ``kinds`` over the device
    time of the kernels named ``kernels``."""
    t = v.seconds(kernels)
    least = v.least_seconds(kinds)
    if t <= 0 or least <= 0:
        return None
    return 100.0 * least / t


def mfu(v) -> Optional[float]:
    """% : the model's FLOPs in the window (every convolution of the
    window's calls, less the share of the work that is padding, the
    driver's ``model_share``) over the window times the card's peak for
    their type."""
    calls = v.calls(CONV_KINDS)
    if not calls or v.traced_s <= 0 or not v.device_ops():
        return None
    flops = sum(c.flops * n for c, n in calls) * v.work.get("model_share", 1.0)
    rate = v.peaks["tensor_flop_per_s"][calls[0][0].dtype]
    return 100.0 * flops / (v.traced_s * rate)


def idle_share(v) -> Optional[float]:
    """% of the window in which no operation ran on the device."""
    if v.traced_s <= 0 or not v.device_ops():
        return None
    return 100.0 * (1.0 - v.busy_s / v.traced_s)
