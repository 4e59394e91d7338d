"""Weights made on the device from the seed, in one draw.

The recipe (``configs/<config>.json`` ``weights``): a conv kernel is normal
with standard deviation ``kernel_gain / sqrt(fan_in)`` (fan_in: the taps
times the input channels; a transposed kernel, (kd, kh, kw, out, in), takes
its last axis), an instance norm's scale ``scale_mean + scale_std * N``,
every other leaf (biases, norm offsets) ``other_std * N``. The parameter
names and shapes are the reference's (``reference.m1.param_shapes``); the
program loads them by name, strictly."""

from __future__ import annotations

import math
from typing import Dict

import torch

TRANSPOSED_PREFIXES = ("convtd", "dec_hi")


def make(shapes: Dict[str, tuple], recipe: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """fp32 leaves of ``shapes`` on ``device``, from one normal draw."""
    total = sum(math.prod(s) for s in shapes.values())
    gen = torch.Generator(device=device).manual_seed(int(seed))
    z = torch.randn(total, generator=gen, dtype=torch.float32, device=device)
    out, off = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        v = z[off:off + n].view(shape)
        off += n
        path = name.split(".")
        leaf, parent = path[-1], path[-2]
        if leaf == "kernel":
            taps = math.prod(shape[:3])
            fan_in = taps * (shape[4] if parent.startswith(TRANSPOSED_PREFIXES) else shape[3])
            v = v * (recipe["kernel_gain"] / math.sqrt(fan_in))
        elif leaf == "scale":
            v = recipe["scale_mean"] + recipe["scale_std"] * v
        else:
            v = recipe["other_std"] * v
        out[name] = v.contiguous()
    return out
