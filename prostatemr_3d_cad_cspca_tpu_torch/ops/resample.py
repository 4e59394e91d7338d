"""Nearest upsampling by integer factors, port of the JAX package's
``ops/resample.upsample_nearest`` (tf.keras UpSampling3D parity). The
bilinear samplers of that module serve augmentation and wait for the
training slice."""

from __future__ import annotations

from typing import Sequence

import torch


def upsample_nearest(x: torch.Tensor, factors: Sequence[int]) -> torch.Tensor:
    """``x`` is (B, *spatial, C); one integer factor per spatial dim."""
    assert len(factors) == x.dim() - 2, (factors, tuple(x.shape))
    for i, f in enumerate(factors):
        if f != 1:
            x = torch.repeat_interleave(x, int(f), dim=1 + i)
    return x
