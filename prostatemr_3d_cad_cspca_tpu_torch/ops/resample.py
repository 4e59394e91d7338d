"""Resampling primitives, port of the JAX package's ``ops/resample.py``:
nearest upsampling by integer factors (tf.keras UpSampling3D parity) and the
gather-based 2D samplers of the train-time augmentation (``tf.image.resize``
and ``tfa.image.rotate`` style warps, reference model/augmentations.py).

Every shape is static: a random zoom or rotation is a tensor of coordinates
into a fixed-size gather, never a dynamic output shape, so no sampler reads
a value back to the host. The float arithmetic follows JAX's in fp32 and in
its order (half-pixel centres, ``floor`` then int32 indices, weights in the
image's dtype), so an index lands on the same voxel in both packages.

Layouts: an image is (..., H, W, C). Coordinates of shape (h, w) warp every
leading slice alike (JAX's form on (H, W, C)); coordinates of shape
(B, h, w) warp each sample b of a (B, ..., H, W, C) batch by its own map,
every depth slice and channel alike, in the same launches as one sample.
"""

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


def _reflect_index(idx: torch.Tensor, size: int) -> torch.Tensor:
    """SYMMETRIC (half-sample) reflection of integer indices, as
    tf.pad(mode='SYMMETRIC'): ...2 1 0 | 0 1 2 ... n-1 | n-1 n-2... for any
    offset, by period-2n folding. ``%`` on a tensor is ``torch.remainder``,
    whose sign follows the divisor as ``jnp.mod``'s does (``torch.fmod``'s
    would follow the dividend)."""
    period = 2 * size
    idx = idx % period
    return torch.where(idx >= size, period - 1 - idx, idx)


def _flat(img: torch.Tensor, batched: bool) -> torch.Tensor:
    """(..., H, W, C) -> (B', M, H*W, C): B' the batch when each sample has
    its own coordinates, else 1; M every other leading slice."""
    H, W, C = img.shape[-3:]
    if batched:
        return img.reshape(img.shape[0], -1, H * W, C)
    return img.reshape(1, -1, H * W, C)


def _gather_hw(flat: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor, W: int) -> torch.Tensor:
    """flat (B', M, H*W, C); iy/ix integer (B', h*w) -> (B', M, h*w, C)."""
    idx = iy * W + ix
    b, m, _, c = flat.shape
    return torch.gather(flat, 2, idx[:, None, :, None].expand(b, m, idx.shape[1], c))


def _unflat(out: torch.Tensor, img: torch.Tensor, h: int, w: int) -> torch.Tensor:
    return out.reshape(*img.shape[:-3], h, w, img.shape[-1])


def take_2d(img: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor) -> torch.Tensor:
    """Integer gather of (B, ..., H, W, C) at in-range indices ``iy``/``ix``
    of shape (B, h, w), one map per sample: (B, ..., h, w, C)."""
    h, w = iy.shape[-2:]
    out = _gather_hw(_flat(img, True), iy.reshape(-1, h * w).long(),
                     ix.reshape(-1, h * w).long(), img.shape[-2])
    return _unflat(out, img, h, w)


def sample_bilinear_2d(img: torch.Tensor, coords_y: torch.Tensor, coords_x: torch.Tensor,
                       *, boundary: str = "symmetric") -> torch.Tensor:
    """Bilinearly sample (..., H, W, C) at float coordinates (h, w), or per
    sample at (B, h, w) for a (B, ..., H, W, C) batch.

    boundary: 'symmetric' reflects out-of-range samples (the reference's
    SYMMETRIC pre-pad + crop), 'edge' clamps, 'zero' fills 0.
    """
    if boundary not in ("symmetric", "edge", "zero"):
        raise ValueError(f"unknown boundary {boundary!r}")
    H, W = img.shape[-3], img.shape[-2]
    batched = coords_y.dim() == 3
    h, w = coords_y.shape[-2:]
    cy = coords_y.reshape(-1 if batched else 1, h * w)
    cx = coords_x.reshape(-1 if batched else 1, h * w)
    y0, x0 = torch.floor(cy), torch.floor(cx)
    wy = (cy - y0).to(img.dtype)[:, None, :, None]
    wx = (cx - x0).to(img.dtype)[:, None, :, None]
    y0i, x0i = y0.to(torch.int32), x0.to(torch.int32)
    y1i, x1i = y0i + 1, x0i + 1
    if boundary == "symmetric":
        y0c, y1c = _reflect_index(y0i, H), _reflect_index(y1i, H)
        x0c, x1c = _reflect_index(x0i, W), _reflect_index(x1i, W)
    else:  # edge-clamp ('zero' masks below)
        y0c, y1c = y0i.clamp(0, H - 1), y1i.clamp(0, H - 1)
        x0c, x1c = x0i.clamp(0, W - 1), x1i.clamp(0, W - 1)
    y0c, y1c, x0c, x1c = (t.long() for t in (y0c, y1c, x0c, x1c))
    flat = _flat(img, batched)
    v00 = _gather_hw(flat, y0c, x0c, W)
    v01 = _gather_hw(flat, y0c, x1c, W)
    v10 = _gather_hw(flat, y1c, x0c, W)
    v11 = _gather_hw(flat, y1c, x1c, W)
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    out = top * (1 - wy) + bot * wy
    if boundary == "zero":
        inside = (cy >= 0) & (cy <= H - 1) & (cx >= 0) & (cx <= W - 1)
        out = torch.where(inside[:, None, :, None], out, torch.zeros_like(out))
    return _unflat(out, img, h, w)


def _half_pixel(out_n: int, in_n: int, device) -> torch.Tensor:
    """(i + 0.5) * (in / out) - 0.5 over the output's indices, in fp32."""
    return (torch.arange(out_n, dtype=torch.float32, device=device) + 0.5) * (in_n / out_n) - 0.5


def resize_bilinear_2d(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """tf.image.resize(..., method='bilinear', antialias=False) parity on
    (..., H, W, C): half-pixel centres, edge clamp."""
    H, W = img.shape[-3], img.shape[-2]
    ys = _half_pixel(out_h, H, img.device).clamp(0.0, H - 1)
    xs = _half_pixel(out_w, W, img.device).clamp(0.0, W - 1)
    cy = ys[:, None].expand(out_h, out_w)
    cx = xs[None, :].expand(out_h, out_w)
    return sample_bilinear_2d(img, cy, cx, boundary="edge")


def resize_nearest_2d(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """tf.image.resize(..., method='nearest') parity on (..., H, W, C)."""
    H, W = img.shape[-3], img.shape[-2]

    def index(out_n, in_n):
        i = torch.arange(out_n, dtype=torch.float32, device=img.device)
        return torch.floor((i + 0.5) * (in_n / out_n)).to(torch.int32).clamp(0, in_n - 1).long()

    return img.index_select(-3, index(out_h, H)).index_select(-2, index(out_w, W))
