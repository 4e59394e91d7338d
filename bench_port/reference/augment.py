"""The train-time augmentation of the published pipeline (reference
``augmentations.py``), as the program runs it on the device over a whole
batch: a frozen copy of the program's ``augment.py`` and of the gathers of
``ops/resample.py`` it uses, plain PyTorch ops in fp32, with the draws
made by the reference from the rule the program states (one uniform block
of shape (B, 22 + 2 n_img_ch), its columns ``UNIFORM_COLUMNS`` then the
gamma and poor-scan channel coins, then the noise's standard normal of
shape (B, D, H, W, n_img_ch), both from one generator).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

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


UNIFORM_COLUMNS = ("master", "zoom_on", "zoom_u", "flip_on", "rot_on", "rot_u", "trans_on",
                   "trans_u0", "trans_u1", "trans_u2", "trans_u3", "cs_on", "cs_u0", "cs_u1",
                   "cs_u2", "cs_u3", "cs_channel_u", "gamma_on", "gamma_u", "poor_on",
                   "noise_on", "noise_std_u")


@dataclasses.dataclass(frozen=True)
class AugmentParams:
    """Reference --AUGM_PARAMS order (train_model.py:94-95):
    (M_PROB, TX_PROB, TRANS, ROT, HFLIP, SCALE, NOISE, C_SHIFT, POOR_QUAL, GAMMA)."""

    prob: float = 1.00
    tx_prob: float = 0.25
    translate_factor: float = 0.15
    rotation_degree: float = 10.0
    axial_hflip: bool = True
    zoom_factor: float = 1.20
    gauss_noise_stddev: float = 0.10
    chan_shift_factor: float = 0.025
    sim_poor_scan: bool = True
    gamma_correct: Tuple[float, float] = (0.50, 1.50)

    @classmethod
    def from_list(cls, params: Sequence) -> "AugmentParams":
        """The CLI's list; a 10th entry without a length (a bare number)
        falls back to gamma (0.5, 1.5), as the JAX package's does."""
        return cls(
            prob=float(params[0]), tx_prob=float(params[1]),
            translate_factor=float(params[2]), rotation_degree=float(params[3]),
            axial_hflip=bool(params[4]), zoom_factor=float(params[5]),
            gauss_noise_stddev=float(params[6]), chan_shift_factor=float(params[7]),
            sim_poor_scan=bool(params[8]),
            gamma_correct=tuple(params[9]) if hasattr(params[9], "__len__") else (0.5, 1.5),
        )


def _image_channels(train_obj: str) -> int:
    """The MRI channels the intensity transforms touch."""
    return 3 if train_obj == "lesion" else 1


def _gamma_on(p: AugmentParams) -> bool:
    return bool(p.gamma_correct) and (p.gamma_correct[0] != 0 or p.gamma_correct[1] != 0)


def _int_draw(u: torch.Tensor, lo, hi) -> torch.Tensor:
    """An integer in [lo, hi) from a uniform (lo where the range is empty)."""
    span = hi - lo
    return (lo + torch.floor(u * span)).clamp(max=hi - 1).clamp(min=lo).to(torch.int64)


def _per_sample(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1, 1, 1, 1, 1)


def _translate(x: torch.Tensor, pads: torch.Tensor) -> torch.Tensor:
    """Shift each sample of (B, D, H, W, C) by (bottom - top, right - left)
    of its pads (top, bottom, right, left), SYMMETRIC boundary."""
    B, _, H, W, _ = x.shape
    dy, dx = pads[:, 1] - pads[:, 0], pads[:, 2] - pads[:, 3]
    iy = _reflect_index(torch.arange(H, device=x.device) + dy[:, None], H)
    ix = _reflect_index(torch.arange(W, device=x.device) + dx[:, None], W)
    return take_2d(x, iy[:, :, None].expand(B, H, W), ix[:, None, :].expand(B, H, W))


def _zoom(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Bottom-right crop of a bilinear upscale of each sample to (scale,
    scale): output row i is row scale - H + i of the resize (half-pixel
    centres, edge clamp)."""
    B, _, H, W, _ = x.shape
    s = scale.to(torch.float32)[:, None]
    i = torch.arange(H, dtype=torch.float32, device=x.device)[None]
    j = torch.arange(W, dtype=torch.float32, device=x.device)[None]
    cy = (((s - H) + i + 0.5) * (H / s) - 0.5).clamp(0.0, H - 1)
    cx = (((s - W) + j + 0.5) * (W / s) - 0.5).clamp(0.0, W - 1)
    return sample_bilinear_2d(x, cy[:, :, None].expand(B, H, W),
                              cx[:, None, :].expand(B, H, W), boundary="edge")


def _rotate(x: torch.Tensor, angle_deg: torch.Tensor) -> torch.Tensor:
    """Inverse rotation of each sample about the in-plane centre, bilinear,
    SYMMETRIC boundary."""
    _, _, H, W, _ = x.shape
    theta = angle_deg.to(torch.float32) * (math.pi / 180.0)
    cos, sin = torch.cos(theta)[:, None, None], torch.sin(theta)[:, None, None]
    ci, cj = (H - 1) / 2.0, (W - 1) / 2.0
    f32 = dict(dtype=torch.float32, device=x.device)
    ii = torch.arange(H, **f32)[:, None] * torch.ones((1, W), **f32) - ci
    jj = torch.ones((H, 1), **f32) * torch.arange(W, **f32)[None, :] - cj
    cy = ci + cos * ii - sin * jj
    cx = cj + sin * ii + cos * jj
    return sample_bilinear_2d(x, cy, cx, boundary="symmetric")


def _gamma(xs: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    """Each (sample, channel) volume: min-max -> pow(gamma) -> its mean and
    population std restored."""
    dims = (1, 2, 3)
    mn, sd = xs.mean(dims, keepdim=True), xs.std(dims, correction=0, keepdim=True)
    lo, hi = xs.amin(dims, keepdim=True), xs.amax(dims, keepdim=True)
    x_ = torch.pow((xs - lo) / (hi - lo + 1e-8), _per_sample(gamma)) * (hi - lo) + lo
    x_ = x_ - x_.mean(dims, keepdim=True)
    return x_ / (x_.std(dims, correction=0, keepdim=True) + 1e-8) * sd + mn


def _poor_scan(xs: torch.Tensor) -> torch.Tensor:
    """Bilinear down to int(0.75 H) square, nearest up to H x H, then cropped
    or zero-padded along W."""
    H, W = xs.shape[2], xs.shape[3]
    small = int(H * 0.75)
    x_ = resize_nearest_2d(resize_bilinear_2d(xs, small, small), H, H)
    if W < H:
        return x_[:, :, :, :W]
    return F.pad(x_, (0, 0, 0, W - H)) if W > H else x_


def _augment(d: Dict[str, torch.Tensor], image, label, dist_map, p: AugmentParams,
             train_obj: str):
    B, _, H, _, C = image.shape
    n = _image_channels(train_obj)

    def on(name, threshold):
        return _per_sample(d[name] > threshold)

    # geometric stage: image, label and dist_map as one stack, shared draws
    parts = [image, label] + ([dist_map] if dist_map is not None else [])
    x = torch.cat(parts, -1)
    if p.zoom_factor != 0.0:
        z = _zoom(x, d["zoom_scale"])
        if dist_map is not None:  # distances scale with the zoom
            c0 = C + label.shape[-1]
            z[..., c0:] *= _per_sample(d["zoom_scale"].to(torch.float32) / H)
        x = torch.where(on("zoom_on", p.tx_prob), z, x)
    if p.axial_hflip:
        x = torch.where(on("flip_on", 0.5), x.flip(3), x)
    if p.rotation_degree != 0:
        x = torch.where(on("rot_on", p.tx_prob), _rotate(x, d["rot_angle"]), x)
    if p.translate_factor != 0.0:
        x = torch.where(on("trans_on", p.tx_prob), _translate(x, d["trans_pads"]), x)

    # intensity stage: the first n image channels only
    xs, rest = x[..., :n], x[..., n:C]
    if train_obj == "lesion" and p.chan_shift_factor != 0:
        mask = _per_sample(d["cs_channel"]) == torch.arange(n, device=x.device)
        xs = torch.where(on("cs_on", p.tx_prob) & mask, _translate(xs, d["cs_pads"]), xs)
    if _gamma_on(p):
        coin = (d["gamma_channel"] > 0.5).reshape(B, 1, 1, 1, n)
        xs = torch.where(on("gamma_on", p.tx_prob) & coin, _gamma(xs, d["gamma"]), xs)
    if p.sim_poor_scan:
        coin = (d["poor_channel"] > 0.5).reshape(B, 1, 1, 1, n)
        xs = torch.where(on("poor_on", p.tx_prob) & coin, _poor_scan(xs), xs)
    if p.gauss_noise_stddev != 0:
        noisy = xs + _per_sample(d["noise_std"]) * d["noise"]
        xs = torch.where(on("noise_on", p.tx_prob), noisy, xs)

    master = on("master", 1.0 - p.prob)
    out_img = torch.where(master, torch.cat([xs, rest], -1), image)
    out_lbl = torch.where(master, x[..., C:C + label.shape[-1]], label)
    if dist_map is None:
        return out_img, out_lbl, None
    return out_img, out_lbl, torch.where(master, x[..., C + label.shape[-1]:], dist_map)


def draw(stream, shape, p: AugmentParams, train_obj: str = "lesion") -> Dict[str, torch.Tensor]:
    """The draws of one pass over a batch of ``shape`` from a
    ``draws.Stream``, in the program's order."""
    n = _image_channels(train_obj)
    B, D, H, W, _ = shape
    u = stream.uniform((B, len(UNIFORM_COLUMNS) + 2 * n))
    col = {k: u[:, i] for i, k in enumerate(UNIFORM_COLUMNS)}
    out = {k: col[k] for k in ("master", "zoom_on", "flip_on", "rot_on", "trans_on", "cs_on",
                               "gamma_on", "poor_on", "noise_on")}
    mh, mw = math.ceil(H * p.translate_factor), math.ceil(W * p.translate_factor)
    ch, cw = math.ceil(H * p.chan_shift_factor), math.ceil(W * p.chan_shift_factor)
    out["zoom_scale"] = _int_draw(col["zoom_u"], H, math.ceil(H * p.zoom_factor))
    out["rot_angle"] = -p.rotation_degree + col["rot_u"] * (2 * p.rotation_degree)
    out["trans_pads"] = torch.stack([_int_draw(col[f"trans_u{i}"], 0, m)
                                     for i, m in enumerate((mh, mh, mw, mw))], 1)
    out["cs_pads"] = torch.stack([_int_draw(col[f"cs_u{i}"], 0, m)
                                  for i, m in enumerate((ch, ch, cw, cw))], 1)
    out["cs_channel"] = _int_draw(col["cs_channel_u"], 0, 3)
    lo, hi = (p.gamma_correct if _gamma_on(p) else (0.0, 0.0))
    out["gamma"] = lo + col["gamma_u"] * (hi - lo)
    k = len(UNIFORM_COLUMNS)
    out["gamma_channel"], out["poor_channel"] = u[:, k:k + n], u[:, k + n:]
    out["noise_std"] = col["noise_std_u"] * p.gauss_noise_stddev
    if p.gauss_noise_stddev != 0:
        out["noise"] = stream.normal((B, D, H, W, n))
    return out


def augment(stream, image: torch.Tensor, label: torch.Tensor, params: Sequence,
            train_obj: str = "lesion"):
    """(image, label) of a (B, D, H, W, C) batch augmented in one pass."""
    p = AugmentParams.from_list(params)
    with torch.no_grad():
        d = draw(stream, image.shape, p, train_obj)
        img, lbl, _ = _augment(d, image.float(), label.float(), None, p, train_obj)
    return img, lbl
