"""Train-time 3D augmentation on the device, port of the JAX package's
``augment.py`` (reference: tf2.5/scripts/model/augmentations.py:36-378).

The reference augments one sample at a time in tf.data CPU workers; JAX
vmaps one jitted function over the batch. Here one pass covers the whole
batch: every transform runs once on a (B, D, H, W, C) tensor with a
per-sample select, so a step's launches do not grow with the batch size.
Geometric warps are gathers at fp32 coordinates (``ops.resample``); the
scale, the shifts and the angle stay device tensors that enter the index
arithmetic, and no value is read back to the host, so the pass never
synchronises with the device.

Semantics, as the JAX package's (reference line numbers):

  * master gate: apply anything iff U() > 1 - prob                  (:51)
  * per-transform gates: apply iff U() > tx_prob                    (:59-111)
  * zoom      — upscale to a random size in [H, ceil(H*zoom)) then take the
                BOTTOM-RIGHT HxW crop, edge-clamped; a dist_map is also
                multiplied by scale/H                                (:139-152)
  * hflip     — flip along W with p=0.5                              (:156-163)
  * rotate    — inverse-rotation bilinear sampling about
                ((H-1)/2, (W-1)/2) with SYMMETRIC reflection         (:219-236)
  * translate — integer shift by (pad_bottom - pad_top,
                pad_right - pad_left) with SYMMETRIC reflection      (:167-181)
  * channel-shift — the same kind of shift on ONE MRI channel (lesion
                task only; labels untouched)                         (:185-215)
  * gamma     — per-channel coin; min-max -> pow(gamma) -> restore the
                original mean and (population) std                   (:275-310)
  * poor-scan — per-channel coin; bilinear down to int(0.75*H) square then
                nearest back up to HxH (the reference uses shape[1] for both
                output dims), cropped or zero-padded to W            (:240-271)
  * noise     — additive U(0, stddev) * N(0, 1) on image channels only
                                                                     (:314-326)

Geometric draws are shared by image, label and dist_map; intensity
transforms touch only the first ``n_img_ch`` image channels (3 for the
lesion task, 1 for zonal), never the label nor channels appended to the
image (a probabilistic model's label channel). Every gate is a select over
both branches, as JAX's ``jnp.where`` is. The pass works in fp32.

Draws (``prng``): ``augment_batch`` takes a ``torch.Generator`` on the
batch's device, from which it draws, for the whole batch at once, one
uniform block of shape (B, 22 + 2 n_img_ch) — its columns in the order of
:data:`UNIFORM_COLUMNS`, then ``gamma_channel`` and ``poor_channel`` — and,
when noise is on, the standard normal ``noise`` of shape (B, D, H, W,
n_img_ch); or ``prng.Draws``, whose draws ``augment`` and
``augment_noise`` take those two (a data-parallel shard's rows of the
global batch's, ``prng.rows``). Or it takes a mapping that replays the draws by name
(:data:`DRAW_NAMES`), each with a leading batch axis: the gates as their
uniforms (so the thresholds are applied here too), the rest as values.
"""

from __future__ import annotations

import dataclasses
import math
from collections.abc import Mapping
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import prng
from .device import resolve_device
from .ops.resample import (_reflect_index, resize_bilinear_2d, resize_nearest_2d,
                           sample_bilinear_2d, take_2d)
from .utils.profiling import annotate

# the uniform block's columns (per sample); ``*_u`` become the values below
UNIFORM_COLUMNS = ("master", "zoom_on", "zoom_u", "flip_on", "rot_on", "rot_u", "trans_on",
                   "trans_u0", "trans_u1", "trans_u2", "trans_u3", "cs_on", "cs_u0", "cs_u1",
                   "cs_u2", "cs_u3", "cs_channel_u", "gamma_on", "gamma_u", "poor_on",
                   "noise_on", "noise_std_u")
# a replay's names: gates (uniforms), then values; shapes after the batch axis
DRAW_NAMES = {
    "master": (), "zoom_on": (), "flip_on": (), "rot_on": (), "trans_on": (), "cs_on": (),
    "gamma_on": (), "poor_on": (), "noise_on": (),
    "zoom_scale": (),       # int in [H, ceil(H * zoom))
    "rot_angle": (),        # degrees in [-rotation_degree, rotation_degree)
    "trans_pads": (4,),     # ints (top, bottom, right, left): [0, ceil(H f)), [0, ceil(W f))
    "cs_pads": (4,),        # the same for the channel shift's factor
    "cs_channel": (),       # int in [0, 3)
    "gamma": (),            # in [gamma_correct[0], gamma_correct[1])
    "gamma_channel": ("n_img_ch",),  # uniforms: channel c's coin is > 0.5
    "poor_channel": ("n_img_ch",),   # the same for the poor scan
    "noise_std": (),        # in [0, gauss_noise_stddev)
    "noise": ("D", "H", "W", "n_img_ch"),  # standard normal
}


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


def as_params(params) -> AugmentParams:
    return params if isinstance(params, AugmentParams) else AugmentParams.from_list(params)


def _image_channels(train_obj: str) -> int:
    """The MRI channels the intensity transforms touch."""
    return 3 if train_obj == "lesion" else 1


def _gamma_on(p: AugmentParams) -> bool:
    return bool(p.gamma_correct) and (p.gamma_correct[0] != 0 or p.gamma_correct[1] != 0)


def _int_draw(u: torch.Tensor, lo, hi) -> torch.Tensor:
    """An integer in [lo, hi) from a uniform (lo where the range is empty)."""
    span = hi - lo
    return (lo + torch.floor(u * span)).clamp(max=hi - 1).clamp(min=lo).to(torch.int64)


def draw(rng, shape, params: AugmentParams, train_obj: str = "lesion",
         device=None) -> Dict[str, torch.Tensor]:
    """The draws of one augmentation pass over a batch of ``shape`` (B, D,
    H, W, C): from a generator (module docstring), or a replayed mapping's
    entries on ``device``."""
    p, n = params, _image_channels(train_obj)
    B, D, H, W, _ = shape
    if isinstance(rng, Mapping):
        return {k: torch.as_tensor(rng[k], device=device) for k in DRAW_NAMES if k in rng}
    if not isinstance(rng, (torch.Generator, prng.Draws)):
        raise ValueError("augmentation draws need rng: a torch.Generator on the batch's "
                         "device, prng.Draws or a mapping of replayed draws")
    dev = rng.device if isinstance(rng, torch.Generator) else device
    u = prng.uniform(rng, (B, len(UNIFORM_COLUMNS) + 2 * n), dev, "augment")
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
        out["noise"] = prng.normal(rng, (B, D, H, W, n), dev, "augment_noise")
    return out


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


def _f32(t, device=None):
    return torch.as_tensor(t, device=device).to(torch.float32)


def augment_batch(rng, batch: Dict, params, train_obj: str = "lesion") -> Dict:
    """Augment a batch dict ('image' (B, D, H, W, C), 'detection', and an
    optional 'dist_map' warped with its label; other entries pass through)
    in one pass: a new dict, the three entries in fp32 on the image's
    device. ``rng``: a generator on that device, an int seed, or a mapping
    of replayed draws (module docstring)."""
    p = as_params(params)
    image = _f32(batch["image"])
    dev = image.device
    label = _f32(batch["detection"], dev)
    dm = _f32(batch["dist_map"], dev) if "dist_map" in batch else None
    with annotate("augment"), torch.no_grad():
        d = draw(prng.as_rng(rng, dev), image.shape, p, train_obj, dev)
        img, lbl, dm = _augment(d, image, label, dm, p, train_obj)
    out = dict(batch, image=img, detection=lbl)
    if dm is not None:
        out["dist_map"] = dm
    return out


def augment_sample(rng, image, label, params, train_obj: str = "lesion", dist_map=None):
    """Augment one (D, H, W, C) sample, as the JAX package's
    ``augment_sample``: (image, label) or (image, label, dist_map). A
    mapping replays this sample's draws, without the batch axis."""
    if isinstance(rng, Mapping):
        rng = {k: torch.as_tensor(v)[None] for k, v in rng.items()}
    batch = {"image": torch.as_tensor(image)[None], "detection": torch.as_tensor(label)[None]}
    if dist_map is not None:
        batch["dist_map"] = torch.as_tensor(dist_map)[None]
    out = augment_batch(rng, batch, params, train_obj)
    got = (out["image"][0], out["detection"][0])
    return got + (out["dist_map"][0],) if dist_map is not None else got


def make_augment_fn(params, train_obj: str = "lesion", device="cuda"):
    """(rng, batch) -> batch on ``device``: the batch (numpy or tensors)
    moved there and augmented (``data.batch_iterator``'s ``augment_fn``)."""
    p, dev = as_params(params), resolve_device(device)

    def augment(rng, batch):
        on = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        return augment_batch(rng, on, p, train_obj)

    return augment
