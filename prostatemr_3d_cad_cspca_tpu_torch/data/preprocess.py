"""Preprocessing for bpMRI volumes, port of the JAX package's
``data/preprocess.py`` (reference: tf2.5/scripts/preprocess.py). The
host-side numpy helpers are copied:

  * whitening                     — :29-39 (percentile clip + z-score)
  * center_crop                   — :42-49
  * resample_img                  — :52-71 (SimpleITK; host-side only)
  * resize_image_with_crop_or_pad — :74-98 (symmetric crop/pad)
  * resample_volume               — the SimpleITK-free twin of resample_img
                                    (scipy)

``whitening_device`` is the torch twin of ``whitening`` for volumes already
on the device.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

try:  # pragma: no cover - not in every image; keep the API surface
    import SimpleITK as sitk

    _HAS_SITK = True
except Exception:  # pragma: no cover
    sitk = None
    _HAS_SITK = False


def whitening(image: np.ndarray, percentile: Optional[float] = None) -> np.ndarray:
    """Z-score normalize to mean 0 / std 1, optionally clipping symmetric
    intensity percentiles first. A constant image maps to all-zeros."""
    image = np.asarray(image, dtype=np.float32)
    if percentile is not None:
        lo, hi = np.percentile(image, [100 - percentile, percentile])
        # keep fp32: np.clip with float64 scalar bounds promotes (NEP 50)
        image = np.clip(image, lo, hi).astype(np.float32, copy=False)
    std = image.std()
    if std == 0:
        return np.zeros_like(image)
    return (image - image.mean()) / std


def _span(start: int, size: int) -> slice:
    return slice(start, start + size)


def center_crop(
    img: np.ndarray,
    cropz: int,
    cropx: int,
    cropy: int,
    center_2d_coords: Optional[Tuple[float, float]] = None,
    multi_channel: bool = False,
) -> np.ndarray:
    """Crop (cropz, cropx, cropy) around the volume center, or around given
    in-plane coordinates (reference preprocess.py:42-49).

    The crop window is anchored at ``center - size//2`` per axis; the z axis
    always uses the volume center.
    """
    if center_2d_coords:
        cx, cy = (int(c) for c in center_2d_coords)
    else:
        cx, cy = img.shape[1] // 2, img.shape[2] // 2
    window = (
        _span(img.shape[0] // 2 - cropz // 2, cropz),
        _span(cx - cropx // 2, cropx),
        _span(cy - cropy // 2, cropy),
    )
    if multi_channel:
        window += (slice(None),)
    return img[window]


def resample_img(itk_image, out_spacing=(2.0, 2.0, 2.0), is_label: bool = False):
    """Resample a SimpleITK image to a target voxel spacing, preserving the
    physical extent: B-spline interpolation for images, nearest-neighbor for
    label maps (reference preprocess.py:52-71).

    Host-side ingest only — the training input format is preprocessed .npy,
    which never touches SimpleITK.
    """
    if not _HAS_SITK:
        raise ImportError(
            "SimpleITK is not available in this environment; resample_img is "
            "a host-side ingest utility and needs it. Preprocessed .npy "
            "volumes (the training input format) do not."
        )
    out_spacing = tuple(float(s) for s in out_spacing)
    new_size = [
        int(np.round(extent * (spacing / target)))
        for extent, spacing, target in zip(
            itk_image.GetSize(), itk_image.GetSpacing(), out_spacing
        )
    ]
    return sitk.Resample(
        itk_image,
        new_size,
        sitk.Transform(),
        sitk.sitkNearestNeighbor if is_label else sitk.sitkBSpline,
        itk_image.GetOrigin(),
        out_spacing,
        itk_image.GetDirection(),
        float(itk_image.GetPixelIDValue()),
        itk_image.GetPixelID(),
    )


def _fit_axis(extent: int, target: int) -> Tuple[slice, Tuple[int, int]]:
    """How to take an axis of length ``extent`` to length ``target``:
    returns (crop slice, (pad_before, pad_after)). Exactly one of the two is
    non-trivial; both cropping and padding center the retained region, with
    the extra voxel (odd difference) going to the trailing side."""
    if extent < target:
        lo = (target - extent) // 2
        return slice(None), (lo, target - extent - lo)
    start = (extent - target) // 2
    return _span(start, target), (0, 0)


def resize_image_with_crop_or_pad(
    image: np.ndarray, img_size: Sequence[int] = (64, 64, 64), **kwargs
) -> np.ndarray:
    """Center crop-or-pad each axis to a fixed size (reference
    preprocess.py:74-98). Trailing axes beyond ``len(img_size)`` (e.g. a
    channel axis) pass through untouched. ``kwargs`` go to ``np.pad``.
    """
    assert isinstance(image, (np.ndarray, np.generic))
    assert image.ndim - len(img_size) in (0, 1), "Example size doesnt fit image size"
    fits = [_fit_axis(extent, target) for extent, target in zip(image.shape, img_size)]
    crop = tuple(sl for sl, _ in fits)
    pad = [p for _, p in fits] + [(0, 0)] * (image.ndim - len(img_size))
    return np.pad(image[crop], pad, **kwargs)


def resample_volume(
    volume: np.ndarray,
    in_spacing: Sequence[float],
    out_spacing: Sequence[float],
    is_label: bool = False,
) -> np.ndarray:
    """Spacing-resample a raw numpy volume — the SimpleITK-free twin of
    ``resample_img`` (reference preprocess.py:52-71): target size
    ``round(extent * in/out)`` per axis, cubic B-spline interpolation for
    images, nearest-neighbor for label maps.

    Sampling convention matches the reference EXACTLY: the origin is
    unchanged and output voxel ``i`` sits at physical ``i * out_spacing``,
    i.e. at input-index coordinate ``i * out_spacing / in_spacing``
    (``SetOutputOrigin(itk_image.GetOrigin())`` + ``SetOutputSpacing``,
    preprocess.py:60-62). ``scipy.ndimage.map_coordinates(order=3)`` with
    prefiltering is the same interpolating cubic-B-spline family as
    ``sitkBSpline``; the quantified agreement bound lives in
    tests/test_ingest.py::test_resample_analytic_field_bound and
    docs/PARITY.md. Two documented edge deviations: boundary handling is
    edge-replicate (sitk mirrors the spline prefilter and fills samples
    OUTSIDE the input extent with ``GetPixelIDValue()`` — a pixel-TYPE enum,
    i.e. the reference fills out-of-domain voxels with a constant like 8.0;
    an unintentional quirk we do not reproduce).

    volume: (D, H, W) or (D, H, W, C); spacings are per spatial axis in the
    same (D, H, W) order.
    """
    from scipy import ndimage

    volume = np.asarray(volume)
    in_spacing = tuple(float(s) for s in in_spacing)
    out_spacing = tuple(float(s) for s in out_spacing)
    assert len(in_spacing) == len(out_spacing) == 3
    new_size = [
        int(np.round(extent * (sp / target)))
        for extent, sp, target in zip(volume.shape[:3], in_spacing, out_spacing)
    ]
    # physical point FIRST, then divide by the input spacing — the same
    # arithmetic order as sitk's TransformPhysicalPointToContinuousIndex,
    # so half-integer NN coordinates land on the same side of the fp razor
    axes = [(np.arange(n, dtype=np.float64) * t) / s
            for n, s, t in zip(new_size, in_spacing, out_spacing)]
    coords = np.meshgrid(*axes, indexing="ij")
    order = 0 if is_label else 3
    if volume.ndim == 4:  # channel axis untouched
        out = np.stack([
            ndimage.map_coordinates(volume[..., c], coords, order=order,
                                    mode="nearest")
            for c in range(volume.shape[3])], axis=-1)
    else:
        out = ndimage.map_coordinates(volume, coords, order=order,
                                      mode="nearest")
    assert list(out.shape[:3]) == new_size, (out.shape, new_size)
    return out.astype(volume.dtype if is_label else np.float32)


def _percentiles(image: torch.Tensor, qs: Sequence[float]):
    """``jnp.percentile(image, q)`` for each q, JAX's 'linear' method and
    fp32 arithmetic: the sorted values at floor and ceil of q/100 (n - 1),
    weighted by the fraction. The positions depend only on the size, so
    they are worked out on the host; one sort on the device (``torch.
    quantile`` refuses more than 2**24 elements)."""
    flat = torch.sort(image.reshape(-1)).values
    n1 = np.float32(flat.numel()) - np.float32(1)
    out = []
    for q in qs:
        pos = (np.float32(q) / np.float32(100)) * n1
        lo, hi = np.floor(pos), np.ceil(pos)
        w_hi = pos - lo
        w_lo = np.float32(1) - w_hi
        out.append(flat[int(lo)] * float(w_lo) + flat[int(hi)] * float(w_hi))
    return out


def whitening_device(image: torch.Tensor, percentile: Optional[float] = None) -> torch.Tensor:
    """``whitening`` on a tensor where it lies, without a host sync: fp32,
    optionally clipped to the symmetric percentiles, then z-scored over all
    its elements; a constant image maps to zeros."""
    image = torch.as_tensor(image).to(torch.float32)
    if percentile is not None:
        lo, hi = _percentiles(image, (100 - percentile, percentile))
        image = torch.minimum(torch.maximum(image, lo), hi)
    mean, std = image.mean(), image.std(correction=0)
    return torch.where(std > 0, (image - mean) / std, image * 0.0)
