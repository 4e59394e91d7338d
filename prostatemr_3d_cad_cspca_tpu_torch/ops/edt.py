"""Euclidean distance transform for the boundary/surface loss, copied from
the JAX package's ``ops/edt.py`` (host-side numpy; nothing here imports
JAX).

The reference computes a per-class signed EDT of the one-hot label inside a
``tf.py_function`` with ``scipy.ndimage.distance_transform_edt``
(losses.py:82-96). Here, in order: the native C++ EDT (``utils.native``,
``native/edt.cpp`` built with ``g++``), scipy, and a pure-numpy
Felzenszwalb separable squared EDT. The loss calls
``signed_distance_map`` on the host where a batch carries no precomputed
``dist_map`` (``losses.SoftDicePlusBoundarySurface``).
"""

from __future__ import annotations

import numpy as np

try:  # pragma: no cover - env dependent
    from scipy.ndimage import distance_transform_edt as _scipy_edt
except Exception:  # pragma: no cover
    _scipy_edt = None


def _edt_1d_sq(f: np.ndarray) -> np.ndarray:
    """Felzenszwalb & Huttenlocher lower-envelope 1D squared distance transform."""
    n = f.shape[0]
    d = np.empty(n)
    v = np.zeros(n, dtype=np.int64)
    z = np.empty(n + 1)
    k = 0
    z[0], z[1] = -np.inf, np.inf
    for q in range(1, n):
        s = ((f[q] + q * q) - (f[v[k]] + v[k] * v[k])) / (2 * q - 2 * v[k])
        while s <= z[k]:
            k -= 1
            s = ((f[q] + q * q) - (f[v[k]] + v[k] * v[k])) / (2 * q - 2 * v[k])
        k += 1
        v[k] = q
        z[k] = s
        z[k + 1] = np.inf
    k = 0
    for q in range(n):
        while z[k + 1] < q:
            k += 1
        d[q] = (q - v[k]) ** 2 + f[v[k]]
    return d


def _numpy_edt(binary: np.ndarray) -> np.ndarray:
    """Exact EDT of a binary mask (distance from zeros... matches scipy's
    distance_transform_edt: distance of nonzero voxels to nearest zero? No —
    scipy gives each nonzero voxel the distance to the nearest ZERO voxel).
    Here: distance from every voxel to the nearest zero voxel."""
    INF = 1e20
    f = np.where(binary, INF, 0.0).astype(np.float64)
    for axis in range(f.ndim):
        f = np.apply_along_axis(_edt_1d_sq, axis, f)
    return np.sqrt(f)


def _edt(binary: np.ndarray) -> np.ndarray:
    if _scipy_edt is not None:
        return _scipy_edt(binary)
    return _numpy_edt(binary)


def signed_distance_map(seg: np.ndarray) -> np.ndarray:
    """Signed EDT per class channel (reference losses.py:82-92).

    seg: (..., D, H, W, C) one-hot foreground channels (already [...,1:]).
    Positive outside the object, negative (shifted by 1) inside; zero map for
    empty channels.
    """
    seg = np.asarray(seg)
    res = np.zeros(seg.shape, dtype=np.float32)
    flat = seg.reshape((-1,) + seg.shape[-4:]) if seg.ndim > 4 else seg[None]
    out = res.reshape(flat.shape)

    try:  # native C++ path (fastest; see native/edt.cpp)
        from ..utils.native import signed_distance_3d as _native_sdm
    except Exception:  # pragma: no cover
        _native_sdm = None

    for b in range(flat.shape[0]):
        for c in range(flat.shape[-1]):
            posmask = flat[b, ..., c].astype(bool)
            if not posmask.any():
                continue
            native = _native_sdm(posmask) if _native_sdm is not None else None
            if native is not None:
                out[b, ..., c] = native
            else:
                negmask = ~posmask
                out[b, ..., c] = (
                    _edt(negmask) * negmask - (_edt(posmask) - 1) * posmask
                ).astype(np.float32)
    return res
