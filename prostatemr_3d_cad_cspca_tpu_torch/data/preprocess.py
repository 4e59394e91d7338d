"""Host-side z-score whitening, copied from the JAX package's
``data/preprocess.py::whitening`` (reference preprocess.py:29-39). The other
preprocessing helpers wait for the data slice."""

from __future__ import annotations

from typing import Optional

import numpy as np


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
