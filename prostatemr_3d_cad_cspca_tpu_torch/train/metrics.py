"""Lesion candidates from a probability map, copied from the JAX package's
``train/metrics.py`` (host-side numpy): 3D connected components above a
threshold, scored by their peak probability. The rest of that module (FROC,
AP, AUROC, Dice) waits for the evaluation slice."""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

try:  # pragma: no cover
    from scipy import ndimage as _ndi
except Exception:  # pragma: no cover
    _ndi = None


def _label_components(mask: np.ndarray) -> Tuple[np.ndarray, int]:
    if _ndi is not None:
        return _ndi.label(mask)
    # Minimal fallback: 6-connected BFS labeling in NumPy.
    labels = np.zeros(mask.shape, np.int32)
    current = 0
    offsets = [(1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1)]
    for idx in zip(*np.nonzero(mask)):
        if labels[idx]:
            continue
        current += 1
        stack = [idx]
        labels[idx] = current
        while stack:
            z, y, x = stack.pop()
            for dz, dy, dx in offsets:
                n = (z + dz, y + dy, x + dx)
                if all(0 <= n[i] < mask.shape[i] for i in range(3)) \
                        and mask[n] and not labels[n]:
                    labels[n] = current
                    stack.append(n)
    return labels, current


def extract_lesion_candidates(
    prob: np.ndarray, threshold: float = 0.10, min_voxels: int = 10
) -> List[Dict]:
    """Candidate lesions from a (D,H,W) probability map: connected components
    above ``threshold``, scored by their peak probability."""
    mask = prob >= threshold
    labels, n = _label_components(mask)
    out = []
    for i in range(1, n + 1):
        comp = labels == i
        if comp.sum() < min_voxels:
            continue
        out.append({
            "mask": comp,
            "score": float(prob[comp].max()),
            "voxels": int(comp.sum()),
        })
    return out
