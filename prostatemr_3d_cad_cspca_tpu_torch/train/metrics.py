"""Evaluation metrics, copied from the JAX package's ``train/metrics.py``
(host-side numpy): volume Dice, lesion candidates (3D connected components
above a threshold, scored by their peak probability), lesion-level FROC and
average precision, and patient-level AUROC.

The reference ships only ``dice_3d`` (callbacks.py:36-40) and imports its
FROC/AUROC tooling from modules it never released (callbacks.py:14,20);
the JAX package implements the intended suite (SURVEY.md §5.5): a candidate
hits a lesion when its overlap covers ``min_overlap`` of the lesion.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

try:  # pragma: no cover
    from scipy import ndimage as _ndi
except Exception:  # pragma: no cover
    _ndi = None


def dice_3d(predictions: np.ndarray, labels: np.ndarray) -> float:
    """Volume Dice (reference callbacks.py:36-40)."""
    epsilon = 1e-7
    dice_num = np.sum(predictions[labels == 1]) * 2.0
    dice_denom = np.sum(predictions) + np.sum(labels)
    return float((dice_num + epsilon) / (dice_denom + epsilon))


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


def froc_curve(
    case_probs: Sequence[np.ndarray],
    case_labels: Sequence[np.ndarray],
    threshold: float = 0.10,
    min_overlap: float = 0.10,
) -> Dict[str, np.ndarray]:
    """Lesion-level FROC: sensitivity vs mean false positives per case.

    A candidate hits a GT lesion when their overlap / GT volume exceeds
    ``min_overlap``; each GT lesion counts at most once per case.
    """
    all_scores, all_hits = [], []
    n_lesions, n_cases = 0, len(case_probs)
    for prob, lab in zip(case_probs, case_labels):
        gt_labels, n_gt = _label_components(lab > 0.5)
        n_lesions += n_gt
        cands = extract_lesion_candidates(prob, threshold)
        matched = set()
        for c in sorted(cands, key=lambda c: -c["score"]):
            hit_id = 0
            for g in range(1, n_gt + 1):
                gt = gt_labels == g
                if g not in matched and (c["mask"] & gt).sum() / max(gt.sum(), 1) >= min_overlap:
                    hit_id = g
                    break
            all_scores.append(c["score"])
            all_hits.append(hit_id > 0)
            if hit_id:
                matched.add(hit_id)
    order = np.argsort(all_scores)[::-1]
    hits = np.asarray(all_hits, bool)[order]
    tp = np.cumsum(hits)
    fp = np.cumsum(~hits)
    sens = tp / max(n_lesions, 1)
    fp_per_case = fp / max(n_cases, 1)
    return {"sensitivity": sens, "fp_per_case": fp_per_case,
            "scores": np.asarray(all_scores)[order],
            "n_lesions": n_lesions, "n_cases": n_cases}


def lesion_average_precision(
    case_probs: Sequence[np.ndarray],
    case_labels: Sequence[np.ndarray],
    **kwargs,
) -> float:
    """AP over ranked lesion candidates (hit = TP as in froc_curve)."""
    fr = froc_curve(case_probs, case_labels, **kwargs)
    sens = fr["sensitivity"]
    if len(sens) == 0:
        return 0.0
    # AP = mean over GT lesions of precision at each true-positive rank.
    hits = np.diff(np.concatenate([[0.0], sens])) > 1e-12
    ranks = np.arange(1, len(sens) + 1)
    precision = np.cumsum(hits) / ranks
    return float(np.sum(precision[hits]) / max(fr["n_lesions"], 1))


def patient_auroc(
    case_probs: Sequence[np.ndarray], case_targets: Sequence[int]
) -> float:
    """Patient-level AUROC from max lesion probability per case."""
    scores = np.asarray([float(p.max()) for p in case_probs])
    y = np.asarray(case_targets, int)
    pos, neg = scores[y == 1], scores[y == 0]
    if len(pos) == 0 or len(neg) == 0:
        return float("nan")
    greater = (pos[:, None] > neg[None, :]).sum()
    ties = (pos[:, None] == neg[None, :]).sum()
    return float((greater + 0.5 * ties) / (len(pos) * len(neg)))
