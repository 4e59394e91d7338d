"""Train-time validation, port of the JAX package's ``train/validation.py``
(the callbacks the reference left as 'TBA' stubs, train_model.py:240-245):

* ``PCaDetectionValidation``  — lesion task: case-wise detection
  probabilities -> patient AUROC, lesion FROC partial AUC, lesion AP, mean
  Dice;
* ``AnatomySegmentationValidation`` — zonal task: per-class (TZ/PZ) Dice.

Both take an iterable of {'image', 'detection'} samples and a detect
function ``detect(params, inputs, rng=...)`` (``M1.get_detect_model()``;
``params`` None runs the model's own weights). Case i draws from
``prng.fold_in(rng, i)`` of a generator seeded with ``seed``; Monte-Carlo
aggregation (UNET_PROBA_ITER, train_model.py:71) goes through
``infer.mc_predict``. The generator lives on ``device``, the model's.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable

import numpy as np
import torch

from .. import prng
from ..infer import mc_predict
from .metrics import dice_3d, froc_curve, lesion_average_precision, patient_auroc


def _reiterable(valid_samples: Iterable):
    """Keep re-iterable sequences (lists, evaluate._LazySamples) as they are,
    so lazy views stay O(1) in memory; materialize one-shot generators,
    which the first validation pass would exhaust."""
    return valid_samples if hasattr(valid_samples, "__len__") else list(valid_samples)


def _case_probs(detect_fn: Callable, params, samples, rng: torch.Generator,
                proba_iter: int = 1):
    probs, labels = [], []
    for i, s in enumerate(samples):
        img = np.asarray(s["image"])[None]
        k = prng.fold_in(rng, i)
        if proba_iter > 1:
            p = mc_predict(detect_fn, params, img, k, num_samples=proba_iter)
        else:
            p = detect_fn(params, img, rng=k)
        probs.append(p[0].float().cpu().numpy())
        labels.append(np.asarray(s["detection"]))
    return probs, labels


class PCaDetectionValidation:
    """Lesion-level validation (csPCa detection)."""

    def __init__(self, detect_fn: Callable, valid_samples: Iterable, proba_iter: int = 1,
                 threshold: float = 0.10, seed: int = 0, device="cuda"):
        self.detect_fn = detect_fn
        self.samples = _reiterable(valid_samples)
        self.proba_iter = proba_iter
        self.threshold = threshold
        self.seed = seed
        self.device = device

    def __call__(self, params) -> Dict[str, float]:
        probs, labels = _case_probs(self.detect_fn, params, self.samples,
                                    prng.generator(self.seed, self.device), self.proba_iter)
        fg_probs = [p[..., 1] for p in probs]
        fg_labels = [lab[..., 1] for lab in labels]
        case_targets = [int(lab.max() > 0.5) for lab in fg_labels]
        froc = froc_curve(fg_probs, fg_labels, threshold=self.threshold)
        # partial FROC AUC: mean sensitivity at 0.5, 1, 2, 4 FP a case
        sens_at = []
        for fp in (0.5, 1.0, 2.0, 4.0):
            idx = np.searchsorted(froc["fp_per_case"], fp, side="right") - 1
            sens_at.append(float(froc["sensitivity"][idx]) if idx >= 0 else 0.0)
        dices = [dice_3d((p >= 0.5).astype(np.float32), (lab > 0.5).astype(np.float32))
                 for p, lab in zip(fg_probs, fg_labels)]
        return {
            "auroc": patient_auroc(fg_probs, case_targets),
            "froc_pauc": float(np.mean(sens_at)),
            "lesion_ap": lesion_average_precision(fg_probs, fg_labels,
                                                  threshold=self.threshold),
            "dice": float(np.mean(dices)),
        }


class AnatomySegmentationValidation:
    """Zonal segmentation validation (WG/TZ/PZ Dice)."""

    def __init__(self, detect_fn: Callable, valid_samples: Iterable,
                 class_names=("WG", "TZ", "PZ"), proba_iter: int = 1, seed: int = 0,
                 device="cuda"):
        self.detect_fn = detect_fn
        self.samples = _reiterable(valid_samples)
        self.class_names = class_names
        self.proba_iter = proba_iter
        self.seed = seed
        self.device = device

    def __call__(self, params) -> Dict[str, float]:
        probs, labels = _case_probs(self.detect_fn, params, self.samples,
                                    prng.generator(self.seed, self.device), self.proba_iter)
        out: Dict[str, float] = {}
        for c, name in enumerate(self.class_names):
            if c == 0:
                continue  # the whole-gland complement
            dices = [dice_3d((np.argmax(p, -1) == c).astype(np.float32),
                             (lab[..., c] > 0.5).astype(np.float32))
                     for p, lab in zip(probs, labels)]
            out[f"dice_{name}"] = float(np.mean(dices))
        out["dice_mean"] = float(np.mean(list(out.values())))
        return out
