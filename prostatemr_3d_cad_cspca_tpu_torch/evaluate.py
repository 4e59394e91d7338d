"""Offline evaluation: checkpoint + labelled manifest -> detection
metrics, port of the JAX package's ``evaluate.py``.

  python -m prostatemr_3d_cad_cspca_tpu_torch.evaluate \\
    --MODEL weights/F1/model_weights_250.npz --MANIFEST valid-fold-1.csv \\
    --TRAIN_OBJ lesion --PROBA_ITER 5 --OUTPUT metrics.json [--DEVICE cuda]

Lesion task -> patient AUROC, lesion FROC partial AUC (mean sensitivity at
0.5/1/2/4 FP per case), lesion AP, mean Dice; zonal task -> per-class
TZ/PZ Dice. Comma-separated checkpoints evaluate their fold ensemble
(``ensemble.M1Ensemble``); ``--TTA 1`` fuses the axial flip; a cascaded
checkpoint scores its final stage on two exams (an ``image_path_2`` column;
without one the first exam feeds both). Undefined metrics (an AUROC with
one class of targets) are JSON null. Runs on the card unless ``--DEVICE
cpu`` says otherwise.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np

__all__ = ["run", "main", "build_parser"]


def build_parser():
    import argparse

    p = argparse.ArgumentParser(
        "prostatemr_3d_cad_cspca_tpu_torch.evaluate",
        description="Evaluate a trained checkpoint (or comma-separated fold "
                    "ensemble) on a labeled manifest.")
    p.add_argument("--MODEL", type=str, required=True,
                   help="checkpoint path; comma-separate K fold checkpoints "
                        "to evaluate their ensemble")
    p.add_argument("--MANIFEST", type=str, required=True,
                   help="labeled manifest (.csv/.tsv/.xlsx): p-id, "
                        "image_path, label_path, zones_path")
    p.add_argument("--TRAIN_OBJ", type=str, default="lesion", choices=["lesion", "zonal"])
    p.add_argument("--PROBA_ITER", type=int, default=1,
                   help="Monte-Carlo samples per case (reference "
                        "--UNET_PROBA_ITER, train_model.py:71)")
    p.add_argument("--THRESHOLD", type=float, default=0.10,
                   help="lesion candidate extraction threshold")
    p.add_argument("--TTA", type=int, default=0, help="fuse axial flip test-time augmentation")
    p.add_argument("--SEED", type=int, default=0)
    p.add_argument("--OUTPUT", type=str, default="",
                   help="write the metrics dict to this JSON path")
    p.add_argument("--DEVICE", type=str, default="cuda",
                   help="'cuda' (default) or 'cpu' for the plain PyTorch path")
    return p


class _LazySamples:
    """Re-iterable, O(1)-memory view of a labeled manifest: each pass loads
    and prepares one case at a time (the validators consume samples in
    order, so nothing stays resident)."""

    def __init__(self, rows, train_obj: str, probabilistic: bool, cascaded: bool = False):
        from .data.generators import load_sample

        self._load = load_sample
        self.rows = rows
        self.train_obj = train_obj
        self.probabilistic = probabilistic
        self.cascaded = cascaded

    def __len__(self):
        return len(self.rows)

    def __iter__(self):
        for row in self.rows:
            s = self._load(row, train_obj=self.train_obj, probabilistic=self.probabilistic,
                           mode="valid")
            if self.cascaded:
                # the two-exam contract (reference networks.py:111-112), as
                # serve._load_case: an image_path_2 column supplies exam 2,
                # else exam 1 feeds both; stacked on channels, the detect
                # wrapper splits them
                if (row.get("image_path_2") or "").strip():
                    row2 = dict(row, image_path=row["image_path_2"])
                    img2 = self._load(row2, train_obj=self.train_obj,
                                      probabilistic=self.probabilistic, mode="valid")["image"]
                else:
                    img2 = s["image"]
                s = dict(s, image=np.concatenate([s["image"], img2], -1))
            yield s


def run(args) -> Dict[str, float]:
    from .data.manifest import read_manifest
    from .device import resolve_device
    from .load import load_model_spec
    from .train.validation import AnatomySegmentationValidation, PCaDetectionValidation

    device = resolve_device(getattr(args, "DEVICE", "cuda"))
    model = load_model_spec(args.MODEL, device=device)
    detect = model.get_detect_model()
    if int(getattr(args, "TTA", 0)):
        from .ensemble import tta_detect

        detect = tta_detect(detect)
    if model.cascaded:
        # score the final stage, as serving does; the exams arrive stacked
        base_detect, c = detect, int(model.input_channels)

        def detect(params, x, rng=None):  # noqa: F811
            return base_detect(params, (x[..., :c], x[..., c:]), rng=rng)[-1]

    rows = read_manifest(args.MANIFEST)
    if not rows:
        raise ValueError(f"empty manifest: {args.MANIFEST}")
    samples = _LazySamples(rows, args.TRAIN_OBJ, probabilistic=bool(model.probabilistic),
                           cascaded=bool(model.cascaded))
    if args.TRAIN_OBJ == "lesion":
        validator = PCaDetectionValidation(
            detect, samples, proba_iter=int(args.PROBA_ITER),
            threshold=float(args.THRESHOLD), seed=int(args.SEED), device=device)
    else:
        if float(args.THRESHOLD) != 0.10:
            print("# note: --THRESHOLD is a lesion-candidate parameter; "
                  "inert for the zonal task", flush=True)
        validator = AnatomySegmentationValidation(
            detect, samples, proba_iter=int(args.PROBA_ITER), seed=int(args.SEED),
            device=device)
    # undefined metrics (e.g. patient AUROC with single-class targets) are
    # null, not NaN: NaN is not valid strict JSON
    metrics = {k: (round(float(v), 6) if np.isfinite(v) else None)
               for k, v in validator(None).items()}
    metrics["cases"] = len(samples)
    print(json.dumps(metrics), flush=True)
    if args.OUTPUT:
        tmp = args.OUTPUT + ".tmp"
        os.makedirs(os.path.dirname(os.path.abspath(args.OUTPUT)), exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(metrics, f, indent=1)
        os.replace(tmp, args.OUTPUT)
    return metrics


def main(argv=None, device=None) -> Dict[str, float]:
    """CLI entry; ``device`` overrides ``--DEVICE``."""
    args = build_parser().parse_args(argv)
    if device is not None:
        args.DEVICE = str(device)
    return run(args)


if __name__ == "__main__":
    main()
