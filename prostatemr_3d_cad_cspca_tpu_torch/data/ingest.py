"""Offline ingest: raw volumes -> preprocessed feed + fold manifests, the
port's copy of the JAX package's ``data/ingest.py`` (host numpy and
scipy over the port's ``data/preprocess.py``; the same bytes out).

    python -m prostatemr_3d_cad_cspca_tpu_torch.data.ingest --MANIFEST raw.csv \
      --OUTPUT_DIR feed/ [--SIZE 20 160 160] [--SPACING 3.0 0.5 0.5] [--FOLDS 5]

One command takes a raw-case manifest, applies the reference's
preprocessing contract (spacing resample -> percentile-clipped z-score
whitening -> center crop-or-pad, preprocess.py:29-98), writes the processed
.npy volumes, and emits ``train-fold-{k}`` / ``valid-fold-{k}`` CSV
manifests that the training CLI reads (--TRAIN_XLSX_PREFIX contract,
reference train_model.py:107-110).

Raw-case contract (one manifest row per case, same schema as the feed
files plus an optional ``spacing`` column):
  p-id, image_path, label_path, zones_path [, spacing]
Volumes are ``.npy`` (D,H,W[,C]) or ``.npz`` archives; an ``.npz`` may
carry its own ``spacing`` array (D,H,W order, mm/voxel). When neither a
manifest ``spacing`` column ("3.0x0.5x0.5") nor an npz spacing is present
the volume is assumed already at target spacing and only
whitening + crop-or-pad run. Resampling uses ``preprocess.resample_volume``
(scipy cubic spline / nearest-neighbor); SimpleITK is not required.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .manifest import read_manifest
from .preprocess import (resample_volume, resize_image_with_crop_or_pad,
                         whitening)

__all__ = ["ingest_case", "run", "main", "build_parser"]


def _load_volume(path: str) -> Tuple[np.ndarray, Optional[Tuple[float, ...]]]:
    """Load .npy / .npz; returns (volume, spacing-or-None)."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            spacing = (tuple(float(s) for s in z["spacing"])
                       if "spacing" in z.files else None)
            if "image" in z.files:
                vol = z["image"]
            else:  # one volume array besides the spacing vector
                keys = [k for k in z.files if k != "spacing"]
                if len(keys) != 1:
                    raise ValueError(
                        f"{path}: ambiguous npz — expected an 'image' array "
                        f"(plus optional 'spacing'), found {z.files}")
                vol = z[keys[0]]
            if vol.ndim < 3:
                raise ValueError(
                    f"{path}: volume array must be (D,H,W[,C]), got shape "
                    f"{vol.shape}")
        return vol, spacing
    return np.load(path), None


def _parse_spacing(text: str) -> Optional[Tuple[float, ...]]:
    text = (text or "").strip()
    if not text:
        return None
    return tuple(float(s) for s in text.replace("x", " ").split())


def ingest_case(
    row: Dict[str, str],
    out_dir: str,
    size: Sequence[int] = (20, 160, 160),
    out_spacing: Optional[Sequence[float]] = None,
    whiten_percentile: Optional[float] = 99.5,
) -> Dict[str, str]:
    """Preprocess one raw case; returns the processed manifest row.

    Images: [resample ->] per-channel whitening -> center crop-or-pad
    (constant zero pad — whitened background). Labels/zones: nearest
    -neighbor resample, crop-or-pad, dtype preserved (class ids intact).
    """
    pid = row["p-id"]
    man_spacing = _parse_spacing(row.get("spacing", ""))
    # Resolve ONE spacing for the whole case up front: image/label/zones are
    # co-registered volumes of the same exam, so they must resample together
    # or not at all — a per-volume decision would silently misalign a
    # spacing-carrying .npz image against plain .npy labels.
    case_spacing = man_spacing
    img_src = (row.get("image_path") or "").strip()
    if img_src.endswith(".npz"):
        _, npz_spacing = _load_volume(img_src)
        if npz_spacing is not None:
            if man_spacing is not None and \
                    tuple(npz_spacing) != tuple(man_spacing):
                raise ValueError(
                    f"{pid}: npz-embedded spacing {npz_spacing} contradicts "
                    f"the manifest spacing column {man_spacing}")
            case_spacing = npz_spacing
    out_row = {"p-id": pid}
    for col, is_label in (("image_path", False), ("label_path", True),
                          ("zones_path", True)):
        src = (row.get(col) or "").strip()
        if not src:  # optional column (e.g. lesion task without zones)
            out_row[col] = ""
            continue
        vol, npz_spacing = _load_volume(src)
        spacing = npz_spacing or case_spacing
        if out_spacing is not None and spacing is not None \
                and tuple(spacing) != tuple(out_spacing):
            vol = resample_volume(vol, spacing, out_spacing, is_label=is_label)
        if not is_label:
            vol = np.asarray(vol, np.float32)
            if vol.ndim == 3:
                vol = vol[..., None]
            # reference whitening (preprocess.py:29-39) operates on one
            # volume at a time -> per-channel here (each MRI sequence has
            # its own intensity distribution)
            vol = np.stack([whitening(vol[..., c], whiten_percentile)
                            for c in range(vol.shape[-1])], axis=-1)
        vol = resize_image_with_crop_or_pad(vol, tuple(size),
                                            mode="constant")
        dst = os.path.join(out_dir, f"{pid}_{col.replace('_path', '')}.npy")
        np.save(dst, vol)
        out_row[col] = dst
    return out_row


def _write_manifest(path: str, rows: List[Dict[str, str]]):
    cols = ["p-id", "image_path", "label_path", "zones_path"]
    with open(path, "w", newline="") as fh:
        w = csv.DictWriter(fh, fieldnames=cols)
        w.writeheader()
        for r in rows:
            w.writerow({c: r.get(c, "") for c in cols})


def run(args) -> List[str]:
    """Ingest every case, then write K-fold train/valid manifest pairs
    (deterministic shuffle; fold k holds out the k-th shard — the
    reference's 5-fold feed layout, tf2.5/feed/)."""
    os.makedirs(args.OUTPUT_DIR, exist_ok=True)
    rows = read_manifest(args.MANIFEST)
    assert rows, f"empty manifest: {args.MANIFEST}"
    done = [
        ingest_case(
            r, args.OUTPUT_DIR, size=tuple(args.SIZE),
            out_spacing=(tuple(args.SPACING) if args.SPACING else None),
            whiten_percentile=(args.WHITEN_PERCENTILE or None))
        for r in rows
    ]
    print(f"Preprocessed {len(done)} cases -> {args.OUTPUT_DIR}", flush=True)

    k = int(args.FOLDS)
    written = []
    if k >= 2:
        if len(done) < k:
            raise ValueError(
                f"--FOLDS {k} needs at least {k} cases (got {len(done)}): "
                "every fold must hold out a non-empty validation shard")
        order = np.random.default_rng(args.SEED).permutation(len(done))
        shards = [sorted(order[i::k]) for i in range(k)]
        for f in range(k):
            valid = [done[i] for i in shards[f]]
            train = [done[i] for f2, sh in enumerate(shards) if f2 != f
                     for i in sh]
            for tag, part in (("train", train), ("valid", valid)):
                p = os.path.join(args.OUTPUT_DIR, f"{tag}-fold-{f + 1}.csv")
                _write_manifest(p, part)
                written.append(p)
        sizes = sorted({len(sh) for sh in shards})
        held = (str(sizes[0]) if len(sizes) == 1
                else f"{sizes[0]}-{sizes[-1]}")
        print(f"Wrote {k}-fold manifests ({held} of {len(done)} cases "
              "held out per fold)", flush=True)
    else:  # single manifest, no split
        p = os.path.join(args.OUTPUT_DIR, "cases.csv")
        _write_manifest(p, done)
        written.append(p)
    return written


def build_parser():
    import argparse

    p = argparse.ArgumentParser(
        "prostatemr_3d_cad_cspca_tpu_torch.data.ingest",
        description="Raw bpMRI volumes -> preprocessed .npy feed + K-fold "
                    "train/valid manifests (reference preprocess.py "
                    "contract, no SimpleITK needed).")
    p.add_argument("--MANIFEST", type=str, required=True,
                   help="raw-case manifest (.csv/.tsv/.xlsx): p-id, "
                        "image_path, label_path, zones_path [, spacing]")
    p.add_argument("--OUTPUT_DIR", type=str, required=True)
    p.add_argument("--SIZE", type=int, nargs=3, default=[20, 160, 160],
                   help="output geometry D H W (reference README.md:31)")
    p.add_argument("--SPACING", type=float, nargs=3, default=None,
                   help="target voxel spacing D H W (mm); omit to skip "
                        "resampling")
    p.add_argument("--WHITEN_PERCENTILE", type=float, default=99.5,
                   help="symmetric intensity-clip percentile before "
                        "z-score; 0 disables clipping")
    p.add_argument("--FOLDS", type=int, default=5)
    p.add_argument("--SEED", type=int, default=0)
    return p


def main(argv=None) -> List[str]:
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
