"""Batch inference CLI ("serving"), port of the JAX package's ``serve.py``
for window-sized cases of a deterministic M1.

  * one model, batched cases, the detect head on the card;
  * optional device-side output slimming before the host pull
    (``transfer_dtype="float16"``, ``transfer_channels="foreground"``);
  * outputs: ``<p-id>_detection.npy`` and ``predictions.json`` with ranked
    lesion candidates (train.metrics.extract_lesion_candidates).

Sliding-window cases, ``--MC_ITER > 1``, ``--TTA``, ``--DATA_PARALLEL`` and
``--SCAN_CHUNK`` raise and name the slice they wait for.

CLI:
  python -m prostatemr_3d_cad_cspca_tpu_torch.serve \\
      --MODEL weights/F1/model_weights_250.npz \\
      --MANIFEST feed/test.csv --OUTPUT_DIR out/ [--BATCH_SIZE 8] \\
      [--DEVICE cuda]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from .device import resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="M1 batch inference")
    p.add_argument("--MODEL", type=str, required=True,
                   help="checkpoint path (M1.save output, from either package)")
    p.add_argument("--MANIFEST", type=str, required=True,
                   help="csv/tsv/xlsx manifest with p-id,image_path columns")
    p.add_argument("--OUTPUT_DIR", type=str, required=True)
    p.add_argument("--TRAIN_OBJ", type=str, default="lesion")
    p.add_argument("--BATCH_SIZE", type=int, default=8)
    p.add_argument("--MC_ITER", type=int, default=1,
                   help="posterior samples (> 1 waits for the MC slice)")
    p.add_argument("--SW_OVERLAP", type=float, default=0.5,
                   help="sliding-window overlap (sliding window waits for the "
                        "inference slice)")
    p.add_argument("--WHITEN", type=int, default=0,
                   help="z-score inputs (for volumes not pre-whitened)")
    p.add_argument("--SEED", type=int, default=0)
    p.add_argument("--SAVE_UNCERTAINTY", type=int, default=1)
    p.add_argument("--DATA_PARALLEL", type=int, default=0,
                   help="multi-GPU serving waits for the multi-GPU slice")
    p.add_argument("--TRANSFER_DTYPE", type=str, default="float32",
                   choices=["float32", "float16"],
                   help="device-side output cast before the host pull")
    p.add_argument("--TTA", type=int, default=0,
                   help="flip test-time augmentation waits for the inference "
                        "slice")
    p.add_argument("--TRANSFER_CHANNELS", type=str, default="all",
                   choices=["all", "foreground"],
                   help="'foreground' drops the softmax background channel on "
                        "the device and rebuilds it host-side as 1 - sum")
    p.add_argument("--SCAN_CHUNK", type=int, default=0,
                   help="chunked batches wait for the inference slice")
    p.add_argument("--DEVICE", type=str, default="cuda",
                   help="'cuda' (default) or 'cpu' for the plain PyTorch path")
    return p


class InferenceSession:
    """Detect wrapper around a loaded M1 on one device.

    ``__call__(batch)`` takes a (B, D, H, W, C) array and returns
    ``(probs, None)`` as fp32 numpy; the second slot (MC uncertainty) stays
    None in this slice.
    """

    def __init__(self, model, mc_iter: int = 1, seed: int = 0, mesh=None,
                 transfer_dtype=None, tta: bool = False,
                 transfer_channels: str = "all",
                 scan_chunk: Optional[int] = None, device="cuda"):
        del seed  # deterministic models draw no random bits
        dev = resolve_device(device)
        if int(mc_iter) > 1:
            raise NotImplementedError("MC sampling waits for the MC slice")
        if tta:
            raise NotImplementedError("flip TTA waits for the inference slice")
        if mesh is not None:
            raise NotImplementedError(
                "data-parallel serving waits for the multi-GPU slice")
        if scan_chunk:
            raise NotImplementedError(
                "scan-chunked batches wait for the inference slice")
        if model.device != dev:
            model.to(dev)
        self.model = model
        self.device = dev
        self._out_dtype = (getattr(torch, str(transfer_dtype))
                           if transfer_dtype is not None else None)
        self._fg_only = str(transfer_channels) == "foreground"
        self._detect = model.get_detect_model()

    def __call__(self, batch):
        out = self._detect(None, batch)
        if self._fg_only:  # device-side background-channel drop
            out = out[..., 1:]
        if self._out_dtype is not None:
            out = out.to(self._out_dtype)
        host = out.float().cpu().numpy()
        return self._unpack_mean(host), None

    def _unpack_mean(self, fg: np.ndarray) -> np.ndarray:
        if not self._fg_only:
            return fg
        bg = 1.0 - fg.sum(axis=-1, keepdims=True)
        return np.concatenate([bg, fg], axis=-1)


def _load_case(row: Dict[str, str], train_obj: str, channels: int,
               whiten: bool) -> np.ndarray:
    from .data.generators import load_image

    vol = load_image(row, train_obj=train_obj)[..., :channels]
    if whiten:
        from .data.preprocess import whitening

        vol = np.stack([whitening(vol[..., c]) for c in range(vol.shape[-1])],
                       axis=-1)
    return vol


def run(args) -> List[Dict]:
    from .data.manifest import read_manifest
    from .load import load_model_spec
    from .train.metrics import extract_lesion_candidates

    device = resolve_device(getattr(args, "DEVICE", "cuda"))
    if int(getattr(args, "DATA_PARALLEL", 0)) > 1:
        raise NotImplementedError(
            "--DATA_PARALLEL waits for the multi-GPU slice")
    os.makedirs(args.OUTPUT_DIR, exist_ok=True)
    model = load_model_spec(args.MODEL, seed=args.SEED, device=device)
    tdt = getattr(args, "TRANSFER_DTYPE", "float32")
    session = InferenceSession(
        model, mc_iter=args.MC_ITER, seed=args.SEED,
        transfer_dtype=None if tdt == "float32" else tdt,
        tta=bool(getattr(args, "TTA", 0)),
        transfer_channels=getattr(args, "TRANSFER_CHANNELS", "all"),
        scan_chunk=int(getattr(args, "SCAN_CHUNK", 0)) or None, device=device)
    window = tuple(model.input_spatial_dims)
    rows = read_manifest(args.MANIFEST)

    results: List[Dict] = []
    pending: List[tuple] = []

    def _emit(pid: str, probs: np.ndarray) -> Dict:
        det_path = os.path.join(args.OUTPUT_DIR, f"{pid}_detection.npy")
        np.save(det_path, probs.astype(np.float32))
        entry: Dict = {"p-id": pid, "detection_path": det_path}
        fg = probs[..., -1]
        cands = sorted(extract_lesion_candidates(fg), key=lambda c: -c["score"])
        entry["lesion_candidates"] = [
            {"score": round(c["score"], 6), "voxels": c["voxels"]}
            for c in cands[:10]]
        entry["case_score"] = round(float(fg.max()), 6)
        return entry

    def flush():
        if not pending:
            return
        ids, vols = zip(*pending)
        probs, _ = session(np.stack(vols))
        for i, pid in enumerate(ids):
            results.append(_emit(pid, probs[i]))
        pending.clear()

    for row in rows:
        pid = row.get("p-id", os.path.basename(row["image_path"]))
        vol = _load_case(row, args.TRAIN_OBJ, model.input_channels,
                         bool(args.WHITEN))
        if tuple(vol.shape[:-1]) != window:
            raise NotImplementedError(
                f"{pid}: shape {tuple(vol.shape[:-1])} differs from the window "
                f"{window}; sliding-window inference waits for the inference "
                "slice")
        pending.append((pid, vol))
        if len(pending) >= args.BATCH_SIZE:
            flush()
    flush()

    summary_path = os.path.join(args.OUTPUT_DIR, "predictions.json")
    with open(summary_path, "w") as f:
        json.dump(results, f, indent=2)
    print(f"{len(results)} cases -> {summary_path}", flush=True)
    return results


def main(argv=None, device=None):
    """CLI entry; ``device`` overrides ``--DEVICE``."""
    args, _ = build_parser().parse_known_args(argv)
    if device is not None:
        args.DEVICE = str(device)
    return run(args)


if __name__ == "__main__":
    main()
