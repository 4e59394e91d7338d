"""Batch inference CLI ("serving"), port of the JAX package's ``serve.py``.

  * one model or a fold ensemble (``--MODEL f1.npz,f2.npz``), batched
    window-sized cases, the detect head on the card;
  * whole-gland cases larger than the training window go through
    Gaussian-blended sliding windows, same-shape cases in groups of up to 8
    (``infer.make_sliding_window_fn``);
  * Monte-Carlo dropout models emit mean and per-voxel std over
    ``--MC_ITER`` posterior samples; ``--TTA 1`` averages the axial
    left-right flip; ``--SCAN_CHUNK`` runs large batches chunk by chunk;
  * optional device-side output slimming before the host pull
    (``--TRANSFER_DTYPE float16``, ``--TRANSFER_CHANNELS foreground``);
  * outputs: ``<p-id>_detection.npy`` (+ ``_uncertainty.npy``) and
    ``predictions.json`` with ranked lesion candidates
    (train.metrics.extract_lesion_candidates), in manifest order.

Cascaded models (an ``image_path_2`` column), exported ``.zip`` artifacts
and ``--DATA_PARALLEL`` raise and name the slice they wait for.

CLI:
  python -m prostatemr_3d_cad_cspca_tpu_torch.serve \\
      --MODEL weights/F1/model_weights_250.npz \\
      --MANIFEST feed/test.csv --OUTPUT_DIR out/ [--BATCH_SIZE 8] \\
      [--MC_ITER 4] [--TTA 1] [--DEVICE cuda]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from . import prng
from .device import resolve_device
from .infer import make_chunked_batch_fn, make_sliding_window_fn, mc_predict, tree_map


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="M1 batch inference")
    p.add_argument("--MODEL", type=str, required=True,
                   help="checkpoint path (M1.save output, from either package); "
                        "comma-separate K fold checkpoints to serve their ensemble")
    p.add_argument("--MANIFEST", type=str, required=True,
                   help="csv/tsv/xlsx manifest with p-id,image_path columns")
    p.add_argument("--OUTPUT_DIR", type=str, required=True)
    p.add_argument("--TRAIN_OBJ", type=str, default="lesion")
    p.add_argument("--BATCH_SIZE", type=int, default=8)
    p.add_argument("--MC_ITER", type=int, default=1,
                   help="posterior samples for Monte-Carlo dropout models")
    p.add_argument("--SW_OVERLAP", type=float, default=0.5,
                   help="sliding-window overlap for oversized volumes")
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
                   help="test-time augmentation: average over the axial "
                        "left-right flip")
    p.add_argument("--TRANSFER_CHANNELS", type=str, default="all",
                   choices=["all", "foreground"],
                   help="'foreground' drops the softmax background channel on "
                        "the device and rebuilds it host-side as 1 - sum")
    p.add_argument("--SCAN_CHUNK", type=int, default=0,
                   help="batches larger than this run chunk by chunk, so peak "
                        "activation memory stays at one chunk's (0 = off)")
    p.add_argument("--DEVICE", type=str, default="cuda",
                   help="'cuda' (default) or 'cpu' for the plain PyTorch path")
    return p


class InferenceSession:
    """Detect wrapper around a loaded M1 (or ``ensemble.M1Ensemble``) on one
    device.

    ``__call__(batch)`` takes a (B, D, H, W, C) array and returns
    ``(probs, uncertainty)`` as fp32 numpy; the uncertainty is the MC std
    when ``mc_iter > 1`` on a Monte-Carlo model, else None. Each call of a
    Monte-Carlo model draws from ``fold_in(generator(seed), n)`` for the
    call's number n, so a session's outputs depend only on its seed.
    """

    def __init__(self, model, mc_iter: int = 1, seed: int = 0, mesh=None,
                 transfer_dtype=None, tta: bool = False,
                 transfer_channels: str = "all",
                 scan_chunk: Optional[int] = None, device="cuda"):
        dev = resolve_device(device)
        if mesh is not None:
            raise NotImplementedError(
                "data-parallel serving waits for the multi-GPU slice")
        if model.device != dev:
            model.to(dev)
        self.model = model
        self.device = dev
        self.tta = bool(tta)
        self.mc_iter = int(mc_iter)
        self._out_dtype = (getattr(torch, str(transfer_dtype))
                           if transfer_dtype is not None else None)
        self._needs_rng = bool(model.probabilistic or
                               model.config.get("dropout_mode") == "monte-carlo")
        # foreground-only transfer: exact for the mean (the blend is linear
        # and channel-uniform), and for the MC std with 2 classes
        # (std(1 - p) == std(p)); with more classes the background std cannot
        # be rebuilt, so MC sessions transfer every channel there
        self._fg_only = str(transfer_channels) == "foreground"
        if (self._fg_only and model.num_classes > 2 and self.mc_iter > 1
                and self._needs_rng):
            self._fg_only = False
        self._rng = prng.generator(seed, dev)
        self._draws = 0
        detect = model.get_detect_model()
        if self.tta:
            from .ensemble import tta_detect

            detect = tta_detect(detect)
        self._detect = detect
        self._scan_chunk = int(scan_chunk) if scan_chunk else None
        self._sw_cache: Dict[tuple, tuple] = {}

    def _next_rng(self) -> torch.Generator:
        sub = prng.fold_in(self._rng, self._draws)
        self._draws += 1
        return sub

    def _to_device(self, x) -> torch.Tensor:
        if not torch.is_tensor(x):
            x = torch.from_numpy(np.ascontiguousarray(x, np.float32))
        return x.to(self.device)

    def _cast(self, out):
        if self._fg_only:  # device-side background-channel drop
            out = tree_map(lambda a: a[..., 1:], out)
        if self._out_dtype is None:
            return out
        return tree_map(lambda a: a.to(self._out_dtype), out)

    def _body(self, x, rng=None):
        if self._needs_rng and self.mc_iter > 1:
            out = mc_predict(self._detect, None, x, rng, num_samples=self.mc_iter,
                             reduce="mean_std")
        elif self._needs_rng:
            out = self._detect(None, x, rng=rng)
        else:
            out = self._detect(None, x)
        return self._cast(out)

    def __call__(self, batch):
        """Batch -> (probs, uncertainty | None), fp32 numpy."""
        x = self._to_device(batch)
        b = int(x.shape[0])
        rng = self._next_rng() if self._needs_rng else None
        with torch.no_grad():
            if self._scan_chunk and b > self._scan_chunk:
                ck = self._scan_chunk
                pad = (-b) % ck
                if pad:  # duplicate the last case up to whole chunks
                    x = torch.cat([x, x[-1:].expand(pad, *x.shape[1:])], 0)
                run = make_chunked_batch_fn(self._body, ck, (b + pad) // ck,
                                            rng_per_chunk=self._needs_rng)
                out = run(x, rng) if self._needs_rng else run(x)
            else:
                out = self._body(x, rng)
        host = tree_map(lambda a: a.float().cpu().numpy()[:b], out)
        if self.mc_iter > 1 and self._needs_rng:
            mean, std = host
            return self._unpack_mean(mean), self._unpack_std(std)
        return self._unpack_mean(host), None

    # host-side inverses of the device-side foreground-channel drop
    def _unpack_mean(self, fg: np.ndarray) -> np.ndarray:
        if not self._fg_only:
            return fg
        bg = 1.0 - fg.sum(axis=-1, keepdims=True)
        return np.concatenate([bg, fg], axis=-1)

    def _unpack_std(self, fg: np.ndarray) -> np.ndarray:
        if not self._fg_only:
            return fg
        # num_classes == 2 here (see __init__): std(1 - p) == std(p)
        return np.concatenate([fg, fg], axis=-1)

    def predict_case(self, volume, sw_overlap: float = 0.5):
        """One whole (D, H, W, C) case; sliding windows when it is larger
        than the training window. Returns (probs, uncertainty | None)."""
        window = tuple(self.model.input_spatial_dims)
        if tuple(volume.shape[:-1]) == window:
            probs, unc = self(np.asarray(volume)[None])
            return probs[0], (unc[0] if unc is not None else None)
        run, out_mult = self._sw_program(tuple(volume.shape), float(sw_overlap), cases=1)
        x = self._to_device(volume)
        with torch.no_grad():
            out = run(x, self._next_rng()) if self._needs_rng else run(x)
        return self._split_sw(out.float().cpu().numpy(), out_mult)

    def _split_sw(self, out: np.ndarray, out_mult: int):
        """Split a sliding-window output block into (probs, std | None),
        rebuilding the background channel after a foreground-only transfer."""
        ncp = self.model.num_classes - (1 if self._fg_only else 0)
        if out_mult == 2:
            return (self._unpack_mean(out[..., :ncp]),
                    self._unpack_std(out[..., ncp:]))
        return self._unpack_mean(out), None

    def _sw_program(self, shape, sw_overlap: float, cases: int):
        """The sliding window for one volume shape, cached. Returns
        ``(run, out_mult)``; out_mult 2 means ``run`` emits
        ``cat([mean, std], -1)`` over ``mc_iter`` draws per tile, blended
        like the probabilities (a blend of per-tile MC stds, not the std of
        the blended means)."""
        key = (tuple(shape), float(sw_overlap), int(cases))
        if key in self._sw_cache:
            return self._sw_cache[key]
        window = tuple(self.model.input_spatial_dims)
        needs_rng = self._needs_rng
        mc = self.mc_iter if (needs_rng and self.mc_iter > 1) else 1
        detect = self._detect  # the same (TTA/ensemble-wrapped) head as __call__
        fgo = self._fg_only

        def fwd(tiles, rng=None):
            out = detect(None, tiles, rng=rng) if needs_rng else detect(None, tiles)
            return out[..., 1:] if fgo else out

        ncp = self.model.num_classes - (1 if fgo else 0)
        if mc > 1:
            def tile_fn(tiles, rng):
                mean, std = mc_predict(lambda _p, x, rng: fwd(x, rng), None, tiles,
                                       rng, num_samples=mc, reduce="mean_std")
                return torch.cat([mean, std], dim=-1)
            out_mult = 2
        else:
            tile_fn, out_mult = fwd, 1
        run = make_sliding_window_fn(
            tile_fn, full_spatial=shape[:-1], window=window, in_channels=shape[-1],
            out_channels=ncp * out_mult, overlap=sw_overlap, cases=cases,
            rng_per_chunk=needs_rng, out_dtype=self._out_dtype)
        self._sw_cache[key] = (run, out_mult)
        return self._sw_cache[key]

    def predict_cases(self, volumes, sw_overlap: float = 0.5, group_size: int = 8):
        """Same-shape oversized cases in groups of up to ``group_size``, each
        group one sliding window over K cases (the last group padded with a
        duplicate, so every group has one shape). Returns
        ``[(probs, uncertainty | None), ...]`` aligned with ``volumes``."""
        if (len(volumes) == 1 or int(group_size) < 2
                or len({tuple(v.shape) for v in volumes}) != 1):
            return [self.predict_case(v, sw_overlap=sw_overlap) for v in volumes]
        k = min(int(group_size), len(volumes))
        run_k, out_mult = self._sw_program(tuple(volumes[0].shape), float(sw_overlap),
                                           cases=k)
        out: List[tuple] = []
        for i in range(0, len(volumes), k):
            group = list(volumes[i:i + k])
            block = self._to_device(np.stack(group + [group[0]] * (k - len(group))))
            with torch.no_grad():
                probs = run_k(block, self._next_rng()) if self._needs_rng else run_k(block)
            probs = probs.float().cpu().numpy()
            out.extend(self._split_sw(probs[j], out_mult) for j in range(len(group)))
        return out


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
    pending_sw: Dict[tuple, List[tuple]] = {}

    def _emit(pid: str, probs: np.ndarray, unc: Optional[np.ndarray]) -> Dict:
        det_path = os.path.join(args.OUTPUT_DIR, f"{pid}_detection.npy")
        np.save(det_path, probs.astype(np.float32))
        entry: Dict = {"p-id": pid, "detection_path": det_path}
        if unc is not None and args.SAVE_UNCERTAINTY:
            unc_path = os.path.join(args.OUTPUT_DIR, f"{pid}_uncertainty.npy")
            np.save(unc_path, unc.astype(np.float32))
            entry["uncertainty_path"] = unc_path
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
        probs, unc = session(np.stack(vols))
        for i, pid in enumerate(ids):
            results.append(_emit(pid, probs[i], unc[i] if unc is not None else None))
        pending.clear()

    sw_group = max(1, min(args.BATCH_SIZE, 8))

    def flush_sw(items):
        ids, vols = zip(*items)
        outs = session.predict_cases(list(vols), sw_overlap=args.SW_OVERLAP,
                                     group_size=sw_group)
        for pid, (probs, unc) in zip(ids, outs):
            results.append(_emit(pid, probs, unc))
        items.clear()

    order: List[str] = []
    for row in rows:
        pid = row.get("p-id", os.path.basename(row["image_path"]))
        if row.get("image_path_2"):
            raise NotImplementedError(
                f"{pid}: a second exam (image_path_2) feeds cascaded models, "
                "which wait for the cascade slice")
        order.append(pid)
        vol = _load_case(row, args.TRAIN_OBJ, model.input_channels, bool(args.WHITEN))
        if tuple(vol.shape[:-1]) == window:
            pending.append((pid, vol))
            if len(pending) >= args.BATCH_SIZE:
                flush()
        else:
            items = pending_sw.setdefault(tuple(vol.shape), [])
            items.append((pid, vol))
            if len(items) >= sw_group:  # host memory stays O(group)
                flush_sw(items)
    flush()
    for items in pending_sw.values():
        if items:
            flush_sw(items)

    # window-sized batches and sliding-window groups finish out of order;
    # re-emit in manifest order for positional consumers of predictions.json
    rank = {pid: i for i, pid in enumerate(order)}
    results.sort(key=lambda r: rank.get(r["p-id"], len(rank)))

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
