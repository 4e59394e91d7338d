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
  * cascaded models take two exams: a manifest's ``image_path_2`` column
    supplies the second (its absence feeds the one exam to both stages; a
    single-stage model ignores the column), and the served detection is
    stage 2's;
  * an exported artifact (``--MODEL m1.zip``, ``export.py``) serves through
    ``ExportedSession``: the program as it was frozen (MC, TTA, ensemble
    and transfer type baked in), whole-gland cases through its
    sliding-window programs;
  * outputs: ``<p-id>_detection.npy`` (+ ``_uncertainty.npy``) and
    ``predictions.json`` with ranked lesion candidates
    (train.metrics.extract_lesion_candidates), in manifest order.

``--DATA_PARALLEL N`` serves through a one-process mesh of N data devices
(``parallel.mesh``; the first N cards, or N CPU positions with ``--DEVICE
cpu``): each holds a replica and runs its rows of every batch, the draws
made for the whole batch, so a seed gives the one-device session's draws.
An exported artifact refuses it, as the JAX package's AOT artifact does.
The replicas are dispatched in turn from this one thread, so a request
takes no less time than on one device: the option is there for parity
with the JAX package's single controller, not for speed.

CLI:
  python -m prostatemr_3d_cad_cspca_tpu_torch.serve \\
      --MODEL weights/F1/model_weights_250.npz \\
      --MANIFEST feed/test.csv --OUTPUT_DIR out/ [--BATCH_SIZE 8] \\
      [--MC_ITER 4] [--TTA 1] [--DEVICE cuda]
"""

from __future__ import annotations

import argparse
import copy
import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from . import prng
from .device import resolve_device
from .infer import make_chunked_batch_fn, make_sliding_window_fn, mc_predict, tree_map
from .utils.profiling import annotate


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="M1 batch inference")
    p.add_argument("--MODEL", type=str, required=True,
                   help="checkpoint path (M1.save output, from either package); "
                        "comma-separate K fold checkpoints to serve their ensemble; "
                        "or an exported artifact (.zip)")
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
                   help="shard each batch over the first N devices, a replica "
                        "on each (0/1 = one device)")
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


def _same_device(a: torch.device, b: torch.device) -> bool:
    index = lambda d: (d.index if d.index is not None  # noqa: E731
                       else torch.cuda.current_device() if d.type == "cuda" else None)
    return a.type == b.type and index(a) == index(b)


# what HostCopies.counts counts: bytes up (the driver stages them from
# pageable memory) and bytes down through pinned and through pageable host
# memory
COPY_COUNTS = ("up_pageable_bytes", "down_pinned_bytes", "down_pageable_bytes")


def _host_fp32(x) -> torch.Tensor:
    """A tensor handed in as it is; anything else as fp32, as
    ``np.ascontiguousarray(x, np.float32)`` makes it."""
    return x if torch.is_tensor(x) else torch.from_numpy(np.ascontiguousarray(x, np.float32))


def _upload(x, device) -> torch.Tensor:
    """A batch, or a list of same-shape rows stacked on a new leading axis
    (a group's cases, row by row: no host-side stack), -> one tensor on
    ``device``: numpy as fp32, a tensor in its own dtype. From pageable
    host memory the driver stages the copy."""
    if not isinstance(x, list):
        return _host_fp32(x).to(device)
    rows = [_host_fp32(r) for r in x]
    out = torch.empty((len(rows), *rows[0].shape), dtype=rows[0].dtype, device=device)
    for o, r in zip(out, rows):
        o.copy_(r)
    return out


class HostCopies:
    """A CUDA session's host<->device copies, and what they moved.

    ``readback`` lands each output in pinned host memory of its own from
    torch's caching host allocator, every copy issued non-blocking, then
    waits on one event: the link's rate, where a pageable readback runs at
    a sixth of it and faults in fresh pages. A block goes back to the
    allocator's cache only once the caller has dropped its last numpy view
    of it, so a result is never overwritten by a later call (a caller that
    keeps many results keeps that much host memory pinned). An output
    crosses in its dtype and is widened to fp32 on the host where it is not
    fp32 (the same values).

    ``upload`` leaves the staging to the driver's pageable copy. Inside
    whole requests with torch held to one host thread, the driver's staged
    copy of a 49 MB cfg1 batch took 9.4 ms and a pinned staging ring filled
    by torch's ``copy_`` 11.6-15.6 ms (H100 host): one thread's memcpy
    bounds both, and the driver's is the faster.

    ``pin=False`` runs the same logic on unpinned host memory (the CPU
    tests' form). ``counts``: see ``COPY_COUNTS``.
    """

    def __init__(self, device, pin: bool = True):
        self.device = torch.device(device)
        self.pin = bool(pin)
        self.counts = dict.fromkeys(COPY_COUNTS, 0)

    def upload(self, x) -> torch.Tensor:
        """``_upload`` to the session's device, counted."""
        out = _upload(x, self.device)
        self.counts["up_pageable_bytes"] += out.numel() * out.element_size()
        return out

    def readback(self, arrays) -> List[np.ndarray]:
        """Device tensors -> fp32 numpy arrays, each in host memory of its
        own; returns once every copy has landed."""
        host = [torch.empty(a.shape, dtype=a.dtype, pin_memory=self.pin) for a in arrays]
        for h, a in zip(host, arrays):
            h.copy_(a, non_blocking=True)
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
            done.synchronize()
        self.counts[f"down_{'pinned' if self.pin else 'pageable'}_bytes"] += sum(
            h.numel() * h.element_size() for h in host)
        return [(h if h.dtype == torch.float32 else h.float()).numpy() for h in host]


class InferenceSession:
    """Detect wrapper around a loaded M1 (or ``ensemble.M1Ensemble``) on one
    device, or on the ``data`` devices of a one-process ``mesh``
    (``parallel.mesh.make_mesh``; a device may repeat).

    ``__call__(batch)`` takes a (B, D, H, W, C) array (for a cascade an
    ``(image_1, image_2)`` pair of them, or one array that feeds both
    stages) and returns ``(probs, uncertainty)`` as fp32 numpy, a cascade's
    from its stage 2; the uncertainty is the MC std when ``mc_iter > 1`` on
    a Monte-Carlo or probabilistic model, else None. Each such call draws
    from ``fold_in(generator(seed), n)`` for the call's number n, so a
    session's outputs depend only on its seed.

    With a mesh, each data device holds a replica (the model itself where
    the device is the model's) and runs its equal share of the batch's
    rows; ``__call__`` pads the batch to a multiple of the data axis with
    copies of its last case and strips them. Draws are made for the whole
    batch on the first device and each replica takes its rows
    (``prng.rows``), so an MC or probabilistic request draws the
    one-device session's bits. Sliding windows of K cases split their
    cases over the devices where K divides (``predict_cases`` rounds K up
    to a multiple of the axis); one case runs on the first device.

    On a CUDA device the copies go through ``HostCopies`` (to and from the
    first device of a mesh): results come back through pinned host memory,
    and ``copy_counts`` says what crossed. A CPU session copies as plain
    PyTorch does and counts nothing: nothing crosses a link.
    """

    def __init__(self, model, mc_iter: int = 1, seed: int = 0, mesh=None,
                 transfer_dtype=None, tta: bool = False,
                 transfer_channels: str = "all",
                 scan_chunk: Optional[int] = None, device="cuda"):
        dev = resolve_device(device)
        self.mesh = mesh
        self._n_data = int(mesh.shape["data"]) if mesh is not None else 1
        self._devices = [dev]
        if mesh is not None:
            if mesh.distributed:
                raise ValueError("data-parallel serving runs in one process: give a mesh "
                                 "made outside a world (make_mesh(devices=...))")
            self._devices = [resolve_device(mesh.devices[d, 0, 0])
                             for d in range(self._n_data)]
            dev = self._devices[0]
            if scan_chunk and int(scan_chunk) % self._n_data != 0:
                raise ValueError(
                    f"scan_chunk={scan_chunk} must be a multiple of the mesh "
                    f"data axis ({self._n_data}) so every chunk shards evenly")
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
        self._replicas = []  # (device, detect head) a data device
        for d in self._devices:
            same = [det for dv, det in self._replicas if _same_device(dv, d)]
            self._replicas.append((d, same[0] if same else self._head(
                model if _same_device(d, dev) else copy.deepcopy(model).to(d))))
        self._detect = self._replicas[0][1]
        self._scan_chunk = int(scan_chunk) if scan_chunk else None
        self._sw_cache: Dict[tuple, tuple] = {}
        self._copies = HostCopies(dev) if dev.type == "cuda" else None

    @property
    def copy_counts(self) -> Dict[str, int]:
        """Bytes moved each way and the host memory they went through
        (``COPY_COUNTS``; all 0 on a CPU session)."""
        if self._copies is None:
            return dict.fromkeys(COPY_COUNTS, 0)
        return self._copies.counts

    def _head(self, model):
        detect = model.get_detect_model()
        if self.tta:
            from .ensemble import tta_detect

            detect = tta_detect(detect)
        return detect

    def _detect_on(self, device: torch.device):
        """The detect head of the replica on ``device``."""
        for d, det in self._replicas:
            if _same_device(d, device):
                return det
        raise ValueError(f"no replica on {device}")

    def _next_rng(self) -> torch.Generator:
        sub = prng.fold_in(self._rng, self._draws)
        self._draws += 1
        return sub

    def _to_device(self, x):
        """Host input -> the session's device: a tuple is a cascade's exams;
        a list is the rows of one tensor (``_upload``). A tensor already on
        a device moves as it is."""
        if isinstance(x, tuple):
            return tuple(self._to_device(t) for t in x)
        if self._copies is None or (torch.is_tensor(x) and x.device.type != "cpu"):
            return _upload(x, self.device)
        return self._copies.upload(x)

    def _readback(self, arrays) -> List[np.ndarray]:
        """Device outputs -> fp32 numpy, one array each. The model's own
        dtype is widened on the device (a copy at the link's rate costs less
        than widening on the host); a ``transfer_dtype`` output crosses as
        it is, which is what the option is for."""
        if self._out_dtype is None:
            arrays = [a.float() for a in arrays]
        if self._copies is not None:
            return self._copies.readback(arrays)
        return [a.float().cpu().numpy() for a in arrays]

    def _cast(self, out):
        if self._fg_only:  # device-side background-channel drop
            out = tree_map(lambda a: a[..., 1:], out)
        if self._out_dtype is None:
            return out
        return tree_map(lambda a: a.to(self._out_dtype), out)

    def _body_on(self, detect, x, rng=None):
        if self._needs_rng and self.mc_iter > 1:
            out = mc_predict(detect, None, x, rng, num_samples=self.mc_iter,
                             reduce="mean_std")
        elif self._needs_rng:
            out = detect(None, x, rng=rng)
        else:
            out = detect(None, x)
        return self._cast(out)

    def _body(self, x, rng=None):
        """One forward of a batch: on the one device, or its rows a data
        device, each replica with its rows of the batch's draws."""
        if self._n_data == 1:
            return self._body_on(self._detect, x, rng)
        b = int((x[0] if isinstance(x, tuple) else x).shape[0])
        per = b // self._n_data
        bounds = [range(d * per, (d + 1) * per) for d in range(self._n_data)]
        rngs = prng.rows(rng, bounds, b)
        outs = []
        for (dev, detect), rows, r in zip(self._replicas, bounds, rngs):
            part = tree_map(lambda t: t[rows.start:rows.stop].to(dev), x)
            outs.append(tree_map(lambda t: t.to(self.device), self._body_on(detect, part, r)))
        return tree_map(lambda *ts: torch.cat(ts, 0), *outs)

    def __call__(self, batch):
        """Batch -> (probs, uncertainty | None), fp32 numpy. The request's
        span carries the ``fold_in`` index of its draws."""
        with annotate("serve.request", self._draws):
            casc = bool(self.model.cascaded)
            if casc and not isinstance(batch, tuple):
                batch = (batch, batch)
            with annotate("serve.upload", self.copy_counts):
                x = self._to_device(batch)
            b = int((x[0] if casc else x).shape[0])
            rng = self._next_rng() if self._needs_rng else None
            chunked = bool(self._scan_chunk and b > self._scan_chunk)
            pad = (-b) % (self._scan_chunk if chunked else self._n_data)
            with torch.no_grad(), annotate("serve.forward"):
                if pad:  # duplicate the last case up to whole chunks / the data axis
                    x = tree_map(lambda t: torch.cat([t, t[-1:].expand(pad, *t.shape[1:])], 0), x)
                if chunked:
                    ck = self._scan_chunk
                    run = make_chunked_batch_fn(self._body, ck, (b + pad) // ck,
                                                rng_per_chunk=self._needs_rng)
                    out = run(x, rng) if self._needs_rng else run(x)
                else:
                    out = self._body(x, rng)
            with annotate("serve.readback", self.copy_counts):
                # only what is returned crosses: the batch's rows, a
                # cascade's stage 2
                if self.mc_iter > 1 and self._needs_rng:
                    mean, std = out
                    if casc:  # stage 2's detection and uncertainty
                        mean, std = mean[-1], std[-1]
                    mean, std = self._readback([mean[:b], std[:b]])
                    return self._unpack_mean(mean), self._unpack_std(std)
                (probs,) = self._readback([(out[-1] if casc else out)[:b]])
                return self._unpack_mean(probs), None

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

    def _stacked(self, volume):
        """A case as the sliding window takes it: a cascade's exams (one
        exam feeds both) concatenated on the channel axis."""
        if not self.model.cascaded:
            return np.asarray(volume)
        vols = volume if isinstance(volume, tuple) else (volume, volume)
        return np.concatenate(vols, axis=-1)

    def predict_case(self, volume, sw_overlap: float = 0.5):
        """One whole (D, H, W, C) case (a cascade's ``(image_1, image_2)``
        pair); sliding windows when it is larger than the training window.
        Returns (probs, uncertainty | None)."""
        window = tuple(self.model.input_spatial_dims)
        vols = volume if isinstance(volume, tuple) else (volume,)
        if tuple(vols[0].shape[:-1]) == window:
            batch = tuple(np.asarray(v)[None] for v in vols)
            probs, unc = self(batch if self.model.cascaded else batch[0])
            return probs[0], (unc[0] if unc is not None else None)
        stacked = self._stacked(volume)
        run, out_mult = self._sw_program(tuple(stacked.shape), float(sw_overlap), cases=1)
        with annotate("serve.group", self._draws):
            with annotate("serve.upload", self.copy_counts):
                x = self._to_device(stacked)
            with torch.no_grad(), annotate("serve.forward"):
                out = run(x, self._next_rng()) if self._needs_rng else run(x)
            with annotate("serve.readback", self.copy_counts):
                (out,) = self._readback([out])
                return self._split_sw(out, out_mult)

    def _split_sw(self, out: np.ndarray, out_mult: int):
        """Split a sliding-window output block into (probs, std | None),
        rebuilding the background channel after a foreground-only transfer."""
        ncp = self.model.num_classes - (1 if self._fg_only else 0)
        if out_mult == 2:
            return (self._unpack_mean(out[..., :ncp]),
                    self._unpack_std(out[..., ncp:]))
        return self._unpack_mean(out), None

    def _sw_program(self, shape, sw_overlap: float, cases: int):
        """The sliding window for one volume shape (a cascade's exams
        stacked on the channel axis: both tile at the same coordinates),
        cached. Returns ``(run, out_mult)``; out_mult 2 means ``run`` emits
        ``cat([mean, std], -1)`` over ``mc_iter`` draws per tile, blended
        like the probabilities (a blend of per-tile MC stds, not the std of
        the blended means)."""
        key = (tuple(shape), float(sw_overlap), int(cases))
        if key in self._sw_cache:
            return self._sw_cache[key]
        window = tuple(self.model.input_spatial_dims)
        needs_rng = self._needs_rng
        mc = self.mc_iter if (needs_rng and self.mc_iter > 1) else 1
        fgo = self._fg_only
        casc, c = bool(self.model.cascaded), self.model.input_channels
        # K cases split over the mesh's data devices where K divides
        sw_mesh = (self.mesh if cases > 1 and self.mesh is not None
                   and cases % self._n_data == 0 else None)

        def fwd(tiles, rng=None):
            # the same (TTA/ensemble-wrapped) head as __call__, on the tiles' device
            detect = self._detect_on(tiles.device) if sw_mesh is not None else self._detect
            inp = (tiles[..., :c], tiles[..., c:]) if casc else tiles
            out = detect(None, inp, rng=rng) if needs_rng else detect(None, inp)
            out = out[-1] if casc else out  # a cascade's stage-2 detection
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
            rng_per_chunk=needs_rng, mesh=sw_mesh, out_dtype=self._out_dtype)
        self._sw_cache[key] = (run, out_mult)
        return self._sw_cache[key]

    def predict_cases(self, volumes, sw_overlap: float = 0.5, group_size: int = 8):
        """Same-shape oversized cases in groups of up to ``group_size``, each
        group one sliding window over K cases (the last group padded with a
        duplicate, so every group has one shape). Returns
        ``[(probs, uncertainty | None), ...]`` aligned with ``volumes``."""
        stacked = [self._stacked(v) for v in volumes]
        if (len(volumes) == 1 or int(group_size) < 2
                or len({tuple(v.shape) for v in stacked}) != 1):
            return [self.predict_case(v, sw_overlap=sw_overlap) for v in volumes]
        k = min(int(group_size), len(volumes))
        if self._n_data > 1:  # K up to a data-axis multiple: the cases split evenly
            k = max(self._n_data, -(-k // self._n_data) * self._n_data)
        run_k, out_mult = self._sw_program(tuple(stacked[0].shape), float(sw_overlap),
                                           cases=k)
        out: List[tuple] = []
        for i in range(0, len(stacked), k):
            group = stacked[i:i + k]
            # the group's span carries the fold_in index of its draws
            with annotate("serve.group", self._draws):
                with annotate("serve.upload", self.copy_counts):
                    block = self._to_device(group + [group[0]] * (k - len(group)))
                with torch.no_grad(), annotate("serve.forward"):
                    probs = run_k(block, self._next_rng()) if self._needs_rng else run_k(block)
                with annotate("serve.readback", self.copy_counts):
                    (probs,) = self._readback([probs[:len(group)]])  # not the padding
                    out.extend(self._split_sw(probs[j], out_mult) for j in range(len(group)))
        return out


class ExportedSession:
    """Serve from an artifact (``export.ExportedModel``): the inference
    program (MC sampling, TTA, ensemble, cascade, transfer type) was frozen
    at export, so this session only batches. ``__call__`` pads a short batch
    up to a fixed-batch artifact's size and strips the padding."""

    def __init__(self, model):
        self.model = model  # an export.ExportedModel, seeded at load
        self._fixed_batch = model.meta.get("batch")
        self._mean_std = model.meta["output"] == "mean_std"

    def __call__(self, batch):
        if isinstance(batch, tuple):  # a cascade: its exams stacked on channels
            batch = np.concatenate(batch, axis=-1)
        b = batch.shape[0]
        fixed = self._fixed_batch
        if fixed is not None:
            if b > fixed:
                raise ValueError(f"artifact has fixed batch {fixed}; got {b} (serve with "
                                 "--BATCH_SIZE <= that, or export with batch=None)")
            if b < fixed:
                batch = np.concatenate([batch, np.repeat(batch[-1:], fixed - b, axis=0)], 0)
        out = self.model.predict(batch)
        if self._mean_std:
            mean, std = out
            return mean[:b], std[:b]
        return out[:b], None

    def predict_cases(self, vols, sw_overlap: float = 0.5, group_size: int = 8):
        """Whole cases through the artifact's sliding-window programs
        (``export_model(sw_shapes=...)``). The overlap was frozen at export;
        another ``sw_overlap`` is noted as inert. Cases are grouped by
        geometry, and a group's last chunk is padded with a duplicate to the
        group's size. Results align with ``vols``."""
        stacked = [np.concatenate(v, axis=-1) if isinstance(v, tuple) else np.asarray(v)
                   for v in vols]  # a cascade's two exams
        baked = self.model.sw_entries
        if not baked:
            shapes = sorted({tuple(v.shape) for v in stacked})
            raise ValueError(
                "this artifact has no sliding-window programs (exported without "
                f"sw_shapes): case shapes {shapes} vs window "
                f"{tuple(self.model.input_spatial_dims)} need a re-export with "
                "sw_shapes=... or a live checkpoint")
        overlaps = {shape: entry["overlap"] for shape, entry in baked.items()}
        if any(abs(ov - float(sw_overlap)) > 1e-9 for ov in overlaps.values()):
            print(f"# note: SW_OVERLAP={sw_overlap} ignored: overlaps {overlaps} were "
                  "frozen into the artifact at export", flush=True)
        by_shape: Dict[tuple, List[int]] = {}
        for idx, v in enumerate(stacked):
            by_shape.setdefault(tuple(v.shape), []).append(idx)
        results: List[Optional[tuple]] = [None] * len(stacked)
        for idxs in by_shape.values():
            k = min(max(1, int(group_size)), len(idxs))
            for i in range(0, len(idxs), k):
                chunk = idxs[i:i + k]
                block = [stacked[j] for j in chunk] + [stacked[chunk[-1]]] * (k - len(chunk))
                for j, r in zip(chunk, self.model.predict_cases(block)):
                    results[j] = r
        return results


def _load_one(row: Dict[str, str], train_obj: str, channels: int,
              whiten: bool) -> np.ndarray:
    """One exam's first ``channels`` channels, as the JAX package reads it
    (``serve.py:528-540``). For a probabilistic model ``channels`` counts the
    label channels too, which a test-mode image does not carry: a 3-channel
    image stays 3 channels for a 4-channel model, as in the JAX package."""
    from .data.generators import load_image

    vol = load_image(row, train_obj=train_obj)[..., :channels]
    if whiten:
        from .data.preprocess import whitening

        vol = np.stack([whitening(vol[..., c]) for c in range(vol.shape[-1])],
                       axis=-1)
    return vol


def _load_case(row: Dict[str, str], train_obj: str, channels: int,
               whiten: bool, cascaded: bool = False):
    """One case; for a cascaded model (two same-geometry exams, reference
    networks.py:111-112) the pair (exam, second exam), the second from the
    ``image_path_2`` column, else the one exam twice. A single-stage model
    ignores the column (JAX ``serve.py:543-554``)."""
    vol = _load_one(row, train_obj, channels, whiten)
    if not cascaded:
        return vol
    if row.get("image_path_2"):
        return vol, _load_one(dict(row, image_path=row["image_path_2"]), train_obj,
                              channels, whiten)
    return vol, vol


def run(args) -> List[Dict]:
    from .data.manifest import read_manifest
    from .load import load_model_spec
    from .train.metrics import extract_lesion_candidates

    device = resolve_device(getattr(args, "DEVICE", "cuda"))
    n_data = int(getattr(args, "DATA_PARALLEL", 0))
    if str(args.MODEL).endswith(".zip") and n_data > 1:
        # refused before the artifact loads, as the JAX package's
        raise ValueError(
            "--DATA_PARALLEL needs a live checkpoint; exported artifacts "
            "run the program as exported (single device)")
    os.makedirs(args.OUTPUT_DIR, exist_ok=True)
    model = load_model_spec(args.MODEL, seed=args.SEED, allow_artifact=True, device=device)
    if hasattr(model, "sw_entries"):  # an artifact (export.ExportedModel)
        # MC, TTA, the ensemble and transfer slimming were frozen at export
        inert = [f for f, dv in (("MC_ITER", 1), ("TTA", 0), ("TRANSFER_DTYPE", "float32"),
                                 ("TRANSFER_CHANNELS", "all"), ("SCAN_CHUNK", 0))
                 if getattr(args, f, dv) != dv]
        if inert:
            print(f"# note: {', '.join(inert)} ignored: frozen into the artifact at "
                  "export", flush=True)
        session = ExportedSession(model)
    else:
        mesh = None
        if n_data > 1:
            from .parallel.mesh import make_mesh, setup_device

            devices, _ = setup_device(",".join(map(str, range(n_data))), device)
            mesh = make_mesh(n_data=n_data, devices=devices)
        tdt = getattr(args, "TRANSFER_DTYPE", "float32")
        session = InferenceSession(
            model, mc_iter=args.MC_ITER, seed=args.SEED, mesh=mesh,
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
        if model.cascaded:
            batch = (np.stack([v[0] for v in vols]), np.stack([v[1] for v in vols]))
        else:
            batch = np.stack(vols)
        probs, unc = session(batch)
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
        order.append(pid)
        vol = _load_case(row, args.TRAIN_OBJ, model.input_channels, bool(args.WHITEN),
                         cascaded=bool(model.cascaded))
        shape_src = vol[0] if isinstance(vol, tuple) else vol
        if tuple(shape_src.shape[:-1]) == window:
            pending.append((pid, vol))
            if len(pending) >= args.BATCH_SIZE:
                flush()
        else:
            items = pending_sw.setdefault(tuple(shape_src.shape), [])
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
