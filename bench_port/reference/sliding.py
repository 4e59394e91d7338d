"""Whole-gland prediction of the reference: Gaussian-blended sliding
windows, the axial left-right flip averaged (TTA), a fold ensemble's member
mean and Monte-Carlo mean and std, in fp32 (nnU-Net-style tiling as the
published pipeline's ``infer.py``).

Tiles start every ``round(window * (1 - overlap))`` voxels along an axis,
the last flush with the volume's end; they run ``batch_size`` at a time
(the count padded with copies of the first tile, weighted 0), a case's
tiles sharing one forward with the other cases of its group. A tile's
prediction is, for each of ``mc`` samples, the mean over the two views
(the second flipped along W, its output flipped back) of the mean over the
members; its MC mean and population std are blended with a Gaussian
weight (sigma = window / 8 a side, peak 1) into the case, divided by the
summed weight.

Draws: the group's call draws from ``fold_in(seed, call)``; chunk ``i`` of
its tiles from ``fold_in(., i)``; view ``v`` from ``fold_in(., v)``; member
``m`` from ``fold_in(., m)``; that forward stacks ``mc`` samples of the
group's K cases x ``batch_size`` tiles sample-major (row s * K * bs + case *
bs + tile). The whole group runs at once, so every draw is made at the
program's shape.
"""

from __future__ import annotations

import itertools
from typing import Sequence

import numpy as np
import torch

from . import draws
from .m1 import detect


def tile_starts(full: int, window: int, overlap: float) -> Sequence[int]:
    if window >= full:
        return [0]
    step = max(int(round(window * (1.0 - overlap))), 1)
    starts = list(range(0, full - window + 1, step))
    if starts[-1] != full - window:
        starts.append(full - window)
    return starts


def gaussian(window, sigma_scale: float = 0.125) -> np.ndarray:
    w = np.ones(tuple(window), np.float32)
    for ax, size in enumerate(window):
        x = np.arange(size, dtype=np.float32) - (size - 1) / 2.0
        g = np.exp(-0.5 * (x / max(size * sigma_scale, 1e-3)) ** 2)
        shape = [1] * len(window)
        shape[ax] = size
        w = w * g.reshape(shape)
    return w / w.max()


def tiles(full, window, overlap: float, batch_size: int):
    """(tile starts padded to whole chunks, the real tile count)."""
    coords = list(itertools.product(*[tile_starts(f, k, overlap)
                                      for f, k in zip(full, window)]))
    n = len(coords)
    n_pad = -(-n // batch_size) * batch_size
    return coords + [coords[0]] * (n_pad - n), n


def group(params_list, cfg: dict, volumes: torch.Tensor, call_seed: int, mc: int,
          overlap: float = 0.5, batch_size: int = 4, views: int = 2):
    """(probs, std), each (K, C, D, H, W), of a group of K cases (a
    (K, C, D, H, W) block) that went through one sliding-window call."""
    window = tuple(cfg["input_spatial_dims"])
    k, full = volumes.shape[0], tuple(volumes.shape[2:])
    coords, n = tiles(full, window, overlap, batch_size)
    w = torch.from_numpy(gaussian(window)).to(volumes.device)
    nc = cfg["num_classes"]
    acc = torch.zeros((k, 2 * nc, *full), dtype=torch.float32, device=volumes.device)
    norm = torch.zeros((1, 1, *full), dtype=torch.float32, device=volumes.device)
    for cid in range(len(coords) // batch_size):
        cs = coords[cid * batch_size:(cid + 1) * batch_size]
        # rows case * batch_size + tile, then the mc samples stacked sample-major
        x = torch.stack([volumes[:, :, c[0]:c[0] + window[0], c[1]:c[1] + window[1],
                                 c[2]:c[2] + window[2]] for c in cs], dim=1)
        x = x.reshape(k * batch_size, *x.shape[2:]).repeat(mc, 1, 1, 1, 1)
        chunk_seed = draws.fold_in(call_seed, cid)
        view_out = None
        for v in range(views):
            xv = torch.flip(x, dims=[-1]) if v else x
            mean = None
            for m, params in enumerate(params_list):
                stream = draws.Stream(draws.fold_path(chunk_seed, v, m), volumes.device)
                out = detect(params, cfg, xv, stream)
                mean = out if mean is None else mean + (out - mean) / (m + 1)
            mean = torch.flip(mean, dims=[-1]) if v else mean
            view_out = mean if view_out is None else view_out + mean
        view_out = view_out / views
        samples = view_out.reshape(mc, k, batch_size, *view_out.shape[1:])
        out = torch.cat([samples.mean(0), samples.std(0, correction=0)], dim=2)
        for i, c in enumerate(cs):
            if cid * batch_size + i >= n:
                continue
            sl = (slice(None), slice(None), slice(c[0], c[0] + window[0]),
                  slice(c[1], c[1] + window[1]), slice(c[2], c[2] + window[2]))
            acc[sl] += out[:, i] * w
            norm[sl] += w
    out = acc / torch.clamp(norm, min=1e-8)
    return out[:, :nc], out[:, nc:]
