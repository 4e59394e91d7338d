"""Inference: Monte-Carlo posterior sampling and sliding-window whole-gland
prediction, port of the JAX package's ``infer.py``.

The JAX package compiles each of these into one program (``vmap`` over keys,
``lax.scan`` over tile chunks); the port runs eagerly. ``mc_predict`` keeps
the point of the ``vmap``: the N draws stack on the batch axis and go through
one forward, which also gives the deep levels' kernels more blocks. The
sliding window is a loop over tile chunks that blends each chunk's outputs
into fp32 accumulators on the device, in the JAX package's tile order.

Every ``rng`` here is a ``torch.Generator`` (or ``prng.Draws``, or a
mapping of keep-masks for one forward; see ``prng``). Standard deviations
are the population's (``correction=0``), as ``jnp.std``.
"""

from __future__ import annotations

import itertools
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from . import prng
from .utils.profiling import annotate


def tree_map(fn: Callable, *trees):
    """``fn`` over matching leaves of tensors or (nested) tuples of them."""
    if isinstance(trees[0], (tuple, list)):
        return type(trees[0])(tree_map(fn, *leaves) for leaves in zip(*trees))
    return fn(*trees)


def _as_tensor(x) -> torch.Tensor:
    if torch.is_tensor(x):
        return x
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


def _leading(tree) -> int:
    """The batch size of a tensor or of a (cascade) tuple of tensors."""
    return int((tree[0] if isinstance(tree, (tuple, list)) else tree).shape[0])


def _stack_samples(x, n: int):
    """``x`` repeated ``n`` times on the batch axis, sample-major."""
    with annotate("infer.mc_stack"):
        return tree_map(lambda t: t.repeat(n, *([1] * (t.dim() - 1))), x)


def mc_predict(detect_fn: Callable, params, inputs, rng, num_samples: int = 1,
               reduce: Optional[str] = "mean"):
    """N Monte-Carlo posterior samples of ``detect_fn(params, x, rng=...)``.

    The draws stack sample-major on the batch axis (rows ``s*B + b``) and
    go through one forward, which draws every sample's dropout masks and
    latents from ``rng``. A mapping holds masks and latents of the stacked
    shape (N*B, ...). A data-parallel shard's ``rng`` (``prng.rows``) takes
    its rows ``s*B + b`` of the global batch's stacked draws. Inputs and outputs may be tuples (a cascade's two
    exams, its two stages' outputs).

    reduce: 'mean' | 'mean_std' | None (the stacked (N, B, ...) samples).
    """
    if reduce not in ("mean", "mean_std", None):
        raise ValueError(f"reduce must be 'mean', 'mean_std' or None, got {reduce!r}")
    x = tree_map(_as_tensor, inputs)
    n = int(num_samples)
    out = detect_fn(params, _stack_samples(x, n), rng=prng.repeat_rows(rng, n))
    with annotate("infer.mc_reduce"):
        # -1, not the batch as an int: a traced batch axis stays symbolic
        samples = tree_map(lambda t: t.reshape(n, -1, *t.shape[1:]), out)
        if reduce == "mean":
            return tree_map(lambda s: s.mean(0), samples)
        if reduce == "mean_std":
            return (tree_map(lambda s: s.mean(0), samples),
                    tree_map(lambda s: s.std(0, correction=0), samples))
        return samples


def make_chunked_batch_fn(apply_fn: Callable, chunk: int, n_chunks: int,
                          rng_per_chunk: bool = False) -> Callable:
    """``run(x)`` applies ``apply_fn`` to ``n_chunks`` batch chunks of size
    ``chunk`` in turn and concatenates the outputs: peak activation memory
    stays at one chunk's. With ``rng_per_chunk`` it is ``run(x, rng)`` and
    chunk i gets ``apply_fn(x_i, fold_in(rng, i))``. ``x`` may be a tuple
    of same-batch tensors (a cascade's exams)."""

    def run(x, rng=None):
        if _leading(x) != chunk * n_chunks:
            raise ValueError(f"batch {_leading(x)} is not {n_chunks} chunks of {chunk}")
        outs = []
        for i in range(n_chunks):
            xb = tree_map(lambda t: t[i * chunk:(i + 1) * chunk], x)
            outs.append(apply_fn(xb, prng.fold_in(rng, i)) if rng_per_chunk
                        else apply_fn(xb))
        return tree_map(lambda *ts: torch.cat(ts, 0), *outs)

    return run


def _gaussian_importance(window: Sequence[int], sigma_scale: float = 0.125) -> np.ndarray:
    """nnU-Net-style Gaussian tile weighting: center votes count more."""
    w = np.ones(tuple(window), np.float32)
    for ax, size in enumerate(window):
        x = np.arange(size, dtype=np.float32) - (size - 1) / 2.0
        sigma = max(size * sigma_scale, 1e-3)
        g = np.exp(-0.5 * (x / sigma) ** 2)
        shape = [1] * len(window)
        shape[ax] = size
        w = w * g.reshape(shape)
    return w / w.max()


def _tile_starts(full: int, window: int, overlap: float) -> Sequence[int]:
    if window >= full:
        return [0]
    step = max(int(round(window * (1.0 - overlap))), 1)
    starts = list(range(0, full - window + 1, step))
    if starts[-1] != full - window:
        starts.append(full - window)
    return starts


def _tile_slices(c: Sequence[int], window: Sequence[int]):
    return tuple(slice(int(s), int(s) + w) for s, w in zip(c, window))


def _weight(window, gaussian_weights: bool, device) -> torch.Tensor:
    w = (_gaussian_importance(window) if gaussian_weights
         else np.ones(tuple(window), np.float32))
    return torch.from_numpy(w).to(device)[..., None]


def _case_shards(mesh, cases: int):
    """The data devices of a one-process mesh (a device may repeat)."""
    if mesh.distributed:
        raise ValueError("data-parallel inference runs in one process: give a mesh made "
                         "outside a world (make_mesh(devices=...))")
    n = mesh.shape["data"]
    assert cases % n == 0, f"cases={cases} must divide the mesh data axis ({n})"
    return [mesh.devices[d, 0, 0] for d in range(n)]


def _on_shards(predict_fn, tiles, rng, devices, k, batch_size, with_rng):
    """One chunk's forward split by cases over ``devices``: device d runs
    its cases' tiles (rows [d K/n bs, (d+1) K/n bs)) with its rows of the
    chunk's draws; the outputs concatenate on the tiles' device."""
    assert k % len(devices) == 0, f"{k} cases do not split over {len(devices)} devices"
    per = k // len(devices) * batch_size
    bounds = [range(d * per, (d + 1) * per) for d in range(len(devices))]
    rngs = prng.rows(rng, bounds, k * batch_size) if with_rng else [None] * len(devices)
    outs = []
    for dev, rows, r in zip(devices, bounds, rngs):
        part = tiles[rows.start:rows.stop].to(dev)
        out = predict_fn(part, r) if with_rng else predict_fn(part)
        outs.append(out.to(tiles.device))
    return torch.cat(outs, 0)


def make_sliding_window_fn(
    predict_fn: Callable,
    full_spatial: Sequence[int],
    window: Sequence[int],
    in_channels: int,
    out_channels: int,
    overlap: float = 0.5,
    batch_size: int = 4,
    gaussian_weights: bool = True,
    cases: int = 1,
    rng_per_chunk: bool = False,
    mesh=None,
    out_dtype=None,
) -> Callable:
    """Sliding-window inference of fixed geometry (JAX ``infer.py:121-252``).

    predict_fn: (B, *window, C_in) -> (B, *window, C_out). The tile count is
    padded to a multiple of ``batch_size`` with duplicates of the first tile
    that carry zero weight, so every chunk has one batch size. Returns
    ``run(volume)``: (*full_spatial, C_in) -> (*full_spatial, out_channels)
    fp32 (or ``out_dtype``), equal to :func:`sliding_window_predict`.

    cases > 1: ``run`` maps (K, *full_spatial, C_in) -> (K, ..., out_channels)
    for any K (JAX's plain-vmap variant; ``cases`` is the K it is built
    for, and a traced case axis stays symbolic), and each chunk's tiles of
    all K cases go through one forward of K * batch_size volumes.

    rng_per_chunk: ``run(volume, rng)``, and chunk i calls
    ``predict_fn(tiles, fold_in(rng, i))``: fresh dropout masks per chunk.

    mesh (cases > 1; a one-process ``parallel.mesh.Mesh``): the case axis
    is split over the mesh's ``data`` devices (``cases % n_data == 0``, as
    JAX asserts). Each chunk's forward runs a part a device: its cases'
    tiles on that device, ``predict_fn`` (which must run where its tiles
    lie) drawing its rows of the chunk's draws for all K cases
    (``prng.rows``), so a seed gives the one-device program's bits.
    """
    shards = None
    if mesh is not None:
        shards = _case_shards(mesh, cases)
    full_spatial, window = tuple(full_spatial), tuple(window)
    ndim = len(window)
    if len(full_spatial) != ndim:
        raise ValueError(f"volume {full_spatial} and window {window} differ in rank")
    starts = [_tile_starts(full_spatial[i], window[i], overlap) for i in range(ndim)]
    coords = np.asarray(list(itertools.product(*starts)), np.int64)
    n = len(coords)
    n_pad = -(-n // batch_size) * batch_size
    coords_p = np.concatenate([coords, np.repeat(coords[:1], n_pad - n, axis=0)], 0)

    def run(volume, rng=None):
        vols = _as_tensor(volume)
        if cases == 1:
            vols = vols[None]
        if vols.dim() != ndim + 2 or tuple(vols.shape[1:]) != (*full_spatial, in_channels):
            raise ValueError(f"volume {tuple(vols.shape)} is not {'' if cases == 1 else 'K '}"
                             f"case(s) of {(*full_spatial, in_channels)}")
        k = vols.shape[0]
        with annotate("sw.blend"):  # the blend's weights and accumulators
            weight = _weight(window, gaussian_weights, vols.device)
            acc = torch.zeros((k, *full_spatial, out_channels), dtype=torch.float32,
                              device=vols.device)
            norm = torch.zeros((k, *full_spatial, 1), dtype=torch.float32,
                               device=vols.device)
        for cid in range(n_pad // batch_size):
            cs = coords_p[cid * batch_size:(cid + 1) * batch_size]
            with annotate("sw.gather"):
                tiles = torch.stack([vols[(slice(None), *_tile_slices(c, window))]
                                     for c in cs], dim=1)
                tiles = tiles.reshape(-1, *window, in_channels)
            chunk_rng = prng.fold_in(rng, cid) if rng_per_chunk else None
            if shards is None:
                outs = predict_fn(tiles, chunk_rng) if rng_per_chunk else predict_fn(tiles)
            else:
                outs = _on_shards(predict_fn, tiles, chunk_rng, shards, k, batch_size,
                                  rng_per_chunk)
            with annotate("sw.blend"):
                outs = outs.float().reshape(-1, batch_size, *window, out_channels)
                for i, c in enumerate(cs):
                    if cid * batch_size + i >= n:  # zero-weight padding tile
                        continue
                    sl = (slice(None), *_tile_slices(c, window))
                    acc[sl] += outs[:, i] * weight
                    norm[sl] += weight
        with annotate("sw.finish"):
            out = acc / torch.clamp(norm, min=1e-8)
            out = out if cases > 1 else out[0]
            return out if out_dtype is None else out.to(out_dtype)

    return run


def sliding_window_predict(
    predict_fn: Callable,
    volume,
    window: Sequence[int],
    overlap: float = 0.5,
    batch_size: int = 4,
    gaussian_weights: bool = True,
    out_channels: Optional[int] = None,
) -> torch.Tensor:
    """Full-volume prediction by overlapping tiles (JAX ``infer.py:255-313``),
    blended with the Gaussian weights: :func:`make_sliding_window_fn` for
    ``volume``'s shape, called once. ``volume``: (*full_spatial, C_in);
    returns (*full_spatial, C_out) fp32. Without ``out_channels``, one tile
    is predicted first to learn C_out."""
    vol = _as_tensor(volume)
    if vol.dim() - 1 != len(window):
        raise ValueError(f"volume {tuple(vol.shape[:-1])} and window {tuple(window)} "
                         "differ in rank")
    if out_channels is None:
        out_channels = int(predict_fn(vol[_tile_slices([0] * len(window), window)][None])
                           .shape[-1])
    return make_sliding_window_fn(predict_fn, vol.shape[:-1], window, vol.shape[-1],
                                  out_channels, overlap, batch_size, gaussian_weights)(vol)
