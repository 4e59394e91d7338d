"""Spatial-domain parallelism: halo exchange over a mesh axis, port of the
JAX package's ``parallel/halo.py``.

A whole-gland volume is cut into slabs along one spatial axis, one slab a
rank of the mesh's ``spatial`` axis; each rank extends its slab with its
neighbours' rows (:func:`halo_exchange`), runs the network on slab + halos
with whole-volume statistics (``ops.normalization.ShardedStats``) and keeps
its core. The halo covers the network's receptive field
(:func:`receptive_margin`) and is a multiple of its cumulative stride along
the axis, so sharded and unsharded outputs agree voxel for voxel.

These run one process per mesh position (``parallel.mesh``): every rank
calls them with the same arguments. The exchange is an ``all_gather`` of
the slabs, which NCCL and gloo both run and which serves any number of
hops (a halo wider than a slab) at once.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch

from ..ops.normalization import ShardedStats
from .collectives import Axis, all_gather, psum
from .mesh import Mesh


def receptive_margin(
    kernel_sizes: Sequence[Sequence[int]],
    strides: Sequence[Sequence[int]],
    spatial_dim: int,
) -> int:
    """Upper bound on the one-sided receptive field of the M1 encoder/decoder
    along one spatial dim: sum over levels of (k-1)/2 * cumulative stride
    (+ one 3^3 conv of each SE bottleneck), doubled for the decoder."""
    margin = 0
    cum = 1
    for k, s in zip(kernel_sizes, strides):
        margin += (k[spatial_dim] - 1) // 2 * cum
        cum *= s[spatial_dim]
        margin += 1 * cum
    return int(2 * margin)


class _HaloExchange(torch.autograd.Function):
    """slab -> slab with ``halo`` rows of the neighbours each side (zeros
    beyond the volume's ends). The gradient of a slab is the sum, over the
    ranks, of the padded gradients' rows that came from it."""

    @staticmethod
    def forward(ctx, x, halo, axis, dim):
        ctx.halo, ctx.axis, ctx.dim, ctx.slab = halo, axis, dim, x.shape[dim]
        full = all_gather(x, axis, dim)  # the whole extent, in axis order
        pad = [0, 0] * (x.dim() - dim - 1) + [halo, halo]
        full = torch.nn.functional.pad(full, pad)
        return full.narrow(dim, axis.index * ctx.slab, ctx.slab + 2 * halo).contiguous()

    @staticmethod
    def backward(ctx, g):
        halo, axis, dim, slab = ctx.halo, ctx.axis, ctx.dim, ctx.slab
        shape = list(g.shape)
        shape[dim] = axis.size * slab + 2 * halo
        full = g.new_zeros(shape)
        full.narrow(dim, axis.index * slab, slab + 2 * halo).copy_(g)
        full = psum(full, axis) if axis.group is not None else full
        return full.narrow(dim, halo + axis.index * slab, slab), None, None, None


def halo_exchange(x: torch.Tensor, halo: int, axis: Axis, spatial_axis: int) -> torch.Tensor:
    """This rank's slab ``x`` extended by ``halo`` rows from each side's
    neighbours along ``spatial_axis`` (JAX ``halo.py:44-98``).

    A halo wider than the slab takes rows from further neighbours (the
    JAX package's multi-hop ``ppermute``); the edge ranks zero-fill what
    lies beyond the volume, the implicit zero padding of a SAME conv at the
    true boundary. Differentiable."""
    dim = spatial_axis % x.dim()
    return _HaloExchange.apply(x, int(halo), axis, dim)


def _slab(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    n = x.shape[dim] // axis.size
    return x.narrow(dim, axis.index * n, n).contiguous()


def _member_axis(mesh: Mesh, mesh_axis: str) -> Axis:
    if not mesh.member:
        raise ValueError(f"rank {mesh.rank} holds no position of {mesh}")
    axis = mesh.axis(mesh_axis)
    if axis.size > 1 and axis.group is None:
        raise ValueError(
            f"a {mesh_axis} axis of {axis.size} runs one process per position: "
            "initialize_distributed() (or spawn the ranks) before make_mesh")
    return axis


def make_spatial_predict(
    predict_fn: Callable[[torch.Tensor], torch.Tensor],
    mesh: Mesh,
    halo: int,
    spatial_axis: int = 2,
    mesh_axis: str = "spatial",
):
    """Spatially-sharded inference (JAX ``halo.py:101-134``).

    predict_fn: (B, D, H, W, C) -> (B, D, H, W, C_out) on slab + halos.
    Returns ``fn(volume)``: every rank passes the whole (B, D, H, W, C)
    volume and runs its slab; the ranks' cores are gathered, so every rank
    gets the whole output (JAX's global array)."""
    axis = _member_axis(mesh, mesh_axis)

    def fn(volume: torch.Tensor) -> torch.Tensor:
        dim = spatial_axis % volume.dim()
        x = _slab(volume.to(mesh.device), axis, dim)
        out = predict_fn(halo_exchange(x, halo, axis, dim))
        core = out.narrow(dim, halo, out.shape[dim] - 2 * halo).contiguous()
        return all_gather(core, axis, dim)

    return fn


def _stride_product(strides: Sequence[Sequence[int]], spatial_dim: int) -> int:
    p = 1
    for s in strides:
        p *= s[spatial_dim]
    return p


def _halo_geometry(model, n_shards: int, extent: int, spatial_axis: int,
                   halo: Optional[int]):
    """(halo, slab) for a sharded M1: the halo covers the receptive margin
    and is a multiple of the cumulative stride (phase alignment); the slab
    divides."""
    cfg = model.config
    sd = spatial_axis - 1
    stride_prod = _stride_product(cfg["strides"], sd)
    assert extent % n_shards == 0, (extent, n_shards)
    slab = extent // n_shards
    assert slab % stride_prod == 0, (
        f"local slab {slab} must be a multiple of the cumulative stride "
        f"{stride_prod} along axis {spatial_axis}")
    if halo is None:
        margin = receptive_margin(cfg["kernel_sizes"], cfg["strides"], sd)
        halo = ((margin + stride_prod - 1) // stride_prod) * stride_prod
    assert halo % stride_prod == 0, (halo, stride_prod)
    return halo, slab


def _forward(model, params: Optional[Dict[str, torch.Tensor]], x, sharded, train=False):
    if params is None:
        return model.net(x, train=train, sharded=sharded)
    return torch.func.functional_call(model.net, params, (x,),
                                      {"train": train, "sharded": sharded})


def make_spatial_train_step(
    model,
    seg_loss,
    optimizer,
    mesh: Mesh,
    spatial_axis: int = 2,
    mesh_axis: str = "spatial",
    halo: Optional[int] = None,
):
    """Spatially-sharded training step (JAX ``halo.py:137-260``): each rank
    runs slab + halos forward with whole-volume statistics, sums the loss
    over its core voxels (``seg_loss.per_sample_sums``, mean over the
    batch): its LOCAL share of the loss. It differentiates that share, and
    the shares' losses and gradients are summed over the axis (one
    all-reduce of the gradients); the optimizer then updates every rank's
    copy alike.

    The loss equals the unsharded step's to float tolerance. The model must
    be deterministic (dropout rate 0), without deep supervision, and
    stand-alone (not probabilistic, not cascaded): the same ``ValueError``s
    as the JAX package's.

    Returns ``step(params, opt_state, image, label) -> (params, opt_state,
    loss)`` over ``{name: tensor}`` parameters (the optimizer's two calls,
    ``train.trainer``); every rank passes the whole image and label."""
    cfg = model.config
    if cfg.get("dropout_rate", 0) > 0:
        raise ValueError(
            "make_spatial_train_step requires a deterministic model: build "
            "the M1 with dropout_rate=0 (got "
            f"{cfg['dropout_rate']}, mode={cfg.get('dropout_mode')!r}).")
    if cfg.get("deep_supervision"):
        raise ValueError(
            "make_spatial_train_step does not support deep_supervision=True: "
            "the stacked 4*num_classes-channel y_softmax is incompatible with "
            "seg_loss.per_sample_sums over core voxels.")
    if cfg.get("probabilistic") or cfg.get("cascaded"):
        raise ValueError(
            "make_spatial_train_step supports stand-alone deterministic M1 "
            "models only (probabilistic/cascaded not yet supported).")
    from ..parallel.collectives import all_reduce_flat

    axis = _member_axis(mesh, mesh_axis)
    device = mesh.device

    def step(params, opt_state, image, label):
        dim = spatial_axis % 5
        image = torch.as_tensor(image).to(device)
        label = torch.as_tensor(label).to(device)
        h, _ = _halo_geometry(model, axis.size, image.shape[dim], spatial_axis, halo)
        img = _slab(image.float(), axis, dim)
        lab = _slab(label.float(), axis, dim)
        padded = halo_exchange(img, h, axis, dim)
        sharded = ShardedStats(axis=axis, spatial_axis=dim, halo=h, extent=padded.shape[dim])
        leaves = {k: v.detach().to(device).requires_grad_(True) for k, v in params.items()}
        out = _forward(model, leaves, padded, sharded, train=True)["y_softmax"]
        y_core = out.narrow(dim, h, padded.shape[dim] - 2 * h)
        local = torch.mean(seg_loss.per_sample_sums(lab, y_core))  # LOCAL share
        keys = [k for k, v in leaves.items() if v.requires_grad]
        grads = torch.autograd.grad(local, [leaves[k] for k in keys], allow_unused=True)
        grads = [g if g is not None else torch.zeros_like(leaves[k])
                 for k, g in zip(keys, grads)]
        *grads, loss = all_reduce_flat([*grads, local.detach().reshape(1)], axis.group)
        grads = dict(zip(keys, grads))
        with torch.no_grad():
            cur = {k: v.detach() for k, v in leaves.items()}
            updates, opt_state = optimizer.update(grads, opt_state, cur)
            new = {k: cur[k] + updates[k] if k in updates else cur[k] for k in cur}
        return new, opt_state, loss[0]

    return step


def spatial_infer_m1(
    model,
    params,
    volume,
    mesh: Mesh,
    spatial_axis: int = 2,
    mesh_axis: str = "spatial",
    halo: Optional[int] = None,
):
    """Halo-sharded M1 inference over a whole-gland volume (JAX
    ``halo.py:263-308``): the halo from the architecture's receptive margin
    rounded up to the cumulative stride along the axis, ``y_softmax`` of
    the forward on slab + halos with whole-volume statistics, gathered to
    every rank. Exact: sharded and unsharded agree to float tolerance.

    volume: (B, D, H, W, C), the same on every rank; ``params`` None runs
    the model's own parameters, a state dict those. No autograd: the norms
    run K3 on each core and K4 with the global statistics."""
    axis = _member_axis(mesh, mesh_axis)
    vol = torch.as_tensor(volume)
    dim = spatial_axis % vol.dim()
    h, slab = _halo_geometry(model, axis.size, vol.shape[dim], spatial_axis, halo)
    sharded = ShardedStats(axis=axis, spatial_axis=dim, halo=h, extent=slab + 2 * h)

    def predict(x):
        return _forward(model, params, x, sharded)["y_softmax"]

    fn = make_spatial_predict(predict, mesh, halo=h, spatial_axis=dim, mesh_axis=mesh_axis)
    with torch.no_grad():
        return fn(vol.float())
