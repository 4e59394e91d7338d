"""Device meshes on ``torch.distributed``, port of the JAX package's
``parallel/mesh.py``.

A :class:`Mesh` has JAX's axes ``data`` (the batch), ``model`` (the wide
stages' channels, ``parallel.sharding``) and ``spatial`` (slabs of a
volume with halos, ``parallel.halo``), and a ``(n_data, n_model,
n_spatial)`` array of devices. It serves two execution models, as JAX's
single controller and its SPMD programs do:

  * one process, no world: the mesh is a list of devices (a device may
    repeat, the counterpart of XLA's forced host devices), and inference
    runs a replica on each ``data`` device (``serve.InferenceSession``,
    ``infer.make_sliding_window_fn``);
  * one process per mesh position, in a world that
    :func:`initialize_distributed` (or the caller) has set up: position i
    (row-major over ``(data, model, spatial)``) is rank i, and the mesh
    holds this rank's coordinates, its device and a process group per axis
    (and one over the whole mesh). Training and spatial sharding run here.

The backend is the world's: NCCL for ranks on cards and gloo on the CPU,
unless the caller names one; nothing switches it. ``make_mesh`` is
collective in a world: every rank calls it, in the same order.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .collectives import Axis

AXES = ("data", "model", "spatial")


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
    backend: Optional[str] = None,
) -> bool:
    """Join the world of processes (one per mesh position). Call before the
    first mesh is made.

    Sources, in precedence order, as the JAX package's:
      1. explicit arguments;
      2. ``PROSTATEMR_COORDINATOR`` (host:port of rank 0's TCP store) /
         ``PROSTATEMR_NUM_PROCESSES`` / ``PROSTATEMR_PROCESS_ID``;
      3. ``PROSTATEMR_MULTIHOST=1``: torchrun's ``env://`` variables
         (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).

    ``backend`` defaults to NCCL where a card is visible and gloo where none
    is; with NCCL this process's card is ``local_device_ids[0]``, else
    ``LOCAL_RANK``, else the rank modulo the cards. Returns True once the
    world exists (a second call is a no-op), False for a single process.
    A partial configuration raises ``ValueError``.
    """
    if dist.is_initialized():
        return True
    env = os.environ
    coordinator_address = coordinator_address or env.get("PROSTATEMR_COORDINATOR")
    if num_processes is None and env.get("PROSTATEMR_NUM_PROCESSES"):
        num_processes = int(env["PROSTATEMR_NUM_PROCESSES"])
    if process_id is None and env.get("PROSTATEMR_PROCESS_ID"):
        process_id = int(env["PROSTATEMR_PROCESS_ID"])
    auto = env.get("PROSTATEMR_MULTIHOST", "") == "1"
    if coordinator_address is None and num_processes is None and not auto:
        return False  # single-process: nothing to do
    if not auto:
        given = {
            "PROSTATEMR_COORDINATOR": coordinator_address,
            "PROSTATEMR_NUM_PROCESSES": num_processes,
            "PROSTATEMR_PROCESS_ID": process_id,
        }
        missing = [k for k, v in given.items() if v is None]
        if missing:
            raise ValueError(
                "Partial multi-host configuration: "
                f"{[k for k, v in given.items() if v is not None]} set but "
                f"{missing} missing. Set all three env vars (or pass the "
                "corresponding arguments), or set PROSTATEMR_MULTIHOST=1 for "
                "torchrun's env:// variables.")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        if local_device_ids:
            card = int(local_device_ids[0])
        elif env.get("LOCAL_RANK"):
            card = int(env["LOCAL_RANK"])
        else:
            rank = int(process_id if not auto else env["RANK"])
            card = rank % max(torch.cuda.device_count(), 1)
        torch.cuda.set_device(card)
    if auto:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=int(num_processes), rank=int(process_id))
    return True


def _world() -> Optional[Tuple[int, int]]:
    """(rank, world size) in an initialized world, else None."""
    if not dist.is_initialized():
        return None
    return dist.get_rank(), dist.get_world_size()


def _default_device(rank: Optional[int]) -> torch.device:
    """A position's device when the caller names none: in a world, the
    rank's card under NCCL and the CPU under gloo; in one process, the
    first card, or the CPU where there is none."""
    if rank is not None:
        if dist.get_backend() == "nccl":
            return torch.device("cuda", rank % torch.cuda.device_count())
        return torch.device("cpu")
    return torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")


class Mesh:
    """A ``(data, model, spatial)`` array of devices (``devices``, shape
    keyed by axis name in ``shape``). In a world it also holds this rank's
    ``coords`` (None where the rank lies outside the mesh), its ``device``
    and a group per axis; see the module docstring."""

    axis_names = AXES

    def __init__(self, devices: np.ndarray, rank: Optional[int] = None,
                 groups: Optional[Dict[str, Any]] = None):
        self.devices = devices
        self.shape = dict(zip(AXES, (int(n) for n in devices.shape)))
        self.size = int(devices.size)
        self.rank = rank
        self._groups = groups or {}
        if rank is not None and rank < self.size:
            self.coords = tuple(int(i) for i in np.unravel_index(rank, devices.shape))
            self.device = devices[self.coords]
        else:
            self.coords = None
            self.device = devices.flat[0]

    @property
    def distributed(self) -> bool:
        """True in a world (one process per position)."""
        return self.rank is not None

    @property
    def member(self) -> bool:
        """This process holds a position: any single process, or a rank
        below the mesh's size."""
        return self.rank is None or self.coords is not None

    @property
    def is_writer(self) -> bool:
        """The one process that writes files: rank 0, or a single process."""
        return self.rank is None or self.rank == 0

    def axis(self, name: str) -> Axis:
        """This rank's view of axis ``name`` (index 0 and no group outside a
        world)."""
        size = self.shape[name]
        if self.coords is None:
            return Axis(name, size)
        return Axis(name, size, self.coords[AXES.index(name)], self._groups[name])

    @property
    def group(self):
        """The process group over the whole mesh (None outside a world)."""
        return self._groups.get("mesh")

    def __repr__(self):
        where = f", rank={self.rank}, coords={self.coords}" if self.distributed else ""
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]}{where})"


def _groups(shape: Tuple[int, int, int]) -> Dict[str, Any]:
    """One process group per axis (the ranks that differ only along it) and
    one over the whole mesh; every rank of the world creates every group,
    in the same order, and keeps the ones it belongs to."""
    rank = dist.get_rank()
    ranks = np.arange(int(np.prod(shape))).reshape(shape)
    mine: Dict[str, Any] = {}
    for ax, name in enumerate(AXES):
        lines = np.moveaxis(ranks, ax, -1).reshape(-1, shape[ax])
        for line in lines:
            group = dist.new_group([int(r) for r in line])
            if rank in line:
                mine[name] = group
    group = dist.new_group([int(r) for r in ranks.reshape(-1)])
    if rank < ranks.size:
        mine["mesh"] = group
    return mine


def make_mesh(
    n_data: Optional[int] = None,
    n_model: int = 1,
    n_spatial: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a (data, model, spatial) mesh.

    Outside a world its positions are ``devices`` (default: every card, or
    the CPU where there is none; a device may repeat). In a world they are
    ranks 0 .. size-1 (the mesh may leave the last ranks out, as JAX's takes
    the first devices), ``devices[i]`` rank i's device (default
    :func:`_default_device`); every rank must call it."""
    world = _world()
    if world is not None:
        rank, total = world
        if devices is None:
            devices = [_default_device(r) for r in range(total)]
    else:
        rank = None
        if devices is None:
            devices = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
                       or [torch.device("cpu")])
        total = len(devices)
    devices = [torch.device(d) for d in devices]
    if n_data is None:
        assert total % (n_model * n_spatial) == 0, (total, n_model, n_spatial)
        n_data = total // (n_model * n_spatial)
    shape = (int(n_data), int(n_model), int(n_spatial))
    used = int(np.prod(shape))
    assert used <= total, f"mesh needs {used} devices, have {total}"
    assert used <= len(devices), f"mesh needs {used} devices, {len(devices)} given"
    arr = np.empty(shape, dtype=object)
    for i, d in enumerate(devices[:used]):
        arr[np.unravel_index(i, shape)] = d
    groups = _groups(shape) if world is not None else None
    return Mesh(arr, rank, groups)


def make_hybrid_mesh(
    n_data_dcn: Optional[int] = None,
    n_model: int = 1,
    n_spatial: int = 1,
) -> Mesh:
    """(data, model, spatial) mesh across hosts: the ``data`` axis splits
    into the hosts (``n_data_dcn``, default the world's hosts: its size over
    ``LOCAL_WORLD_SIZE``) times the ranks of a host, so ``model`` and
    ``spatial`` groups stay inside one host (ranks of a host are
    contiguous) and the gradient's all-reduce crosses hosts once a step.
    A single process or one host gives :func:`make_mesh`."""
    world = _world()
    if world is None:
        return make_mesh(n_model=n_model, n_spatial=n_spatial)
    total = world[1]
    local = int(os.environ.get("LOCAL_WORLD_SIZE", 0)) or max(torch.cuda.device_count(), 1)
    if n_data_dcn is None:
        n_data_dcn = max(total // local, 1)
    if n_data_dcn == 1:
        return make_mesh(n_model=n_model, n_spatial=n_spatial)
    per = n_model * n_spatial
    assert total % (n_data_dcn * per) == 0, (total, n_data_dcn, per)
    assert (total // n_data_dcn) % per == 0, (total, n_data_dcn, per)
    return make_mesh(n_data=total // per, n_model=n_model, n_spatial=n_spatial)


def data_rows(mesh: Mesh, batch_size: int) -> slice:
    """This rank's rows of a global batch: the ``data`` index's equal share
    (the whole batch outside a world)."""
    n = mesh.shape["data"]
    assert_batch_divisible(batch_size, n)
    if mesh.coords is None:
        return slice(0, batch_size)
    b = batch_size // n
    d = mesh.coords[0]
    return slice(d * b, (d + 1) * b)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def host_local_batch_to_global(mesh: Mesh, batch):
    """This rank's part of a global batch, as tensors on its device: every
    process loads the same global batch (the JAX package's single
    controller holds it whole) and keeps its ``data`` rows, the shard that
    JAX's global array places on this rank's device. Outside a world, the
    whole batch on the mesh's first device. The train step takes its rows
    here."""
    rows = None

    def local(x):
        nonlocal rows
        t = x if torch.is_tensor(x) else torch.from_numpy(np.ascontiguousarray(x))
        if rows is None:
            rows = data_rows(mesh, int(t.shape[0]))
        return t[rows].to(mesh.device).contiguous()

    return _tree_map(local, batch)


class NamedSharding:
    """Where a tensor lives on a mesh: ``spec`` names the mesh axis each of
    its dims is split over (None: whole), as JAX's ``NamedSharding``. A
    descriptor kept for parity with the JAX package's API (its tests hold
    the two side by side); no path of the port places a tensor by it."""

    def __init__(self, mesh: Mesh, spec: "P"):
        self.mesh, self.spec = mesh, spec

    def __repr__(self):
        return f"NamedSharding({self.spec})"


class P(tuple):
    """A partition spec (JAX's ``PartitionSpec``): a mesh axis name or None
    per dim; ``P()`` replicates."""

    def __new__(cls, *names):
        return super().__new__(cls, names)

    def __repr__(self):
        return f"P({', '.join(map(repr, self))})"


def data_sharding(mesh: Mesh, ndim: int) -> NamedSharding:
    """Batch-axis sharding for an ndim array (axis 0 = batch); a parity
    descriptor, as :class:`NamedSharding`: the rows themselves are taken by
    :func:`host_local_batch_to_global`."""
    return NamedSharding(mesh, P("data", *([None] * (ndim - 1))))


def replicated(mesh: Mesh) -> NamedSharding:
    """The whole tensor on every position; a parity descriptor."""
    return NamedSharding(mesh, P())


def setup_device(device_ids: str = "all", device: str = "cuda") -> Tuple[list, int]:
    """Reference misc.py:27-58 parity: a device-id string -> (devices, count).
    'all' takes every card (the CPU once with ``device='cpu'``); ids select
    cards, or with ``device='cpu'`` as many CPU positions (the counterpart of
    JAX's forced host devices). A card that does not exist raises."""
    from ..device import resolve_device

    dev = resolve_device(device)
    ids = ([] if device_ids in ("all", "", None)
           else [int(i) for i in str(device_ids).split(",")])
    if dev.type != "cuda":
        devs = [torch.device("cpu")] * max(len(ids), 1)
        return devs, len(devs)
    count = torch.cuda.device_count()
    if not ids:
        ids = list(range(count))
    bad = [i for i in ids if not 0 <= i < count]
    if bad:
        raise ValueError(f"--GPU_DEVICE_IDs {device_ids}: no card {bad} ({count} visible)")
    devs = [torch.device("cuda", i) for i in ids]
    return devs, len(devs)


def assert_batch_divisible(batch_size: int, num_devices: int):
    """train_model.py:170 parity."""
    assert batch_size % max(num_devices, 1) == 0, (
        f"Batch size ({batch_size}) should be a multiple of the number of "
        f"devices ({num_devices}).")
