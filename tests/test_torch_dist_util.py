"""Spawned gloo worlds for the port's multi-rank CPU tests
(tests/test_torch_{mesh,parallel_train,halo}.py); this module holds no test
of its own, and imports neither JAX nor the JAX package, so the ranks start
quickly.

:func:`run_world` starts ``world`` processes (``multiprocessing`` spawn),
each of which joins a gloo world over a TCP store on localhost, runs one
worker function of this module and saves what it returns. The parent joins
the world within its timeout (about 120 s); a rank that fails, or a world
that does not finish in time (a hung collective), is killed and fails the
test with the ranks' tracebacks. Each rank computes on one CPU thread.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import socket
import tempfile
import time
import traceback

import numpy as np
import torch

WORLD_TIMEOUT_S = 120


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _entry(rank, world, port, fn_name, args, out_dir):
    try:
        torch.set_num_threads(1)
        import torch.distributed as dist

        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                world_size=world, rank=rank)
        try:
            result = globals()[fn_name](rank, world, *args)
            torch.save(result, os.path.join(out_dir, f"{rank}.pt"))
        finally:
            dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise SystemExit(1)


def run_world(fn_name: str, world: int, *args, timeout: float = WORLD_TIMEOUT_S):
    """Run worker ``fn_name(rank, world, *args)`` of this module on ``world``
    gloo ranks; returns each rank's result, rank order."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as out_dir:
        port = free_port()
        procs = [ctx.Process(target=_entry, args=(r, world, port, fn_name, args, out_dir))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        errors = {}
        for r in range(world):
            path = os.path.join(out_dir, f"{r}.err")
            if os.path.exists(path):
                with open(path) as f:
                    errors[r] = f.read()
        if hung or errors or any(p.exitcode != 0 for p in procs):
            raise AssertionError(
                f"world {fn_name} x{world}: ranks {hung} still running after {timeout} s; "
                f"exit codes {[p.exitcode for p in procs]}\n"
                + "\n".join(f"--- rank {r}\n{e}" for r, e in errors.items()))
        return [torch.load(os.path.join(out_dir, f"{r}.pt"), weights_only=False)
                for r in range(world)]


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_np(v) for v in tree)
    if torch.is_tensor(tree):
        return tree.detach().cpu().numpy()
    return tree


# ------------------------------------------------------------------ workers
def _port_m1(config, params):
    from prostatemr_3d_cad_cspca_tpu_torch.models import M1

    model = M1(**{**config, "summary": False}, device="cpu", init_params=False)
    model.params = {k: torch.as_tensor(v) for k, v in params.items()}
    return model


def spatial_infer_world(rank, world, config, params, volume, n_spatial):
    """spatial_infer_m1 of the port's M1 on a (1, 1, n_spatial) mesh."""
    from prostatemr_3d_cad_cspca_tpu_torch.parallel import make_mesh
    from prostatemr_3d_cad_cspca_tpu_torch.parallel.halo import spatial_infer_m1

    model = _port_m1(config, params)
    mesh = make_mesh(n_data=1, n_spatial=n_spatial)
    return _np(spatial_infer_m1(model, None, torch.as_tensor(volume), mesh))


class CaptureOpt:
    """An optimizer that moves nothing and keeps the gradients as its state
    (tests/test_torch_util.py's, without JAX)."""

    def init(self, params):
        return None

    def update(self, grads, state, params):
        return {k: torch.zeros_like(g) for k, g in grads.items()}, grads


def _make_loss(loss_mode):
    from prostatemr_3d_cad_cspca_tpu_torch.train import trainer as tt

    return tt.make_loss(loss_mode)


def dp_step_world(rank, world, config, params, cases, mesh_shape=None):
    """``make_train_step(mesh=)`` on a (n_data, n_model, 1) mesh of this
    world (default (world, 1, 1)): for each case ``(batch, rng, kw)`` one
    step of a fresh copy of the parameters with the capturing optimizer.
    Returns [(gradients, metrics)] (the members' results; None on ranks
    outside the mesh)."""
    from prostatemr_3d_cad_cspca_tpu_torch.parallel import make_mesh
    from prostatemr_3d_cad_cspca_tpu_torch.train import trainer as tt

    n_data, n_model = mesh_shape or (world, 1)
    mesh = make_mesh(n_data=n_data, n_model=n_model)
    if not mesh.member:
        return None
    out = []
    for batch, rng, kw in cases:
        kw = dict(kw)
        loss = _make_loss(kw.pop("loss_mode", "distribution_focal"))
        model = _port_m1(config, params)
        opt = CaptureOpt()
        step = tt.make_train_step(model, loss, opt, mesh=mesh, **kw)
        state, metrics = step(tt.init_train_state(model, opt), batch, rng)
        out.append((_np(state.opt_state), {k: float(v) for k, v in metrics.items()}))
    return out


def run_cli(argv, timeout: float = WORLD_TIMEOUT_S):
    """The training CLI ``cli.main(argv)`` in a child process (its spawned
    workers in the child's session): killed with its workers, failing the
    test, where it does not finish within ``timeout``."""
    import signal
    import subprocess
    import sys

    code = ("import sys, torch; torch.set_num_threads(1); "
            "from prostatemr_3d_cad_cspca_tpu_torch import cli; cli.main(sys.argv[1:])")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, "-c", code, *argv], env=env,
                            start_new_session=True, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        raise AssertionError(f"the CLI did not finish in {timeout} s:\n{out[-4000:]}")
    if proc.returncode != 0:
        raise AssertionError(f"the CLI exited {proc.returncode}:\n{out[-4000:]}")
    return out


def _steps(model, mesh, opt, batches, rngs, kind, loss_mode="distribution_focal"):
    """K steps of ``kind`` ('single', 'scan' or 'accum'); the final
    parameters and the metrics."""
    from prostatemr_3d_cad_cspca_tpu_torch.train import trainer as tt

    loss = _make_loss(loss_mode)
    state = tt.init_train_state(model, opt)
    k = len(batches)
    if kind == "single":
        mets = []
        for b, r in zip(batches, rngs):
            state, m = tt.make_train_step(model, loss, opt, mesh=mesh)(state, b, r)
            mets.append(m)
    else:
        step = tt.make_train_step(model, loss, opt, mesh=mesh,
                                  **{f"{kind}_steps": k})
        stacked = {n: np.stack([b[n] for b in batches]) for n in batches[0]}
        state, mets = step(state, stacked, list(rngs))
    return ({n: v.detach().cpu().numpy() for n, v in model.net.named_parameters()},
            _np(mets))


def train_world(rank, world, config, params, cases):
    """Train-step cases on meshes of this world; each case is ``(what,
    mesh_shape, args)``:

      * 'grads': (batch, rng, kw) -> (gradients, metrics) of one step with
        the capturing optimizer (``kw``: loss_mode, augment_params, ...);
      * 'steps': (batches, rngs, kind) -> (parameters, metrics) after
        ``kind`` ('single', 'scan', 'accum') over the batches, SGD momentum
        1e-3;
      * 'tp': (batch, rng, min_channels) -> the momentum (1e-3) step of a
        state sharded over 'model': (parameters, metrics, shard shapes,
        moment shapes);
      * 'fit': (batches, epochs, weights_dir) -> (history, parameters) of
        ``fit(mesh=)`` with momentum 1e-3.

    Returns each case's result on mesh members (None elsewhere)."""
    from prostatemr_3d_cad_cspca_tpu_torch.parallel import make_mesh
    from prostatemr_3d_cad_cspca_tpu_torch.parallel.sharding import shard_state
    from prostatemr_3d_cad_cspca_tpu_torch.train import trainer as tt

    out = []
    for what, shape, args in cases:
        mesh = make_mesh(n_data=shape[0], n_model=shape[1])
        if not mesh.member:
            out.append(None)
            continue
        model = _port_m1(config, params)
        if what == "grads":
            batch, rng, kw = args
            kw = dict(kw)
            loss = _make_loss(kw.pop("loss_mode", "distribution_focal"))
            opt = CaptureOpt()
            state, m = tt.make_train_step(model, loss, opt, mesh=mesh, **kw)(
                tt.init_train_state(model, opt), batch, rng)
            out.append((_np(state.opt_state), {k: float(v) for k, v in m.items()}))
        elif what == "steps":
            batches, rngs, kind = args
            out.append(_steps(model, mesh, tt.make_optimizer("momentum", 1e-3), batches,
                              rngs, kind))
        elif what == "tp":
            batch, rng, min_channels = args
            opt = tt.make_optimizer("momentum", 1e-3)
            state = shard_state(tt.init_train_state(model, opt), mesh, min_channels)
            step = tt.make_train_step(model, _make_loss("distribution_focal"), opt, mesh=mesh)
            state, m = step(state, batch, rng)
            out.append(({n: v.detach().numpy() for n, v in model.net.named_parameters()},
                        {k: float(v) for k, v in m.items()},
                        {k: tuple(v.shape) for k, v in state.shards.items()},
                        {k: tuple(v.shape) for k, v in state.opt_state["trace"].items()}))
        elif what == "fit":
            batches, epochs, weights_dir = args
            hist = tt.fit(model, iter(batches * epochs), epochs=epochs,
                          steps_per_epoch=len(batches),
                          optimizer=tt.make_optimizer("momentum", 1e-3), mesh=mesh,
                          weights_dir=weights_dir, weights_min_epoch=1,
                          store_weights_per_n_epochs=1, verbose=0)
            out.append((hist["loss"], {n: v.detach().numpy()
                                       for n, v in model.net.named_parameters()}))
    return out


def _stack_net(p, v, sharded=None):
    """conv (3^3, SAME) -> sharded IN -> SE gate: the JAX package's pinned
    gradient stack (tests/test_spatial_train.py:80-100)."""
    from prostatemr_3d_cad_cspca_tpu_torch.ops.convolution import conv3d
    from prostatemr_3d_cad_cspca_tpu_torch.ops.normalization import (global_spatial_mean,
                                                                     instance_norm)

    h = conv3d(v, p["w1"])
    h = instance_norm(h, p["scale"], p["bias"], sharded=sharded)
    g = global_spatial_mean(h, sharded).to(h.dtype)
    s = torch.sigmoid(torch.einsum(
        "bdhwc,co->bdhwo",
        torch.nn.functional.leaky_relu(torch.einsum("bdhwc,co->bdhwo", g, p["w6"]) + p["b6"],
                                       0.1),
        p["w7"]))
    return h * s


def halo_world(rank, world, cases):
    """Halo-sharded cases on a (1, 1, world) mesh; each ``(what, args)``:

      * 'exchange': (x, halo, weights) -> (this rank's padded slab, the
        gradient of sum(padded * weights[rank]) summed over the ranks with
        respect to its slab);
      * 'infer': (config, params, volume) -> spatial_infer_m1's output;
      * 'step': (config, params, image, label, lr) -> the losses of two
        spatial train steps (focal (1, 1) gamma 2, SGD lr);
      * 'stack': (params, x, halo) -> (loss, gradients) of the conv + IN +
        SE stack on slabs + halos, summed over the ranks."""
    from prostatemr_3d_cad_cspca_tpu_torch.losses import Focal
    from prostatemr_3d_cad_cspca_tpu_torch.ops.normalization import ShardedStats
    from prostatemr_3d_cad_cspca_tpu_torch.parallel import make_mesh
    from prostatemr_3d_cad_cspca_tpu_torch.parallel.collectives import all_reduce_flat
    from prostatemr_3d_cad_cspca_tpu_torch.parallel.halo import (
        halo_exchange, make_spatial_train_step, spatial_infer_m1)
    from prostatemr_3d_cad_cspca_tpu_torch.train.trainer import SGDNesterov

    mesh = make_mesh(n_data=1, n_spatial=world)
    axis = mesh.axis("spatial")
    out = []
    for what, args in cases:
        if what == "exchange":
            x, halo, weights = args
            n = x.shape[1] // world
            xl = torch.as_tensor(x[:, rank * n:(rank + 1) * n]).clone().requires_grad_(True)
            padded = halo_exchange(xl, halo, axis, 1)
            (padded * torch.as_tensor(weights[rank])).sum().backward()
            out.append((_np(padded), _np(xl.grad)))
        elif what == "infer":
            config, params, volume = args
            out.append(_np(spatial_infer_m1(_port_m1(config, params), None,
                                            torch.as_tensor(volume), mesh)))
        elif what == "step":
            config, params, image, label, lr = args
            model = _port_m1(config, params)
            tx = SGDNesterov(lr, momentum=0.0)
            step = make_spatial_train_step(model, Focal((1.0, 1.0), 2.0), tx, mesh)
            p = {k: v.detach() for k, v in model.net.named_parameters()}
            p, st, l1 = step(p, tx.init(p), image, label)
            _, _, l2 = step(p, tx.init(p), image, label)
            out.append((float(l1), float(l2)))
        elif what == "stack":
            params, x, halo = args
            n = x.shape[2] // world
            p = {k: torch.as_tensor(v).clone().requires_grad_(True) for k, v in params.items()}
            xl = torch.as_tensor(x[:, :, rank * n:(rank + 1) * n])
            pad = halo_exchange(xl, halo, axis, 2)
            sh = ShardedStats(axis=axis, spatial_axis=2, halo=halo, extent=pad.shape[2])
            core = _stack_net(p, pad, sh)[:, :, halo:pad.shape[2] - halo]
            loss = (core[..., :2] ** 2).sum()
            keys = list(p)
            grads = torch.autograd.grad(loss, [p[k] for k in keys])
            *grads, total = all_reduce_flat([*grads, loss.detach().reshape(1)], axis.group)
            out.append((float(total[0]), {k: g.numpy() for k, g in zip(keys, grads)}))
    return out


def mesh_world(rank, world, x, w, c, batch):
    """Meshes and collectives in a world of 4: each mesh's coordinates and
    group sums, the psum's transpose, all_gather, this rank's rows of a
    global batch."""
    from prostatemr_3d_cad_cspca_tpu_torch.parallel import (host_local_batch_to_global,
                                                            make_hybrid_mesh, make_mesh)
    from prostatemr_3d_cad_cspca_tpu_torch.parallel.collectives import all_gather, psum

    out = {}
    for shape in ((4, 1, 1), (2, 2, 1), (1, 2, 2), (2, 1, 1)):
        mesh = make_mesh(*shape)
        if not mesh.member:
            out[shape] = None
            continue
        sums = {a: float(psum(torch.tensor([float(rank)]), mesh.axis(a))[0])
                for a in ("data", "model", "spatial")}
        out[shape] = (mesh.coords, dict(mesh.shape), sums, str(mesh.device))
    hybrid = make_hybrid_mesh(n_data_dcn=2, n_model=2)
    out["hybrid"] = (dict(hybrid.shape), hybrid.coords)
    mesh = make_mesh(n_data=4)
    axis = mesh.axis("data")
    xr = torch.as_tensor(x[rank]).clone().requires_grad_(True)
    y = psum(xr * torch.as_tensor(w[rank]), axis)
    (y * torch.as_tensor(c[rank])).sum().backward()
    out["psum"] = (_np(y.detach()), _np(xr.grad))
    out["gather"] = _np(all_gather(torch.full((2,), float(rank)), axis))
    out["rows"] = _np(host_local_batch_to_global(mesh, batch))
    return out
