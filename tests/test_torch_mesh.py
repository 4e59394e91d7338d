"""The port's meshes (``parallel.mesh``) and collectives
(``parallel.collectives``) against the JAX package's ``parallel.mesh`` and
``lax.psum``, on the CPU: ``initialize_distributed``'s single-process no-op
and partial-configuration errors, ``make_mesh``/``make_hybrid_mesh``
shapes, ``setup_device``, ``assert_batch_divisible``, the placement
descriptors, ``host_local_batch_to_global``, and in one spawned gloo world
of 4 ranks (tests/test_torch_dist_util.py) each mesh's coordinates and
axis groups and the psum's transpose against JAX's under ``shard_map`` on 4
forced host devices.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as JP

from prostatemr_3d_cad_cspca_tpu.parallel import mesh as jmesh
from prostatemr_3d_cad_cspca_tpu_torch.parallel import mesh as tmesh
from test_torch_dist_util import run_world

ENV = ("PROSTATEMR_COORDINATOR", "PROSTATEMR_NUM_PROCESSES", "PROSTATEMR_PROCESS_ID",
       "PROSTATEMR_MULTIHOST")


@pytest.fixture
def clean_env(monkeypatch):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


def test_initialize_distributed_is_a_no_op_for_one_process(clean_env):
    assert tmesh.initialize_distributed() is False
    assert jmesh.initialize_distributed() is False
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("given", [{"PROSTATEMR_COORDINATOR": "localhost:1"},
                                   {"PROSTATEMR_NUM_PROCESSES": "2"},
                                   {"PROSTATEMR_NUM_PROCESSES": "2",
                                    "PROSTATEMR_PROCESS_ID": "0"}])
def test_partial_configuration_raises_as_jax(clean_env, given):
    for k, v in given.items():
        clean_env.setenv(k, v)
    for init in (tmesh.initialize_distributed, jmesh.initialize_distributed):
        with pytest.raises(ValueError, match="Partial multi-host configuration") as err:
            init()
        assert all(k in str(err.value) for k in given)
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("kw", [dict(n_model=2), dict(n_data=2, n_spatial=2),
                                dict(n_data=1, n_model=2, n_spatial=4), dict(n_data=8)])
def test_make_mesh_shapes_match_jax(kw):
    want = jmesh.make_mesh(**kw, devices=jax.devices())
    got = tmesh.make_mesh(**kw, devices=["cpu"] * 8)
    assert got.shape == dict(want.shape)
    assert got.devices.shape == want.devices.shape
    assert not got.distributed and got.member and got.is_writer
    assert got.axis("data").size == want.shape["data"] and got.axis("data").group is None


def test_mesh_refusals_and_hybrid_mesh_match_jax():
    for make in (lambda: jmesh.make_mesh(n_data=9, devices=jax.devices()),
                 lambda: tmesh.make_mesh(n_data=9, devices=["cpu"] * 8),
                 lambda: jmesh.make_mesh(n_model=3, devices=jax.devices()),
                 lambda: tmesh.make_mesh(n_model=3, devices=["cpu"] * 8)):
        with pytest.raises(AssertionError):
            make()
    # one process: the hybrid mesh is make_mesh over the default devices
    assert dict(jmesh.make_hybrid_mesh().shape) == dict(jmesh.make_mesh().shape)
    assert tmesh.make_hybrid_mesh().shape == tmesh.make_mesh().shape == \
        {"data": 1, "model": 1, "spatial": 1}
    assert tmesh.make_mesh().device == torch.device("cpu")  # no card here


def test_setup_device_and_batch_divisibility_match_jax():
    jdevs, jn = jmesh.setup_device("0,1")
    devs, n = tmesh.setup_device("0,1", device="cpu")
    assert n == jn == len(jdevs) == 2 and devs == [torch.device("cpu")] * 2
    assert tmesh.setup_device("all", device="cpu") == ([torch.device("cpu")], 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.setup_device("0")
    for check in (jmesh.assert_batch_divisible, tmesh.assert_batch_divisible):
        check(4, 2)
        check(3, 0)
        with pytest.raises(AssertionError, match="multiple of the number"):
            check(3, 2)


def test_placements_and_the_one_process_batch_match_jax():
    jm, tm = jmesh.make_mesh(n_data=2, devices=jax.devices()[:2]), tmesh.make_mesh(
        n_data=2, devices=["cpu"] * 2)
    assert tuple(tmesh.data_sharding(tm, 3).spec) == tuple(jmesh.data_sharding(jm, 3).spec)
    assert tuple(tmesh.replicated(tm).spec) == tuple(jmesh.replicated(jm).spec) == ()
    batch = {"image": np.arange(24, dtype=np.float32).reshape(4, 2, 3)}
    want = jmesh.host_local_batch_to_global(jm, batch)
    got = tmesh.host_local_batch_to_global(tm, batch)
    np.testing.assert_array_equal(got["image"].numpy(), np.asarray(want["image"]))


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(0)
    x, w, c = (rng.normal(size=(4, 3)).astype(np.float32) for _ in range(3))
    batch = {"image": np.arange(8 * 2, dtype=np.float32).reshape(8, 2)}
    got = run_world("mesh_world", 4, x, w, c, batch)
    return dict(got=got, x=x, w=w, c=c, batch=batch)


def test_world_meshes_coordinates_and_axis_groups(world):
    """Position i is rank i, row-major over (data, model, spatial); each
    axis's psum sums the ranks that differ only along it; a mesh of 2 in a
    world of 4 leaves ranks 2 and 3 out."""
    for shape in ((4, 1, 1), (2, 2, 1), (1, 2, 2), (2, 1, 1)):
        ranks = np.arange(int(np.prod(shape))).reshape(shape)
        for r in range(4):
            got = world["got"][r][shape]
            if r >= ranks.size:
                assert got is None
                continue
            coords, mshape, sums, device = got
            assert coords == tuple(int(i) for i in np.unravel_index(r, shape))
            assert mshape == dict(zip(("data", "model", "spatial"), shape))
            assert device == "cpu"
            for ax, name in enumerate(("data", "model", "spatial")):
                line = np.moveaxis(ranks, ax, -1)[tuple(np.delete(coords, ax))]
                assert sums[name] == float(line.sum()), (shape, r, name)
    for r in range(4):  # 2 hosts' worth of data x model 2
        assert world["got"][r]["hybrid"] == ({"data": 2, "model": 2, "spatial": 1},
                                             tuple(int(i) for i in np.unravel_index(r, (2, 2, 1))))


def test_psum_transpose_matches_jax(world):
    """d/dx_r of sum_r' sum(psum(x * w) * c_r') is w_r * sum_r' c_r': JAX's
    psum transpose under check_vma=False (a psum of the cotangents)."""
    x, w, c = (jnp.asarray(world[k]) for k in "xwc")
    mesh = jmesh.make_mesh(n_data=4, devices=jax.devices()[:4])

    def local(xl, wl, cl):
        y = jax.lax.psum(xl * wl, "data")
        return y, jnp.sum(y * cl)[None]

    fn = shard_map(local, mesh=mesh, in_specs=(JP("data"),) * 3,
                   out_specs=(JP("data"), JP("data")), check_vma=False)
    y = fn(x, w, c)[0]
    grad = jax.grad(lambda v: jnp.sum(fn(v, w, c)[1]))(x)
    for r in range(4):
        got_y, got_grad = world["got"][r]["psum"]
        np.testing.assert_allclose(got_y, np.asarray(y)[r], rtol=1e-6)
        np.testing.assert_allclose(got_grad, np.asarray(grad)[r], rtol=1e-6)


def test_gather_and_each_ranks_rows(world):
    for r in range(4):
        got = world["got"][r]
        np.testing.assert_array_equal(got["gather"], np.repeat(np.arange(4.0), 2))
        np.testing.assert_array_equal(got["rows"]["image"],
                                      world["batch"]["image"][2 * r:2 * r + 2])
