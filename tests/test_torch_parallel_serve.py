"""Data-parallel inference of the port against the JAX package's, on the CPU:
``InferenceSession(mesh=)`` over a one-process mesh of 4 CPU positions (the
counterpart of JAX's 4 forced host devices) for the deterministic and the
Monte-Carlo M1, the fold ensemble through a mesh session, the
sliding-window program with its case axis split over the mesh, and
``serve.run --DATA_PARALLEL 2``.

The models and batches are tests/test_torch_infer.py's (the verify skill's
tiny M1 at 8x32x32, parameters redrawn by numpy). Tolerance: fp32 atol
2e-5 (the repo's oracle tolerance). JAX's draws cannot be made by the
port, so the MC session is held to JAX's ``mc_predict`` with JAX's
keep-masks replayed through the session's data-parallel forward, and to
the port's one-device session with the same seed bit for bit (each device
takes its rows of the draws made for the whole batch).
"""

import os

import jax
import numpy as np
import pytest
import torch

from prostatemr_3d_cad_cspca_tpu import ensemble as jens
from prostatemr_3d_cad_cspca_tpu import infer as jinfer
from prostatemr_3d_cad_cspca_tpu import serve as jserve
from prostatemr_3d_cad_cspca_tpu.parallel import mesh as jmesh
from prostatemr_3d_cad_cspca_tpu_torch import ensemble as tens
from prostatemr_3d_cad_cspca_tpu_torch import infer as tinfer
from prostatemr_3d_cad_cspca_tpu_torch import prng
from prostatemr_3d_cad_cspca_tpu_torch import serve as tserve
from prostatemr_3d_cad_cspca_tpu_torch.parallel import mesh as tmesh
from test_torch_infer import (ATOL, BIG, MC, SITES, SPATIAL, _jax_model, _port,
                              _record_draw)
from test_torch_util import one_torch_thread  # noqa: F401  (autouse)


def cpu_mesh(n):
    return tmesh.make_mesh(n_data=n, devices=["cpu"] * n)


def jax_mesh(n):
    return jmesh.make_mesh(n_data=n, devices=jax.devices()[:n])


@pytest.fixture(scope="module")
def jdet():
    return _jax_model(0)


@pytest.fixture(scope="module")
def jmc():
    return _jax_model(0, **MC)


@pytest.fixture(scope="module")
def batch4():
    return np.random.default_rng(1).normal(size=(4, *SPATIAL, 3)).astype(np.float32)


@pytest.mark.parametrize("b", [4, 3])
def test_mesh_session_matches_jax(jdet, batch4, b):
    """n_data 4: batch 4, and batch 3 padded with its last case."""
    want, want_unc = jserve.InferenceSession(jdet, mesh=jax_mesh(4))(batch4[:b])
    sess = tserve.InferenceSession(_port(jdet), mesh=cpu_mesh(4), device="cpu")
    got, got_unc = sess(batch4[:b])
    assert got_unc is None and want_unc is None and got.shape == (b, *SPATIAL, 2)
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert len({id(det) for _, det in sess._replicas}) == 1  # one CPU: one replica


def test_mesh_session_mc_replays_jax_draws(jmc, batch4):
    """MC 3 through the mesh session's data-parallel forward (each of the 4
    devices its row of the 3 x 4 stacked draws) with JAX's keep-masks,
    against JAX's mc_predict."""
    key = jax.random.PRNGKey(5)
    want_mean, want_std = jinfer.mc_predict(jmc.get_detect_model(), jmc.params, batch4,
                                            key, 3, reduce="mean_std")
    draws = [_record_draw(jmc, batch4, k) for k in jax.random.split(key, 3)]
    masks = {s: np.concatenate([d[1][s] for d in draws]) for s in SITES}
    sess = tserve.InferenceSession(_port(jmc, **MC), mc_iter=3, mesh=cpu_mesh(4),
                                   device="cpu")
    with torch.no_grad():
        mean, std = sess._body(torch.as_tensor(batch4), masks)
    np.testing.assert_allclose(mean.numpy(), np.asarray(want_mean), atol=ATOL)
    np.testing.assert_allclose(std.numpy(), np.asarray(want_std), atol=ATOL)
    assert float(std.max()) > 1e-3


@pytest.mark.parametrize("extra", [{}, {"tta": True, "scan_chunk": 2}])
def test_mesh_session_mc_same_seed_same_draws(jmc, batch4, extra):
    """The same seed: the mesh session draws the one-device session's bits
    (with flip TTA and chunks of 2; a batch of 3 is the one-device batch
    padded to 4, as JAX's mesh session pads). Its outputs equal the
    one-device session's within 1e-6 (a CPU conv over 2 volumes rounds
    apart from one over 4 by ~1e-7; another draw moves them by > 1e-3), and
    its own bits again for the same seed."""
    pm = _port(jmc, **MC)
    one = tserve.InferenceSession(pm, mc_iter=3, seed=7, device="cpu", **extra)
    kw = dict(mc_iter=3, seed=7, mesh=cpu_mesh(2), device="cpu", **extra)
    dp, again = tserve.InferenceSession(pm, **kw), tserve.InferenceSession(pm, **kw)
    other = tserve.InferenceSession(pm, **{**kw, "seed": 8})
    padded = np.concatenate([batch4[:3], batch4[2:3]])
    for b, ref in ((4, batch4), (3, padded)):
        (m1, s1), (m2, s2), (m3, s3) = one(ref), dp(batch4[:b]), again(batch4[:b])
        m1, s1 = m1[:b], s1[:b]
        np.testing.assert_allclose(m2, m1, atol=1e-6)
        np.testing.assert_allclose(s2, s1, atol=1e-6)
        assert np.array_equal(m2, m3) and np.array_equal(s2, s3)
        assert float(s1.max()) > 1e-3
        assert np.abs(other(batch4[:b])[0] - m2).max() > 1e-3


def test_row_draws_are_the_global_draws():
    """prng.rows: the shards' rows of one draw for the whole batch, from a
    generator (drawn once) and from a mapping; repeat_rows for stacked
    samples."""
    gen = torch.Generator().manual_seed(3)
    want = torch.rand((6, 5), generator=torch.Generator().manual_seed(3))
    parts = prng.rows(gen, [range(0, 3), range(3, 6)], 6)
    got = [prng.uniform(p, (3, 5), "cpu", "u") for p in parts]
    assert torch.equal(torch.cat(got), want)
    stacked = torch.rand((12, 5), generator=torch.Generator().manual_seed(4))
    parts = prng.rows(torch.Generator().manual_seed(4), [range(0, 3), range(3, 6)], 6)
    got = [prng.uniform(prng.repeat_rows(p, 2), (6, 5), "cpu", "u") for p in parts]
    assert torch.equal(got[1], stacked[[3, 4, 5, 9, 10, 11]])
    m = {"a": np.arange(12).reshape(6, 2)}
    assert prng.rows(m, [range(2, 4)], 6)[0]["a"].tolist() == [[4, 5], [6, 7]]


def test_ensemble_on_data_parallel_mesh(jdet):
    """JAX tests/test_ensemble.py:193: a two-member ensemble through a mesh
    session of 4 (a padded batch of 5) equals the one-device ensemble
    session, and JAX's."""
    j2 = _jax_model(1)
    batch = np.random.default_rng(10).normal(size=(5, *SPATIAL, 3)).astype(np.float32)
    want, _ = jserve.InferenceSession(jens.M1Ensemble([jdet, j2]), mesh=jax_mesh(4))(batch)
    ens = tens.M1Ensemble([_port(jdet), _port(j2)])
    ref, _ = tserve.InferenceSession(ens, device="cpu")(batch)
    got, _ = tserve.InferenceSession(ens, mesh=cpu_mesh(4), device="cpu")(batch)
    assert got.shape == (5, *SPATIAL, 2)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_sliding_window_cases_split_over_the_mesh(jdet):
    """make_sliding_window_fn(mesh=) over K=4 cases on 2 devices: the
    model's tiles against JAX's mesh program; a drawing tile function gives
    the one-device program's bits; K that does not divide raises."""
    vols = np.random.default_rng(6).normal(size=(4, *BIG, 3)).astype(np.float32)
    jdetect = jdet.get_detect_model()
    jrun = jinfer.make_sliding_window_fn(lambda t: jdetect(jdet.params, t), BIG, SPATIAL, 3,
                                         2, cases=4, mesh=jax_mesh(2))
    pdetect = _port(jdet).get_detect_model()
    prun = tinfer.make_sliding_window_fn(lambda t: pdetect(None, t), BIG, SPATIAL, 3, 2,
                                         cases=4, mesh=cpu_mesh(2))
    with torch.no_grad():
        np.testing.assert_allclose(prun(vols).numpy(), np.asarray(jrun(vols)), atol=ATOL)

    def noisy(tiles, rng):
        return tiles[..., :1] + prng.uniform(rng, tiles[..., :1].shape, tiles.device, "u")

    kw = dict(cases=4, rng_per_chunk=True)
    one = tinfer.make_sliding_window_fn(noisy, BIG, SPATIAL, 3, 1, **kw)
    two = tinfer.make_sliding_window_fn(noisy, BIG, SPATIAL, 3, 1, mesh=cpu_mesh(2), **kw)
    a = one(torch.as_tensor(vols), torch.Generator().manual_seed(2))
    b = two(torch.as_tensor(vols), torch.Generator().manual_seed(2))
    assert torch.equal(a, b)
    with pytest.raises(AssertionError, match="must divide"):
        tinfer.make_sliding_window_fn(noisy, BIG, SPATIAL, 3, 1, cases=3, mesh=cpu_mesh(2))


def _manifest(tmp_path, shapes):
    rng = np.random.default_rng(2)
    lines = ["p-id,image_path"]
    for i, shape in enumerate(shapes):
        ip = str(tmp_path / f"case{i}.npy")
        np.save(ip, rng.normal(size=(*shape, 3)).astype(np.float32))
        lines.append(f"case{i},{ip}")
    man = str(tmp_path / "test.csv")
    with open(man, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return man


def test_serve_run_data_parallel_matches_jax(jdet, tmp_path):
    """serve.run --DATA_PARALLEL 2: three window cases (a batch padded to
    the data axis) and three whole-gland cases (a K-case sliding window
    rounded up to the axis) against JAX's run; an artifact refuses it."""
    ckpt = str(tmp_path / "model.npz")
    jdet.save(ckpt)
    man = _manifest(tmp_path, [SPATIAL] * 3 + [BIG] * 3)
    argv = ["--MODEL", ckpt, "--MANIFEST", man, "--BATCH_SIZE", "3", "--DATA_PARALLEL", "2"]
    want = jserve.run(jserve.build_parser().parse_args(
        argv + ["--OUTPUT_DIR", str(tmp_path / "jax")]))
    got = tserve.main(argv + ["--OUTPUT_DIR", str(tmp_path / "port"), "--DEVICE", "cpu"])
    assert [r["p-id"] for r in got] == [r["p-id"] for r in want] == [f"case{i}"
                                                                      for i in range(6)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.load(g["detection_path"]),
                                   np.load(w["detection_path"]), atol=ATOL)
    art = str(tmp_path / "m1.zip")
    for run in (lambda a: jserve.run(jserve.build_parser().parse_args(a)),
                lambda a: tserve.main(a + ["--DEVICE", "cpu"])):
        with pytest.raises(ValueError, match="live checkpoint"):
            run(["--MODEL", art, "--MANIFEST", man, "--OUTPUT_DIR", str(tmp_path / "x"),
                 "--DATA_PARALLEL", "2"])
    assert not os.path.exists(art)
