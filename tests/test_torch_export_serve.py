"""Serving from an exported artifact on the CPU (``serve.ExportedSession``,
``serve.run --MODEL m1.zip``): the serving cases of JAX's
tests/test_export.py (serve.run from an artifact against checkpoint
serving, with the "live checkpoint" error for an oversized case that has no
sliding-window program; fixed-batch padding; the sliding-window cases are
in tests/test_torch_export_sw.py), the same seed giving the live session's
bits call after call, and the loader's artifact rules. Tiny config of
tests/test_torch_util.py.
"""

import csv
import json
import os

import numpy as np
import pytest

from prostatemr_3d_cad_cspca_tpu_torch import export as exp
from prostatemr_3d_cad_cspca_tpu_torch import serve
from prostatemr_3d_cad_cspca_tpu_torch.load import load_model_spec
from test_torch_util import SPATIAL, jax_model, port_model
from test_torch_util import one_torch_thread  # noqa: F401  (autouse)

MC = dict(dropout_mode="monte-carlo", dropout_rate=0.5)


def _model(tmp, seed=0, **kw):
    pm = port_model(jax_model(seed, **{"input_channels": 3, **kw}))
    path = os.path.join(tmp, f"model{seed}.npz")
    pm.save(path)
    return pm, path


def _manifest(tmp, name, shapes, seed):
    rng = np.random.default_rng(seed)
    rows = []
    for i, shape in enumerate(shapes):
        ip = os.path.join(tmp, f"{name}{i}.npy")
        np.save(ip, rng.normal(size=(*shape, 3)).astype(np.float32))
        rows.append({"p-id": f"case{i}", "image_path": ip})
    path = os.path.join(tmp, f"{name}.csv")
    with open(path, "w", newline="") as fh:
        w = csv.DictWriter(fh, fieldnames=list(rows[0]))
        w.writeheader()
        for r in rows:
            w.writerow(r)
    return path


def _run(model, man, out, *extra):
    return serve.run(serve.build_parser().parse_args(
        ["--MODEL", model, "--MANIFEST", man, "--OUTPUT_DIR", out, "--DEVICE", "cpu",
         *extra]))


def test_serve_from_artifact(tmp_path, capsys):
    """serve.run with --MODEL artifact.zip: window-sized cases served from
    the frozen program, equal to checkpoint serving with the same seed and
    MC count; an oversized case raises; inert flags are noted."""
    tmp = str(tmp_path)
    pm, ckpt = _model(tmp, **MC)
    art = os.path.join(tmp, "m1.zip")
    exp.export_model(pm, art, mc_iter=2)
    man = _manifest(tmp, "win", [SPATIAL] * 3, seed=9)

    results = _run(art, man, os.path.join(tmp, "out"), "--BATCH_SIZE", "2", "--SEED", "3",
                   "--TTA", "1")
    assert "TTA ignored" in capsys.readouterr().out
    assert len(results) == 3
    with open(os.path.join(tmp, "out", "predictions.json")) as f:
        assert [r["p-id"] for r in json.load(f)] == [f"case{i}" for i in range(3)]
    ref = _run(ckpt, man, os.path.join(tmp, "out2"), "--BATCH_SIZE", "2", "--MC_ITER", "2",
               "--SEED", "3")
    for got, want in zip(results, ref):
        det = np.load(got["detection_path"])
        assert det.shape == (*SPATIAL, 2) and "uncertainty_path" in got  # mc_iter 2 baked in
        np.testing.assert_array_equal(det, np.load(want["detection_path"]))
        np.testing.assert_array_equal(np.load(got["uncertainty_path"]),
                                      np.load(want["uncertainty_path"]))

    # an oversized case and no sliding-window program: a clear error
    man2 = _manifest(tmp, "big", [SPATIAL, (6, 24, 24)], seed=10)
    with pytest.raises(ValueError, match="live checkpoint"):
        _run(art, man2, os.path.join(tmp, "out3"), "--BATCH_SIZE", "2")


def test_exported_session_fixed_batch_padding(tmp_path):
    """A short batch pads up to a fixed-batch artifact's size and the padding
    is stripped; an over-full batch raises."""
    tmp = str(tmp_path)
    pm, _ = _model(tmp)
    art = os.path.join(tmp, "m1_b4.zip")
    exp.export_model(pm, art, batch=4)
    sess = serve.ExportedSession(exp.ExportedModel.load(art, device="cpu"))
    x = np.random.default_rng(12).normal(size=(2, *SPATIAL, 3)).astype(np.float32)
    probs, unc = sess(x)
    assert probs.shape == (2, *SPATIAL, 2) and unc is None
    np.testing.assert_allclose(probs, pm.predict(x).numpy(), atol=1e-6)
    big = np.random.default_rng(13).normal(size=(5, *SPATIAL, 3)).astype(np.float32)
    with pytest.raises(ValueError, match="fixed batch 4"):
        sess(big)


@pytest.mark.parametrize("kind", ["mc", "prob"])
def test_same_seed_gives_the_live_sessions_bits(tmp_path, kind):
    """ExportedModel.load(seed=s) and a live InferenceSession(seed=s) draw
    the same bits, call after call (three calls)."""
    tmp = str(tmp_path)
    if kind == "mc":
        pm, _ = _model(tmp, **MC)
        mc, cin = 4, 3
    else:
        pm = port_model(jax_model(0, input_channels=4, probabilistic=True,
                                  prob_latent_dims=(2, 1, 0, 0), **MC))
        mc, cin = 2, 4
    art = os.path.join(tmp, f"{kind}.zip")
    exp.export_model(pm, art, mc_iter=mc)
    sess = serve.ExportedSession(exp.ExportedModel.load(art, seed=11, device="cpu"))
    live = serve.InferenceSession(pm, mc_iter=mc, seed=11, device="cpu")
    rng = np.random.default_rng(40)
    for b in (2, 1, 2):
        x = rng.normal(size=(b, *SPATIAL, cin)).astype(np.float32)
        (gm, gs), (lm, ls) = sess(x), live(x)
        np.testing.assert_array_equal(gm, lm)
        np.testing.assert_array_equal(gs, ls)


def test_load_model_spec_serves_artifacts_only_where_allowed(tmp_path):
    tmp = str(tmp_path)
    pm, ckpt = _model(tmp)
    art = os.path.join(tmp, "m1.zip")
    exp.export_model(pm, art)
    got = load_model_spec(art, seed=2, allow_artifact=True, device="cpu")
    assert isinstance(got, exp.ExportedModel) and got.input_spatial_dims == SPATIAL
    for spec in (art, f"{ckpt},{art}"):
        with pytest.raises(ValueError, match="live checkpoint"):
            load_model_spec(spec, allow_artifact=spec != art, device="cpu")
    with pytest.raises(ValueError, match="live checkpoint"):  # export and evaluate refuse
        exp.main(["--MODEL", art, "--OUT", os.path.join(tmp, "again.zip"), "--DEVICE", "cpu"])
