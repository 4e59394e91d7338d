"""Whole-gland cases from an exported artifact on the CPU: the
sliding-window programs (``export_model(sw_shapes=...)``,
``ExportedModel.predict_cases``, ``serve.ExportedSession.predict_cases``)
against the live session's sliding windows, through serve.run with an MC
artifact, and with mixed geometries (the sliding-window cases of JAX's
tests/test_export.py). Tiny config of tests/test_torch_util.py.
"""

import json
import os

import numpy as np
import pytest

from prostatemr_3d_cad_cspca_tpu_torch import export as exp
from prostatemr_3d_cad_cspca_tpu_torch import serve
from prostatemr_3d_cad_cspca_tpu_torch.models import M1
from test_torch_export_serve import MC, _manifest, _model, _run
from test_torch_util import SPATIAL
from test_torch_util import one_torch_thread  # noqa: F401  (autouse)

SW = (6, 24, 24)  # 8 tiles of the 4x16x16 window: 2 chunks of 4
SMALL = (4, 16, 24)  # 2 tiles: 1 chunk


def test_export_sliding_window_programs(tmp_path):
    """sw_shapes bakes one sliding-window program per geometry: whole-case
    outputs equal the live session's (same seed), the case axis is symbolic
    (3 cases through a program traced at 2), an unknown geometry raises
    with the available list."""
    tmp = str(tmp_path)
    pm, ckpt = _model(tmp)
    art = os.path.join(tmp, "m1sw.zip")
    exp.export_model(pm, art, sw_shapes=[SW])
    loaded = exp.ExportedModel.load(art, device="cpu")
    assert loaded.sw_geometries == [SW]
    assert loaded.sw_entries[SW]["out_mult"] == 1 and loaded.sw_entries[SW]["draws"] is None

    rng = np.random.default_rng(20)
    vols = [rng.normal(size=(*SW, 3)).astype(np.float32) for _ in range(3)]
    got = loaded.predict_cases(vols)
    refs = serve.InferenceSession(M1.load(ckpt, device="cpu"), device="cpu").predict_cases(
        vols, group_size=3)
    for (gp, gu), (rp, ru) in zip(got, refs):
        assert gu is None and ru is None
        np.testing.assert_allclose(gp, rp, atol=1e-4, rtol=1e-4)
        np.testing.assert_array_equal(gp, rp)
    with pytest.raises(ValueError, match="no sliding-window program"):
        loaded.predict_cases([rng.normal(size=(8, 24, 24, 3)).astype(np.float32)])


def test_serve_artifact_sliding_window_mc(tmp_path):
    """serve.run with an MC artifact that carries a sliding-window program:
    oversized cases go through it end to end, with uncertainty, equal to
    serving the checkpoint with the same seed and MC count."""
    tmp = str(tmp_path)
    pm, ckpt = _model(tmp, **MC)
    art = os.path.join(tmp, "mcsw.zip")
    exp.export_model(pm, art, mc_iter=2, sw_shapes=[SW])
    loaded = exp.ExportedModel.load(art, device="cpu")
    plan = loaded.sw_entries[SW]["draws"]
    assert loaded.sw_entries[SW]["out_mult"] == 2
    # two chunks, each with the trunk's eight sites; 2 samples x 4 tiles a case
    assert [e["path"] for e in plan] == [[0]] * 8 + [[1]] * 8
    assert {e["shape"][0] for e in plan} == {"8*k0"}

    man = _manifest(tmp, "mix", [SPATIAL, SW, SW], seed=21)
    results = _run(art, man, os.path.join(tmp, "out"), "--BATCH_SIZE", "2", "--SEED", "1")
    ref = _run(ckpt, man, os.path.join(tmp, "ref"), "--BATCH_SIZE", "2", "--MC_ITER", "2",
               "--SEED", "1")
    with open(os.path.join(tmp, "out", "predictions.json")) as f:
        assert [r["p-id"] for r in json.load(f)] == [f"case{i}" for i in range(3)]
    for r, want in zip(results, ref):
        det = np.load(r["detection_path"])
        assert det.shape == (*(SPATIAL if r["p-id"] == "case0" else SW), 2)
        assert "uncertainty_path" in r and np.all(np.isfinite(det))
        np.testing.assert_array_equal(det, np.load(want["detection_path"]))
        np.testing.assert_array_equal(np.load(r["uncertainty_path"]),
                                      np.load(want["uncertainty_path"]))


def test_exported_session_mixed_geometries(tmp_path):
    """predict_cases groups mixed-geometry cases by shape (results aligned
    with the input order) and pads partial groups."""
    tmp = str(tmp_path)
    pm, _ = _model(tmp)
    art = os.path.join(tmp, "multi.zip")
    exp.export_model(pm, art, sw_shapes=[SW, SMALL])
    loaded = exp.ExportedModel.load(art, device="cpu")
    sess = serve.ExportedSession(loaded)
    rng = np.random.default_rng(30)
    vols = [rng.normal(size=(*SW, 3)).astype(np.float32),
            rng.normal(size=(*SMALL, 3)).astype(np.float32),
            rng.normal(size=(*SW, 3)).astype(np.float32)]
    got = sess.predict_cases(vols, group_size=2)
    assert len(got) == 3
    ref0 = loaded.predict_cases([vols[0], vols[2]])
    ref1 = loaded.predict_cases([vols[1]])
    np.testing.assert_allclose(got[0][0], ref0[0][0], atol=1e-6)
    np.testing.assert_allclose(got[2][0], ref0[1][0], atol=1e-6)
    np.testing.assert_allclose(got[1][0], ref1[0][0], atol=1e-6)
    assert got[0][0].shape == (*SW, 2) and got[1][0].shape == (*SMALL, 2)
