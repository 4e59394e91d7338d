"""The two-stage cascaded M1 in the port against the JAX package, on the
CPU: ``decision_fusion`` (identity, noisy-or, bayes), ``M1CascadedNet``
deterministic and probabilistic (latent dims 0: no draw), each detect head,
checkpoints, the inference session with TTA and ensembles, and ``serve.run``
with an ``image_path_2`` manifest (window-sized and sliding-window), which
a single-stage model reads past. Tiny model and tolerances as in
tests/test_torch_util.py (fp32 atol 2e-5).
"""

import csv

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prostatemr_3d_cad_cspca_tpu import ensemble as jens
from prostatemr_3d_cad_cspca_tpu import serve as jserve
from prostatemr_3d_cad_cspca_tpu.models import M1 as JM1
from prostatemr_3d_cad_cspca_tpu.models.m1_net import decision_fusion as jfusion
from prostatemr_3d_cad_cspca_tpu_torch import ensemble as tens
from prostatemr_3d_cad_cspca_tpu_torch import serve as tserve
from prostatemr_3d_cad_cspca_tpu_torch.bridge import from_jax_params
from prostatemr_3d_cad_cspca_tpu_torch.models import M1 as TM1
from prostatemr_3d_cad_cspca_tpu_torch.models.m1_net import decision_fusion as tfusion
from test_torch_util import (ATOL, SPATIAL, assert_tree_close, inputs, jax_model,
                             port_model, to_np)
from test_torch_util import one_torch_thread  # noqa: F401  (autouse)

STAGE_KEYS = ("y_softmax", "y_sigmoid", "logits")
PROB_ZERO = dict(input_channels=4, probabilistic=True, prob_latent_dims=(0, 0, 0, 0),
                 deep_supervision=True)


@pytest.fixture(scope="module")
def jcasc():
    return jax_model(0, input_channels=3, cascaded="noisy-or")


@pytest.fixture(scope="module")
def exams():
    return inputs(1, 3), inputs(2, 3)


@pytest.mark.parametrize("strategy", ["identity", "noisy-or", "bayes"])
def test_decision_fusion_matches_jax(strategy):
    rng = np.random.default_rng(0)
    p, f = rng.random((2, 3, 4, 5)).astype(np.float32), rng.random((2, 3, 4, 5)).astype(
        np.float32)
    p[0, 0, 0, :2], f[0, 0, 0, :2] = 0.0, 1.0  # bayes' 1e-9 guard on 0 * 1
    want = jfusion(jnp.asarray(p), jnp.asarray(f), strategy)
    got = tfusion(torch.from_numpy(p), torch.from_numpy(f), strategy)
    assert got[1].shape == (2, 3, 4, 5, 2)
    assert_tree_close(got, to_np(want), atol=1e-6)


def test_decision_fusion_refuses_an_unknown_strategy():
    with pytest.raises(ValueError, match="fusion"):
        tfusion(torch.zeros(1), torch.zeros(1), "max")


def test_cascade_forward_matches_jax(jcasc, exams):
    want = to_np(dict(jcasc.apply(jcasc.params, exams)))
    model = port_model(jcasc)
    got = model(exams)
    # stage 2 takes stage 1's nc-1 leading softmax channels ++ image_2
    assert model.params["stage2.core.conve0.kernel"].shape[3] == 3 + 1
    for k in ("detection_1", "detection_2"):
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=ATOL)
    for stage in ("stage1", "stage2"):
        assert_tree_close({k: got[stage][k] for k in STAGE_KEYS},
                          {k: want[stage][k] for k in STAGE_KEYS})


@pytest.mark.parametrize("cascaded", [True, "identity", "bayes"])
def test_cascaded_as_bool_or_fusion_name(jcasc, exams, cascaded):
    """``cascaded=True`` fuses by 'identity', a string names the fusion."""
    jm = JM1(**{**jcasc.config, "cascaded": cascaded, "summary": False}, init_params=False)
    jm.params = jcasc.params
    want = to_np(dict(jm.apply(jm.params, exams)))
    got = port_model(jm)(exams)
    np.testing.assert_allclose(got["detection_2"].numpy(), want["detection_2"], atol=ATOL)


def test_cascade_detect_head_matches_jax(jcasc, exams):
    want = jcasc.predict(exams)
    model = port_model(jcasc)
    got = model.predict(exams)
    assert isinstance(got, tuple) and len(got) == 2
    assert_tree_close(got, to_np(want))
    full = model(exams)
    for g, stage in zip(got, ("stage1", "stage2")):
        np.testing.assert_array_equal(g.numpy(), full[stage]["y_softmax"][..., :2].numpy())


def test_probabilistic_cascade_matches_jax_without_draws(exams):
    """Latent dims (0, 0, 0, 0): the ladders sample nothing, so the full
    forward (both stages' five passes, KL, the inference fusion) and the
    detect head compare with no latent injected."""
    jm = jax_model(1, cascaded="bayes", **PROB_ZERO)
    x = (inputs(3, 4), inputs(4, 4))
    want = to_np(dict(jm.apply(jm.params, x)))
    model = port_model(jm)
    assert set(model.params) == set(from_jax_params(jm.params))
    got = model.apply(None, x)
    keys = ("detection_1", "detection_2", "infer_softmax_1", "infer_softmax_2",
            "infer_detection_1", "infer_detection_2", "KL_1", "KL_2")
    assert_tree_close({k: got[k] for k in keys}, {k: want[k] for k in keys})
    assert got["stage1"]["prob_softmax"].shape == (2, *SPATIAL, 8)
    # stage 2's prior takes (nc-1) + 4 - (nc-1) channels, its posterior 5
    assert model.params["stage2.prior.conve0.kernel"].shape[3] == 4
    assert model.params["stage2.posterior.conve0.kernel"].shape[3] == 5
    det = model.predict(x)
    assert_tree_close(det, (want["infer_softmax_1"], want["infer_softmax_2"]))


def test_jax_cascade_checkpoint_loads_with_every_leaf_matched(jcasc, exams, tmp_path):
    path = str(tmp_path / "casc.npz")
    jcasc.save(path)
    model = TM1.load(path, device="cpu")
    assert model.config == jcasc.config and model.cascaded == "noisy-or"
    flat = from_jax_params(jcasc.params)
    assert set(model.params) == set(flat)
    model.load_weights(path, strict=True)
    back_path = str(tmp_path / "port.npz")
    model.save(back_path)
    back = JM1.load(back_path)
    want = jcasc.predict(exams)
    assert_tree_close(back.predict(exams), to_np(want), atol=0)


@pytest.mark.parametrize("tta", [False, True])
def test_inference_session_matches_jax(jcasc, exams, tta):
    """A pair of batches, and one batch that feeds both stages; the session
    serves stage 2's detection."""
    jsess = jserve.InferenceSession(jcasc, tta=tta)
    tsess = tserve.InferenceSession(port_model(jcasc), tta=tta, device="cpu")
    for batch in (exams, exams[0]):
        want, _ = jsess(batch)
        got, unc = tsess(batch)
        assert unc is None and got.shape == want.shape == (2, *SPATIAL, 2)
        np.testing.assert_allclose(got, want, atol=ATOL)


def test_two_member_cascade_ensemble_matches_jax(jcasc, exams):
    other = jax_model(5, input_channels=3, cascaded="noisy-or")
    want = jens.M1Ensemble([jcasc, other]).predict(exams)
    got = tens.M1Ensemble([port_model(jcasc), port_model(other)]).predict(exams)
    assert_tree_close(got, to_np(want))


def test_mc_cascade_session_draws_per_seed(jcasc, exams):
    model = port_model(jcasc, dropout_mode="monte-carlo", dropout_rate=0.5)
    mean, std = tserve.InferenceSession(model, mc_iter=3, seed=1, device="cpu")(exams)
    again = tserve.InferenceSession(model, mc_iter=3, seed=1, device="cpu")(exams)
    assert std.shape == mean.shape == (2, *SPATIAL, 2)
    assert float(std.min()) >= 0 and float(std.max()) > 0
    np.testing.assert_array_equal(again[0], mean)
    np.testing.assert_array_equal(again[1], std)


# ------------------------------------------------------------------ serving
def _two_exam_manifest(tmp_path, shapes, second=True):
    rng = np.random.default_rng(6)
    rows = []
    for i, shape in enumerate(shapes):
        row = {"p-id": f"case{i}"}
        for col in ("image_path", "image_path_2") if second else ("image_path",):
            path = str(tmp_path / f"{col}_{i}.npy")
            np.save(path, rng.normal(size=(*shape, 3)).astype(np.float32))
            row[col] = path
        rows.append(row)
    man = str(tmp_path / "m.csv")
    with open(man, "w", newline="") as fh:
        w = csv.DictWriter(fh, fieldnames=list(rows[0]))
        w.writeheader()
        [w.writerow(r) for r in rows]
    return man


def _serve_both(ckpt, man, tmp_path):
    argv = ["--MODEL", ckpt, "--MANIFEST", man, "--BATCH_SIZE", "2"]
    want = jserve.run(jserve.build_parser().parse_args(argv + ["--OUTPUT_DIR",
                                                               str(tmp_path / "j")]))
    got = tserve.run(tserve.build_parser().parse_args(
        argv + ["--OUTPUT_DIR", str(tmp_path / "t"), "--DEVICE", "cpu"]))
    assert [r["p-id"] for r in got] == [r["p-id"] for r in want]
    for g, w in zip(got, want):
        a, b = np.load(g["detection_path"]), np.load(w["detection_path"])
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=ATOL)
        assert abs(g["case_score"] - w["case_score"]) <= ATOL
    return got


def test_serve_run_single_stage_reads_past_image_path_2(tmp_path):
    """The one open fault of the port: a single-stage model with an
    ``image_path_2`` column serves, the column ignored, as in JAX."""
    jm = jax_model(2, input_channels=3)
    ckpt = str(tmp_path / "single.npz")
    jm.save(ckpt)
    got = _serve_both(ckpt, _two_exam_manifest(tmp_path, [SPATIAL, SPATIAL]), tmp_path)
    assert len(got) == 2


def test_serve_run_cascade_with_a_second_exam_matches_jax(tmp_path):
    """bayes fusion; window-sized cases batch their exam pairs, a
    whole-gland case tiles both exams at the same coordinates; a different
    second exam changes the output."""
    jm = jax_model(3, input_channels=3, cascaded="bayes")
    ckpt = str(tmp_path / "casc.npz")
    jm.save(ckpt)
    man = _two_exam_manifest(tmp_path, [SPATIAL, SPATIAL, (6, 24, 24)])
    got = _serve_both(ckpt, man, tmp_path)
    assert np.load(got[2]["detection_path"]).shape == (6, 24, 24, 2)
    sess = tserve.InferenceSession(TM1.load(ckpt, device="cpu"), device="cpu")
    with open(man) as fh:
        row = next(csv.DictReader(fh))
    v1 = np.load(row["image_path"])
    same, _ = sess.predict_case((v1, v1))
    assert not np.allclose(np.load(got[0]["detection_path"]), same, atol=1e-6)


def test_serve_run_cascade_without_a_second_exam_matches_jax(jcasc, tmp_path):
    ckpt = str(tmp_path / "casc.npz")
    jcasc.save(ckpt)
    man = _two_exam_manifest(tmp_path, [SPATIAL, (6, 24, 24), (6, 24, 24)], second=False)
    _serve_both(ckpt, man, tmp_path)
