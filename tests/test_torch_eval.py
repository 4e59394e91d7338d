"""The port's evaluation layer against the JAX package's, on the CPU: the
metrics (Dice, lesion FROC, AP, patient AUROC), ``load_sample`` in every
mode for both tasks, the contour smoothening's numpy path against cv2, and
``evaluate.run``'s metrics JSON against JAX's ``evaluate.run`` key for key.

Host-side numpy functions are copies, so they are held exactly (or at
1e-12). ``evaluate.run`` runs tiny checkpoints (the verify skill's model:
filters 4/8/12/16/24, SE reduction 2, 8x32x32) with inactive dropout on a
synthetic labelled manifest of 4 cases, two with a lesion (so the AUROC is
defined); the port's probabilities lie within ~1e-6 of JAX's, and the
metrics, which threshold them, within 1e-6 key for key.
"""

import json
import os

import numpy as np
import pytest

from prostatemr_3d_cad_cspca_tpu import evaluate as jeval
from prostatemr_3d_cad_cspca_tpu.data import generators as jgen
from prostatemr_3d_cad_cspca_tpu.train import metrics as jmet
from prostatemr_3d_cad_cspca_tpu_torch import evaluate as teval
from prostatemr_3d_cad_cspca_tpu_torch.data import generators as tgen
from prostatemr_3d_cad_cspca_tpu_torch.train import metrics as tmet
from test_torch_util import jax_model
from test_torch_util import one_torch_thread  # noqa: F401  (autouse)

SPATIAL8 = (8, 32, 32)
EVAL_KW = dict(input_spatial_dims=SPATIAL8,
               strides=((1, 1, 1), (1, 2, 2), (1, 2, 2), (2, 2, 2), (2, 2, 2)))


def _maps(seed, n=5):
    rng = np.random.default_rng(seed)
    probs, labels = [], []
    for i in range(n):
        p = rng.random((6, 20, 20)) ** 3
        lab = np.zeros((6, 20, 20), np.float32)
        if i % 2 == 0:
            lab[2:4, 5:10, 5:10] = 1
            p[2:4, 6:10, 5:9] += 0.5
        if i == 4:
            lab[1:3, 12:16, 12:16] = 1
        probs.append(np.clip(p, 0, 1).astype(np.float32))
        labels.append(lab)
    return probs, labels


def test_metrics_equal_jax():
    probs, labels = _maps(0)
    for p, lab in zip(probs, labels):
        assert tmet.dice_3d((p >= 0.5).astype(np.float32), lab) == jmet.dice_3d(
            (p >= 0.5).astype(np.float32), lab)
    for thr in (0.1, 0.4):
        got, want = tmet.froc_curve(probs, labels, threshold=thr), jmet.froc_curve(
            probs, labels, threshold=thr)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert tmet.lesion_average_precision(probs, labels, threshold=thr) == \
            jmet.lesion_average_precision(probs, labels, threshold=thr)
    targets = [int(lab.max() > 0.5) for lab in labels]
    assert tmet.patient_auroc(probs, targets) == jmet.patient_auroc(probs, targets)
    assert np.isnan(tmet.patient_auroc(probs, [1] * len(probs)))
    assert len(tmet.extract_lesion_candidates(probs[0])) == len(
        jmet.extract_lesion_candidates(probs[0]))


def _write_case(root, i, rng, lesion=True, shape=SPATIAL8, channels=3):
    img = rng.normal(size=(*shape, channels)).astype(np.float32)
    lab = np.zeros(shape, np.float32)
    zones = np.zeros(shape, np.uint8)
    zones[1:7, 6:26, 6:26] = 1
    zones[2:6, 10:20, 8:24] = 2
    if lesion:
        lab[3:5, 10:20, 10:20] = 3.0
        lab[3:5, 12:14, 12:14] = 1.0  # GGG 1: below csPCa
    paths = {k: os.path.join(root, f"case{i}_{k}.npy") for k in ("image", "label", "zones")}
    np.save(paths["image"], img)
    np.save(paths["label"], lab)
    np.save(paths["zones"], zones)
    return {"p-id": f"case{i}", "image_path": paths["image"], "label_path": paths["label"],
            "zones_path": paths["zones"]}


@pytest.mark.parametrize("train_obj", ["lesion", "zonal"])
@pytest.mark.parametrize("mode", ["train", "valid", "test"])
@pytest.mark.parametrize("probabilistic", [False, True])
def test_load_sample_equals_jax(tmp_path, train_obj, mode, probabilistic):
    row = _write_case(str(tmp_path), 0, np.random.default_rng(1))
    kw = dict(train_obj=train_obj, probabilistic=probabilistic, mode=mode, with_dist_map=True)
    got, want = tgen.load_sample(row, **kw), jgen.load_sample(row, **kw)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_contour_smoothening_numpy_path_is_within_one_of_cv2():
    pytest.importorskip("cv2")
    from prostatemr_3d_cad_cspca_tpu_torch.utils import native

    rng = np.random.default_rng(2)
    label = (rng.random((4, 40, 48)) < 0.3).astype(np.uint8)
    label[:, 10:30, 10:30] = 1
    ref = tgen.contour_smoothening(label)  # cv2, here
    np.testing.assert_array_equal(ref, jgen.contour_smoothening(label))
    by_numpy = np.stack([tgen._smooth_numpy(sl, 7) for sl in label]).astype(np.uint8)
    assert np.abs(by_numpy.astype(int) - ref.astype(int)).max() <= 1
    by_native = native.contour_smooth(label, 7)
    if by_native is not None:  # g++ present: the native path too
        assert np.abs(by_native.astype(int) - ref.astype(int)).max() <= 1


def _manifest(root, rows, name="valid.csv", second=None):
    cols = ["p-id", "image_path", "label_path", "zones_path"] + (
        ["image_path_2"] if second else [])
    path = os.path.join(root, name)
    with open(path, "w") as f:
        f.write(",".join(cols) + "\n")
        for i, r in enumerate(rows):
            vals = [r[c] for c in cols[:4]] + ([second[i]] if second else [])
            f.write(",".join(vals) + "\n")
    return path


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("evalds"))
    rng = np.random.default_rng(3)
    rows = [_write_case(root, i, rng, lesion=i in (0, 2)) for i in range(4)]
    seconds = []
    for i in range(4):
        seconds.append(os.path.join(root, f"case{i}_image2.npy"))
        np.save(seconds[-1], rng.normal(size=(*SPATIAL8, 3)).astype(np.float32))
    return root, rows, seconds


def _ckpt(root, name, seed, **kw):
    path = os.path.join(root, f"{name}.npz")
    if not os.path.exists(path):
        jax_model(seed, **EVAL_KW, **kw).save(path)
    return path


def _both(argv):
    want = jeval.main(argv)
    got = teval.main(argv + ["--DEVICE", "cpu"])
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        assert (g is None) == (w is None), k
        if w is not None:
            assert abs(g - w) <= 1e-6, (k, g, w)
    return got


@pytest.mark.parametrize("case", ["lesion", "lesion_tta", "zonal", "ensemble"])
def test_evaluate_run_equals_jax(dataset, case, tmp_path):
    root, rows, _ = dataset
    man = _manifest(root, rows)
    if case == "zonal":
        model = _ckpt(root, "zonal", 5, input_channels=1, num_classes=3)
    elif case == "ensemble":
        model = ",".join(_ckpt(root, f"fold{i}", 6 + i, input_channels=3, num_classes=2)
                         for i in range(2))
    else:
        model = _ckpt(root, "lesion", 4, input_channels=3, num_classes=2)
    out = str(tmp_path / "metrics.json")
    argv = ["--MODEL", model, "--MANIFEST", man, "--OUTPUT", out,
            "--TRAIN_OBJ", "zonal" if case == "zonal" else "lesion",
            "--TTA", "1" if case == "lesion_tta" else "0"]
    got = _both(argv)
    with open(out) as f:
        assert json.load(f) == got  # the port wrote the last file
    assert got["cases"] == 4
    if case != "zonal":
        assert got["auroc"] is not None and 0.0 <= got["auroc"] <= 1.0
    else:
        assert set(got) == {"dice_TZ", "dice_PZ", "dice_mean", "cases"}


@pytest.mark.parametrize("with_second", [False, True])
def test_evaluate_run_cascade_equals_jax(dataset, with_second):
    root, rows, seconds = dataset
    man = _manifest(root, rows, f"cascade{int(with_second)}.csv",
                    second=seconds if with_second else None)
    model = _ckpt(root, "cascade", 8, input_channels=3, num_classes=2, cascaded="noisy-or")
    _both(["--MODEL", model, "--MANIFEST", man])


def test_evaluate_mc_checkpoint_repeats_per_seed(dataset):
    root, rows, _ = dataset
    man = _manifest(root, rows)
    model = _ckpt(root, "mc", 9, input_channels=3, num_classes=2,
                  dropout_mode="monte-carlo", dropout_rate=0.5)
    argv = ["--MODEL", model, "--MANIFEST", man, "--PROBA_ITER", "3", "--DEVICE", "cpu"]
    a = teval.main(argv + ["--SEED", "1"])
    assert a == teval.main(argv + ["--SEED", "1"])
    assert set(a) == {"auroc", "froc_pauc", "lesion_ap", "dice", "cases"}


def test_evaluate_refuses_to_fall_back_without_a_card(dataset):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    root, rows, _ = dataset
    with pytest.raises(RuntimeError, match="no CUDA device"):
        teval.main(["--MODEL", _ckpt(root, "lesion", 4, input_channels=3, num_classes=2),
                    "--MANIFEST", _manifest(root, rows)])
