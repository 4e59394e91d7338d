"""The port's training CLI (``prostatemr_3d_cad_cspca_tpu_torch.cli``) on
the CPU, against the JAX package's ``cli.py``: the parser flag for flag,
the verify recipe's 2-epoch lesion drive (its tiny model, 8 cases of
8x32x32x3) whose weights load in JAX's ``M1.load`` with the config JAX's
CLI builds, the completed-fold skip, the target-folder and class-count
exceptions, a resume from the full-state checkpoints, a warm start with
frozen layers, the boundary loss on the cached pipeline EDT, and the
zonal task through validation and the metrics files (as
tests/test_cli.py drives JAX's CLI).
"""

import csv
import json
import os

import numpy as np
import pytest
import torch

from prostatemr_3d_cad_cspca_tpu import cli as jcli
from prostatemr_3d_cad_cspca_tpu.models import M1 as JM1
from prostatemr_3d_cad_cspca_tpu_torch import cli
from prostatemr_3d_cad_cspca_tpu_torch.bridge import from_jax_params
from prostatemr_3d_cad_cspca_tpu_torch.train.checkpoint import CheckpointManager
from prostatemr_3d_cad_cspca_tpu_torch.train.trainer import module_path
from test_torch_util import one_torch_thread  # noqa: F401  (autouse)

TINY = ["--UNET_FEATURE_CHANNELS", "4", "8", "12", "16", "24",
        "--UNET_SE_REDUCTION", "2", "2", "2", "2", "2", "--BATCH_SIZE", "2"]


def write_dataset(root, n=8, spatial=(8, 32, 32), zonal=False):
    """The verify recipe's synthetic cases and fold-1 manifests."""
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(0)
    rows = []
    for i in range(n):
        img = rng.normal(size=(*spatial, 1 if zonal else 3)).astype(np.float32)
        lab = np.zeros(spatial, np.float32)
        lab[spatial[0] // 2 - 1:spatial[0] // 2 + 1, 4:spatial[1] // 2, 4:spatial[2] // 2] = 2.0
        zones = (lab > 0).astype(np.uint8)
        if zonal:
            zones[1:3, -8:-4, -8:-4] = 2
        paths = [os.path.join(root, f"case{i}_{k}.npy") for k in ("image", "label", "zones")]
        for p, a in zip(paths, (img, lab, zones)):
            np.save(p, a)
        rows.append({"p-id": f"case{i}", "image_path": paths[0], "label_path": paths[1],
                     "zones_path": paths[2]})
    for name in ("train-fold-1.csv", "valid-fold-1.csv"):
        with open(os.path.join(root, name), "w", newline="") as fh:
            w = csv.DictWriter(fh, fieldnames=list(rows[0]))
            w.writeheader()
            w.writerows(rows)


def drive_args(tmp, name="run1", epochs=2, *extra):
    return ["--TRAIN_OBJ", "lesion", "--NUM_EPOCHS", str(epochs), "--FOLDS", "0",
            "--TRAIN_XLSX_PREFIX", os.path.join(tmp, "ds", "train-fold-"),
            "--VALID_XLSX_PREFIX", os.path.join(tmp, "ds", "valid-fold-"),
            "--WEIGHTS_DIR", os.path.join(tmp, "w") + "/", "--NAME", name,
            "--METRICS_DIR", os.path.join(tmp, "m"), *TINY,
            "--WEIGHTS_MIN_EPOCH", "1", "--STORE_WEIGHTS_PER_N_EPOCHS", "1",
            "--DEVICE", "cpu", *extra]


def _actions(parser):
    return {a.dest: (a.default, a.nargs, a.type, a.choices) for a in parser._actions
            if a.dest != "help"}


def test_parser_has_every_jax_flag_with_its_default_plus_device():
    port, jax_ = _actions(cli.build_parser()), _actions(jcli.build_parser())
    assert set(port) == set(jax_) | {"DEVICE"}
    for dest, want in jax_.items():
        assert port[dest] == want, dest
    assert port["DEVICE"][0] == "cuda"
    assert cli._parse_tuples("(1,1,1), (1,2,2)") == jcli._parse_tuples("(1,1,1), (1,2,2)")
    default = cli.build_parser().get_default("AUGM_PARAMS")
    assert cli._parse_augm(default) == jcli._parse_augm(default)


@pytest.fixture(scope="module")
def drive(tmp_path_factory):
    """The verify recipe's 2-epoch drive with the port's CLI on the CPU."""
    tmp = str(tmp_path_factory.mktemp("cli"))
    write_dataset(os.path.join(tmp, "ds"))
    cli.main(drive_args(tmp))
    return tmp


def test_drive_trains_and_its_weights_load_in_jax(drive):
    fold = os.path.join(drive, "w", "run1", "F1")
    with open(os.path.join(drive, "m", "run1", "F1", "history.json")) as f:
        history = json.load(f)
    assert len(history["loss"]) == 2 and history["loss"][1] < history["loss"][0]
    assert sorted(os.listdir(fold)) == ["checkpoints", "model_weights_002.npz"]
    assert CheckpointManager(os.path.join(fold, "checkpoints")).all_steps() == [1, 2]
    jm = JM1.load(os.path.join(fold, "model_weights_002.npz"))
    want = JM1(  # the model JAX's CLI builds for these flags (cli.py:204-223)
        input_spatial_dims=(8, 32, 32), input_channels=3, num_classes=2,
        filters=(4, 8, 12, 16, 24), dropout_rate=0.5,
        strides=jcli._parse_tuples("(1,1,1),(1,2,2),(1,2,2),(2,2,2),(2,2,2)"),
        kernel_sizes=jcli._parse_tuples("(1,3,3),(1,3,3),(3,3,3),(3,3,3),(3,3,3)"),
        dropout_mode="monte-carlo", se_reduction=(2, 2, 2, 2, 2),
        att_sub_samp=jcli._parse_tuples("(1,1,1),(1,1,1),(1,1,1),(1,1,1)"),
        probabilistic=False, prob_latent_dims=(3, 2, 1, 0), dense_skip=False,
        deep_supervision=False, summary=False, kernel_regularizer=1e-5,
        bias_regularizer=1e-5, dtype=None, init_params=False)
    assert jm.config == want.config
    probs = np.asarray(jm.predict(np.load(os.path.join(drive, "ds", "case0_image.npy"))[None]))
    assert probs.shape == (1, 8, 32, 32, 2)
    np.testing.assert_allclose(probs.sum(-1), 1.0, atol=1e-4)


def test_useful_probes_and_resume(drive, capsys):
    """Re-running the drive skips the completed fold; --NUM_EPOCHS 3 raises
    the target-folder exception after the model is built; three focal
    weights for two classes raise the class-count exception;
    --RESUME_TRAIN 1 --NUM_EPOCHS 3 restores epoch 2 and trains one epoch,
    saying that a JAX orbax directory is not read."""
    fold = os.path.join(drive, "w", "run1", "F1")
    before = {f: os.path.getmtime(os.path.join(fold, f)) for f in os.listdir(fold)}
    assert cli.main(drive_args(drive)) is None
    assert {f: os.path.getmtime(os.path.join(fold, f)) for f in os.listdir(fold)} == before
    with pytest.raises(Exception, match="Target Folder Already Exists"):
        cli.main(drive_args(drive, "run1", 3))
    with pytest.raises(Exception, match="Number of Class Weights"):
        cli.main(drive_args(drive, "run1", 3, "--FOCAL_LOSS_ALPHA", "1", "1", "1"))
    os.makedirs(os.path.join(fold, "orbax"))
    capsys.readouterr()
    cli.main(drive_args(drive, "run1", 3, "--RESUME_TRAIN", "1"))
    out = capsys.readouterr().out
    assert "Resume Training @ Epoch 2" in out and "Restored checkpoint @ epoch 2" in out
    assert "orbax checkpoints, which the port does not read" in out
    with open(os.path.join(drive, "m", "run1", "F1", "history.json")) as f:
        assert len(json.load(f)["loss"]) == 1
    assert CheckpointManager(os.path.join(fold, "checkpoints")).all_steps() == [1, 2, 3]
    assert os.path.isfile(os.path.join(fold, "model_weights_003.npz"))


def test_warm_start_with_frozen_layers(drive):
    """--USE_PRETRAINED_WEIGHTS loads the drive's weights into the new
    model, and --FREEZE_LAYERS 3 keeps the first three module paths at
    them while the rest train."""
    src = os.path.join(drive, "w", "run1", "F1", "model_weights_002.npz")
    cli.main(drive_args(drive, "warm", 2, "--USE_PRETRAINED_WEIGHTS", src,
                        "--FREEZE_LAYERS", "3", "--ORBAX_CHECKPOINTS", "0"))
    fold = os.path.join(drive, "w", "warm", "F1")
    assert sorted(os.listdir(fold)) == ["model_weights_002.npz"]
    start = from_jax_params(JM1.load(src).params)
    end = from_jax_params(JM1.load(os.path.join(fold, "model_weights_002.npz")).params)
    frozen = sorted({module_path(k) for k in start})[:3]
    for k in start:
        assert torch.equal(start[k], end[k]) == (module_path(k) in frozen), k


def test_zonal_task_writes_its_metrics(tmp_path):
    tmp = str(tmp_path)
    write_dataset(os.path.join(tmp, "ds"), n=4, spatial=(4, 16, 16), zonal=True)
    args = drive_args(tmp, "zrun", 2, "--VALIDATE_MIN_EPOCH", "1",
                      "--VALIDATE_PER_N_EPOCHS", "1", "--FOCAL_LOSS_ALPHA", "1", "1", "1")
    args[1] = "zonal"
    cli.main(args)
    mdir = os.path.join(tmp, "m", "zrun", "F1")
    recs = [json.loads(line) for line in open(os.path.join(mdir, "metrics.jsonl"))]
    assert [r["epoch"] for r in recs if r["event"] == "epoch"] == [1, 2]
    vals = [r for r in recs if r["event"] == "validation"]
    assert [r["epoch"] for r in vals] == [1, 2]
    assert set(vals[0]) >= {"dice_TZ", "dice_PZ", "dice_mean"}
    with open(os.path.join(mdir, "history.json")) as f:
        history = json.load(f)
    assert len(history["loss"]) == 2 and len(history["val"]) == 2
    model = JM1.load(os.path.join(tmp, "w", "zrun", "F1", "model_weights_002.npz"))
    assert model.num_classes == 3 and model.input_channels == 1


def test_boundary_loss_trains_on_the_cached_pipeline_dist_map(tmp_path):
    """--LOSS_MODE region_boundary trains against the data layer's signed
    EDT (``with_dist_map``), and --CACHE_TDS_PATH keeps each prepared
    sample (with its EDT) under the generator's file names."""
    tmp = str(tmp_path)
    write_dataset(os.path.join(tmp, "ds"), n=4, spatial=(4, 16, 16))
    cache = os.path.join(tmp, "cache")
    cli.main(drive_args(tmp, "bd", 2, "--LOSS_MODE", "region_boundary",
                        "--CACHE_TDS_PATH", cache, "--ORBAX_CHECKPOINTS", "0"))
    with open(os.path.join(tmp, "m", "bd", "F1", "history.json")) as f:
        losses = json.load(f)["loss"]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert sorted(os.listdir(cache)) == [f"case{i}.lesion-d-train-edt.npz" for i in range(4)]
    with np.load(os.path.join(cache, "case0.lesion-d-train-edt.npz")) as z:
        assert z["dist_map"].shape == (4, 16, 16, 1)


def test_several_cards_wait_for_the_multi_gpu_slice(tmp_path):
    """--DEVICE cpu --GPU_DEVICE_IDs 0,1 trains on two spawned gloo workers
    (JAX's two forced host devices), each its row of every batch of 2 and
    of its draws: 3 epochs of the section-2 drive with SGD at lr 1e-5 give
    the one-device CLI's losses (rtol 1e-5) and weights (relative L2 1e-5
    of the run's update); only rank 0 writes. SGD, where an update follows
    its gradient: Adam moves every element by about lr whatever its
    gradient's size, so elements whose gradient is 0 but for rounding (the
    conv biases ahead of an instance norm) take noise-signed steps and the
    runs drift apart by rounding alone. Both warm-start from a 2-epoch run:
    at the reference's init every IN and SE bias is 0, so the SE squeeze's
    LReLU input is 0 but for rounding and so is the side of its kink."""
    from test_torch_dist_util import run_cli

    tmp = str(tmp_path)
    write_dataset(os.path.join(tmp, "ds"))
    cli.main(drive_args(tmp, "warm", 2))
    warm = ["--USE_PRETRAINED_WEIGHTS",
            os.path.join(tmp, "w", "warm", "F1", "model_weights_002.npz")]
    sgd = (*warm, "--OPTIMIZER", "momentum", "--BASE_LR", "1e-5")
    cli.main(drive_args(tmp, "one", 3, *sgd))
    out = run_cli(drive_args(tmp, "two", 3, "--GPU_DEVICE_IDs", "0,1", *sgd))
    assert out.count("Model Weights Saved") == 2  # epochs 2 and 3, rank 0 alone
    hist = {}
    for name in ("one", "two"):
        with open(os.path.join(tmp, "m", name, "F1", "history.json")) as f:
            hist[name] = json.load(f)["loss"]
    np.testing.assert_allclose(hist["two"], hist["one"], rtol=1e-5)

    def weights(name, epoch):
        return np.load(os.path.join(tmp, "w", name, "F1", f"model_weights_{epoch:03d}.npz"))

    start = np.load(warm[1])
    one, two = weights("one", 3), weights("two", 3)
    diff = sum(float(np.sum((two[k] - one[k]) ** 2)) for k in one.files)
    norm = sum(float(np.sum((one[k] - start[k]) ** 2)) for k in one.files)
    assert norm > 0 and (diff / norm) ** 0.5 <= 1e-5, (diff / norm) ** 0.5
