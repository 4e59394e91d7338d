"""The port's fit loop, checkpoints and profiling hooks on the CPU, against
the JAX package where it has a counterpart.

``fit`` against JAX's ``fit``: the deterministic tiny model (filters
4/8/12/16/24, SE reduction 2, the bench cfg1 strides, 4x16x16x3, dropout 0,
parameters redrawn by numpy; tests/test_torch_util.py), no augmentation,
one fixed cycle of two batches of 2, Keras amsgrad on CALR (1e-3; 2, 1,
1e-3), 3 epochs x 2 steps, validation (PCaDetectionValidation) every epoch
on 2 cases, weights saved every epoch. JAX's fit runs once for the module.

Tolerances: the history's loss, seg_loss and lr at rtol 1e-5 (the metric
tolerance of tests/test_torch_train.py); the validation metrics at atol
1e-6 (each is a mean over two cases of counts, ranks and thresholded
masks: equal unless a probability lies within rounding of a threshold);
the saved weights under tests/test_torch_optim.py's three-step rules
scaled to the npz's step count n: every element within 2 n lr, and leaves
whose step-1 gradient is more than rounding noise (>= 1e-3 in fp64) within
n lr / 100 on average.

Checkpoints: the port's keep and interval rules against orbax's
``CheckpointManager`` on the same saves; restore, a crash before the
rename, and a resumed fit against an uninterrupted one (bit for bit).
"""

import itertools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prostatemr_3d_cad_cspca_tpu.models import M1 as JM1
from prostatemr_3d_cad_cspca_tpu.train import trainer as jt
from prostatemr_3d_cad_cspca_tpu.train import validation as jv
from prostatemr_3d_cad_cspca_tpu_torch.bridge import from_jax_params
from prostatemr_3d_cad_cspca_tpu_torch.models import M1 as TM1
from prostatemr_3d_cad_cspca_tpu_torch.train import checkpoint as tc
from prostatemr_3d_cad_cspca_tpu_torch.train import trainer as tt
from prostatemr_3d_cad_cspca_tpu_torch.train import validation as tv
from prostatemr_3d_cad_cspca_tpu_torch.utils import profiling
from test_torch_util import SPATIAL, jax_model, port_model, port_step_grads, to_np
from test_torch_util import one_torch_thread  # noqa: F401  (autouse)

KW = dict(input_channels=3, dropout_rate=0.0,
          strides=((1, 1, 1), (1, 2, 2), (1, 2, 2), (2, 2, 2), (2, 2, 2)))
EPOCHS, STEPS, LR = 3, 2, 1e-3
CALR = (2.0, 1.0, 1e-3)
METRIC_RTOL, VAL_ATOL = 1e-5, 1e-6


def labelled(seed, batch=2):
    """Images with a brighter lesion block and its one-hot label."""
    rng = np.random.default_rng(seed)
    lab = np.zeros((batch, *SPATIAL), np.int64)
    lab[:, 1:3, 4:10, 4:10] = 1
    lab[:, 2, 12:14, 2:5] = rng.integers(0, 2, (batch, 2, 3))
    det = np.eye(2, dtype=np.float32)[lab]
    img = rng.normal(size=(batch, *SPATIAL, 3)).astype(np.float32)
    img[..., 0] += 1.5 * det[..., 1]
    return {"image": img, "detection": det}


BATCHES = [labelled(10 + i) for i in range(STEPS)]
# two validation cases, one with a lesion and one without (a defined AUROC)
VALID = [{"image": labelled(30)["image"][0], "detection": labelled(30)["detection"][0]},
         {"image": np.random.default_rng(31).normal(size=(*SPATIAL, 3)).astype(np.float32),
          "detection": np.eye(2, dtype=np.float32)[np.zeros(SPATIAL, np.int64)]}]


class Cycle:
    """A fixed cycle of batches; ``iter`` restarts it, as JAX's fit expects
    of a re-entered ``x``."""

    def __init__(self, batches):
        self.batches = batches

    def __iter__(self):
        return itertools.cycle(self.batches)


def fit_kwargs(weights_dir, schedule):
    return dict(epochs=EPOCHS, steps_per_epoch=STEPS, weights_dir=str(weights_dir),
                weights_min_epoch=1, store_weights_per_n_epochs=1, validate_per_n_epochs=1,
                validate_min_epoch=1, schedule=schedule, verbose=0)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """JAX's fit once: (model before training, history, weights dir)."""
    jm = jax_model(3, input_spatial_dims=SPATIAL, **KW)
    start = jax.tree_util.tree_map(lambda a: jnp.array(a, copy=True), jm.params)
    run = jax_model(3, input_spatial_dims=SPATIAL, **KW)
    run.params = jax.tree_util.tree_map(lambda a: jnp.array(a, copy=True), start)
    sched = jt.build_schedule("CALR", LR, STEPS, EPOCHS, CALR)
    wdir = tmp_path_factory.mktemp("jax_fit")
    history = jt.fit(run, Cycle(BATCHES), optimizer=jt.make_optimizer("adam", sched),
                     validate_fn=jv.PCaDetectionValidation(run.get_detect_model(), VALID),
                     **fit_kwargs(wdir, sched))
    return jm, history, wdir


def port_fit(jm, wdir, **kw):
    pm = port_model(jm)
    sched = tt.build_schedule("CALR", LR, STEPS, EPOCHS, CALR)
    validate = tv.PCaDetectionValidation(pm.get_detect_model(), VALID, device="cpu")
    history = tt.fit(pm, Cycle(BATCHES), optimizer=tt.make_optimizer("adam", sched),
                     **{**fit_kwargs(wdir, sched), "validate_fn": validate, **kw})
    return pm, history


def test_fit_matches_jax_fit(jax_run, tmp_path):
    jm, jhist, jdir = jax_run
    pm, phist = port_fit(jm, tmp_path)
    for key in ("loss", "seg_loss", "lr"):
        np.testing.assert_allclose(phist[key], jhist[key], rtol=METRIC_RTOL, err_msg=key)
    assert len(phist["loss"]) == EPOCHS and phist["loss"][-1] < phist["loss"][0]
    assert [v["epoch"] for v in phist["val"]] == [v["epoch"] for v in jhist["val"]] == [1, 2, 3]
    for got, want in zip(phist["val"], jhist["val"]):
        assert set(got) == set(want)
        assert all(np.isfinite(v) for v in want.values()), want
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=VAL_ATOL, err_msg=k)
    # the saved weights: epoch 1 is not saved (epoch != 0), epochs 2 and 3 are
    assert sorted(os.listdir(tmp_path)) == sorted(os.listdir(jdir)) == [
        "model_weights_002.npz", "model_weights_003.npz"]
    exact, _ = port_step_grads(port_model(jm, dtype="float64"), BATCHES[0], {})
    noise = {k for k, g in exact.items() if np.abs(g).max() < 1e-3}
    for epoch in (2, 3):
        n = epoch * STEPS
        name = f"model_weights_{epoch:03d}.npz"
        got = {k: to_np(v) for k, v in TM1.load(str(tmp_path / name), device="cpu").params.items()}
        want = {k: v.numpy() for k, v in from_jax_params(
            JM1.load(str(jdir / name)).params).items()}
        assert set(got) == set(want)
        for k in want:
            diff = np.abs(got[k] - want[k])
            assert diff.max() <= 2 * n * LR, (name, k, diff.max())
            assert k in noise or diff.mean() <= n * LR * 1e-2, (name, k, diff.mean())
    assert pm.opt_state["count"] == EPOCHS * STEPS


def test_port_weights_load_in_jax_and_jax_weights_resume_in_the_port(jax_run, tmp_path):
    """An npz of the port's WeightsSaver loads in JAX's ``M1.load`` with equal
    parameters and config; the port's ``resume_training`` on JAX's fold
    directory returns JAX's last epoch and its weights."""
    jm, _, jdir = jax_run
    pm, _ = port_fit(jm, tmp_path, epochs=2, validate_fn=None)
    loaded = JM1.load(str(tmp_path / "model_weights_002.npz"))
    assert loaded.config == jm.config
    got = from_jax_params(loaded.params)
    assert set(got) == set(pm.params)
    for k, v in pm.params.items():
        assert torch.equal(got[k], v), k
    model, epoch = tt.resume_training(port_model(jm), str(jdir))
    assert epoch == EPOCHS and model.device == torch.device("cpu")
    want = from_jax_params(JM1.load(str(jdir / "model_weights_003.npz")).params)
    for k, v in model.params.items():
        assert torch.equal(v, want[k]), k


@pytest.mark.parametrize("max_to_keep,interval", [(3, 1), (3, 2), (2, 3), (None, 2)])
def test_checkpoint_keep_and_interval_rules_match_orbax(max_to_keep, interval, tmp_path):
    import orbax.checkpoint as ocp

    def orbax_manager():
        return ocp.CheckpointManager(
            str(tmp_path / "orbax"), options=ocp.CheckpointManagerOptions(
                max_to_keep=max_to_keep, save_interval_steps=interval,
                enable_async_checkpointing=True))

    def port_manager():
        return tc.CheckpointManager(str(tmp_path / "port"), max_to_keep=max_to_keep,
                                    save_interval_steps=interval)

    state = tt.init_train_state(TM1(input_spatial_dims=SPATIAL, **KW, num_classes=2,
                                    filters=(4, 8, 12, 16, 24), se_reduction=(2,) * 5,
                                    summary=False, device="cpu"),
                                tt.make_optimizer("adam", LR))
    payload = {"x": np.zeros(3, np.float32)}
    om, pm = orbax_manager(), port_manager()
    for i, step in enumerate([1, 2, 3, 4, 5, 6, 7, 3, 9, 10, 12]):
        if i == 6:  # a new manager of each over the same directory
            om.wait_until_finished()
            om.close()
            pm.close()
            om, pm = orbax_manager(), port_manager()
        saved = om.save(step, args=ocp.args.StandardSave(payload))
        assert pm.save(step, state) == saved, step
        om.wait_until_finished()
        pm.wait()
        assert pm.all_steps() == list(om.all_steps()), step
        assert pm.latest_step() == om.latest_step(), step
    om.close()
    on_disk = sorted(int(f[:-3]) for f in os.listdir(tmp_path / "port") if f.endswith(".pt"))
    assert on_disk == pm.all_steps()


def two_steps(model):
    """A train state after two amsgrad steps (count 2, moments non-zero)."""
    opt = tt.make_optimizer("adam", LR)
    state, step = tt.init_train_state(model, opt), tt.make_train_step(model, tt.make_loss(), opt)
    for b in BATCHES:
        state, _ = step(state, b, None)
    return state


def assert_state_equal(got, want):
    assert set(got.params) == set(want.params)
    for k in want.params:
        assert torch.equal(got.params[k], want.params[k]), k
    assert got.step == want.step
    assert got.opt_state["count"] == want.opt_state["count"]
    for moment in ("mu", "nu", "nu_hat"):
        for k, v in want.opt_state[moment].items():
            assert torch.equal(got.opt_state[moment][k], v), (moment, k)


def test_checkpoint_restore_and_a_crash_before_the_rename(tmp_path, monkeypatch):
    jm = jax_model(5, input_spatial_dims=SPATIAL, **KW)
    state = two_steps(port_model(jm))
    mgr = tc.CheckpointManager(str(tmp_path), max_to_keep=3)
    assert mgr.save(1, state, config=jm.config)
    mgr.wait()
    assert tc.CheckpointManager.load_config(str(tmp_path)) == json.loads(
        json.dumps(jm.config, default=str))
    fresh = tt.init_train_state(port_model(jax_model(6, input_spatial_dims=SPATIAL, **KW)),
                                tt.make_optimizer("adam", LR))
    restored, step = tc.CheckpointManager(str(tmp_path)).restore(fresh)
    assert step == 1 and restored.module is fresh.module
    assert_state_equal(restored, state)

    # a crash between the temporary file and the rename: step 2 never lands
    later = two_steps(port_model(jm))
    later.step = 7

    def crash(src, dst):
        raise OSError("crashed before the rename")

    monkeypatch.setattr(tc.os, "replace", crash)
    assert mgr.save(2, later)
    with pytest.raises(OSError, match="before the rename"):
        mgr.wait()
    monkeypatch.undo()
    assert mgr.latest_step() == 1
    assert sorted(os.listdir(tmp_path)) == ["1.pt", "2.pt.tmp", "model_config.json"]
    again = tc.CheckpointManager(str(tmp_path))
    assert again.all_steps() == [1]
    restored, step = again.restore(fresh)
    assert step == 1
    assert_state_equal(restored, state)


def test_resumed_fit_equals_an_uninterrupted_fit(tmp_path):
    """fit to 2 epochs, then a resumed fit to 4 from the full-state
    checkpoint, against one fit to 4: the same parameters and optimizer
    state, bit for bit (the batch cycle's length divides steps_per_epoch,
    since each fit entry restarts ``iter(x)``)."""
    jm = jax_model(7, input_spatial_dims=SPATIAL, **KW)
    sched = tt.build_schedule("CALR", LR, STEPS, 4, CALR)

    def run(model, epochs, ckpt_dir):
        mgr = tc.CheckpointManager(str(ckpt_dir), max_to_keep=3)
        hist = tt.fit(model, Cycle(BATCHES), epochs=epochs, steps_per_epoch=STEPS,
                      optimizer=tt.make_optimizer("adam", sched), schedule=sched,
                      checkpoint_manager=mgr, verbose=0)
        mgr.close()
        return hist

    whole = port_model(jm)
    run(whole, 4, tmp_path / "whole")
    first = port_model(jm)
    assert len(run(first, 2, tmp_path / "split")["loss"]) == 2
    resumed = port_model(jax_model(8, input_spatial_dims=SPATIAL, **KW))
    hist = run(resumed, 4, tmp_path / "split")
    assert len(hist["loss"]) == 2
    assert tc.CheckpointManager(str(tmp_path / "split")).latest_step() == 4
    assert_state_equal(tt.TrainState(resumed.net, resumed.opt_state, 0),
                       tt.TrainState(whole.net, whole.opt_state, 0))
    assert resumed.opt_state["count"] == 4 * STEPS


def test_fit_with_scan_steps_and_the_keras_surface():
    """``scan_steps`` runs the same steps as single steps (the deterministic
    model draws nothing); a scan that does not divide the epoch raises; a
    one-position mesh runs the same steps, and a mesh of two positions in
    one process raises (it runs one process a position:
    tests/test_torch_parallel_train.py); ``M1.fit`` needs ``compile`` first
    and runs the compiled recipe."""
    jm = jax_model(9, input_spatial_dims=SPATIAL, **KW)
    kw = dict(epochs=2, steps_per_epoch=STEPS, verbose=0)
    plain, scanned = port_model(jm), port_model(jm)
    h1 = tt.fit(plain, Cycle(BATCHES), optimizer=tt.make_optimizer("adam", LR), **kw)
    h2 = tt.fit(scanned, Cycle(BATCHES), optimizer=tt.make_optimizer("adam", LR),
                scan_steps=2, **kw)
    assert h1["loss"] == h2["loss"]
    for k, v in plain.params.items():
        assert torch.equal(v, scanned.params[k]), k
    with pytest.raises(ValueError, match="must divide"):
        tt.fit(plain, Cycle(BATCHES), steps_per_epoch=3, scan_steps=2)
    from prostatemr_3d_cad_cspca_tpu_torch.parallel.mesh import make_mesh

    meshed = port_model(jm)
    h3 = tt.fit(meshed, Cycle(BATCHES), optimizer=tt.make_optimizer("adam", LR),
                mesh=make_mesh(n_data=1, devices=["cpu"]), **kw)
    assert h3["loss"] == h1["loss"]
    for k, v in plain.params.items():
        assert torch.equal(v, meshed.params[k]), k
    with pytest.raises(ValueError, match="one process a position"):
        tt.fit(plain, Cycle(BATCHES), mesh=make_mesh(n_data=2, devices=["cpu", "cpu"]))
    keras = port_model(jm)
    with pytest.raises(AssertionError, match="compile"):
        keras.fit(Cycle(BATCHES))
    keras.compile(optimizer=tt.make_optimizer("adam", LR), loss="distribution_focal",
                  loss_weights=[1.0])
    hist = keras.fit(Cycle(BATCHES), **kw)
    assert hist["loss"] == h1["loss"]


def test_profiling_hooks(tmp_path, capsys):
    """``trace`` writes a Chrome trace that holds ``annotate``'s range;
    ``StepTimer`` skips its warm-up steps; ``MetricsLogger`` appends one
    JSON object a line and echoes it."""
    with profiling.trace(str(tmp_path / "trace")):
        with profiling.annotate("fit-epoch"):
            torch.ones(8).sum()
    (trace,) = os.listdir(tmp_path / "trace")
    with open(tmp_path / "trace" / trace) as f:
        assert "fit-epoch" in f.read()
    timer = profiling.StepTimer(skip_first=2)
    assert timer.stats() == {"steps": 0}
    for _ in range(5):
        with timer:
            pass
    stats = timer.stats()
    assert stats["steps"] == 3 and stats["min_s"] <= stats["p50_s"] <= stats["max_s"]
    log = profiling.MetricsLogger(str(tmp_path / "m" / "metrics.jsonl"))
    log.log("epoch", epoch=1, loss=np.float32(0.5))
    log.log("validation", epoch=1, dice=0.25)
    lines = [json.loads(x) for x in open(tmp_path / "m" / "metrics.jsonl")]
    assert [r["event"] for r in lines] == ["epoch", "validation"]
    assert lines[0]["loss"] == 0.5 and "time" in lines[0]
    assert capsys.readouterr().out.count("\n") == 2
