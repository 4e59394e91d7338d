"""The port's losses, optimizers, schedules, L2 term and multi-step train
programs against the JAX package's, on the CPU.

Losses: value and gradient with respect to y_pred (JAX's by jax.grad,
the port's by autograd), fp32 rtol 1e-5 (voxel sums of 4-8K terms in other
orders). Keras amsgrad against the numpy oracle of
tests/test_optimizer_oracle.py (copied, not imported) at its own
tolerance; SGD-Nesterov against optax (rtol 1e-6). Schedules in fp32 at
rtol 1e-6. Multi-step programs: ``accum_steps`` on identical microbatches
and ``scan_steps`` against sequential steps, bit for bit (the same
operations in the same order). Three Keras-amsgrad steps against JAX's
(see the test's note on the tolerance).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from prostatemr_3d_cad_cspca_tpu import losses as jl
from prostatemr_3d_cad_cspca_tpu.ops.convolution import l2_penalty as jl2
from prostatemr_3d_cad_cspca_tpu.train import schedules as js
from prostatemr_3d_cad_cspca_tpu.train import trainer as jt
from prostatemr_3d_cad_cspca_tpu_torch import losses as tl
from prostatemr_3d_cad_cspca_tpu_torch.bridge import from_jax_params
from prostatemr_3d_cad_cspca_tpu_torch.ops.convolution import l2_penalty as tl2
from prostatemr_3d_cad_cspca_tpu_torch.train import schedules as ts
from prostatemr_3d_cad_cspca_tpu_torch.train import trainer as tt
from test_torch_train import CLI_AUGMENT, KW, labelled_batch
from test_torch_util import (CaptureOpt, jax_model, leaf_errors, port_model, port_step_grads,
                             to_np)
from test_torch_util import one_torch_thread  # noqa: F401  (autouse)

LOSS_RTOL = 1e-5


def _pred(seed, groups=1, nc=2, shape=(2, 4, 8, 8)):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(*shape, groups * nc)) * 3
    p = np.concatenate([np.exp(l) / np.exp(l).sum(-1, keepdims=True)
                        for l in np.split(logits, groups, -1)], -1)
    lesion = (rng.random(shape) < 0.3).astype(np.float32)
    return p.astype(np.float32), np.stack([1 - lesion, lesion], -1)


def _value_and_grad(jfn, tfn, y_true, y_pred, **kw):
    jv, jg = jax.value_and_grad(lambda p: jfn(jnp.asarray(y_true), p, **kw))(jnp.asarray(y_pred))
    p = torch.from_numpy(y_pred).requires_grad_()
    tv = tfn(torch.from_numpy(y_true), p, **{k: torch.from_numpy(np.asarray(v))
                                              for k, v in kw.items()})
    (tg,) = torch.autograd.grad(tv, p)
    return (float(jv), np.asarray(jg)), (float(tv), tg.numpy())


@pytest.mark.parametrize("groups", [1, 4])
@pytest.mark.parametrize("alpha,gamma", [((1.0, 1.0), 2.0), ((0.25, 0.75), 0.0)])
def test_focal_loss_and_its_gradient_match_jax(groups, alpha, gamma):
    y_pred, y_true = _pred(groups, groups)
    y_pred[0, 0, 0, 0, :2] = [1.0, 0.0]  # both clip bounds, each at a tie
    (jv, jg), (tv, tg) = _value_and_grad(jl.Focal(alpha, gamma).loss,
                                         tl.Focal(alpha, gamma).loss, y_true, y_pred)
    np.testing.assert_allclose(tv, jv, rtol=LOSS_RTOL)
    np.testing.assert_allclose(tg, jg, rtol=LOSS_RTOL, atol=1e-6)
    sums = tl.Focal(alpha, gamma).per_sample_sums(torch.from_numpy(y_true),
                                                  torch.from_numpy(y_pred[..., :2]))
    np.testing.assert_allclose(sums.numpy(), np.asarray(jl.Focal(alpha, gamma).per_sample_sums(
        jnp.asarray(y_true), jnp.asarray(y_pred[..., :2]))), rtol=LOSS_RTOL)


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("with_map", [False, True])
def test_dice_boundary_loss_and_its_gradient_match_jax(groups, with_map):
    from prostatemr_3d_cad_cspca_tpu.ops.edt import signed_distance_map

    y_pred, y_true = _pred(10 + groups, groups)
    kw = {"dist_map": signed_distance_map(y_true[..., 1:])} if with_map else {}
    (jv, jg), (tv, tg) = _value_and_grad(jl.SoftDicePlusBoundarySurface((0.5, 0.5)).loss,
                                         tl.SoftDicePlusBoundarySurface((0.5, 0.5)).loss,
                                         y_true, y_pred, **kw)
    np.testing.assert_allclose(tv, jv, rtol=LOSS_RTOL)
    np.testing.assert_allclose(tg, jg, rtol=LOSS_RTOL, atol=1e-6)


def test_evidence_lower_bound_matches_jax():
    kl = np.random.default_rng(3).random((2, 3)).astype(np.float32)
    want = jl.EvidenceLowerBound(10.0)(None, jnp.asarray(kl))
    np.testing.assert_allclose(float(tl.EvidenceLowerBound(10.0)(None, torch.from_numpy(kl))),
                               float(want), rtol=1e-6)


def _numpy_keras_amsgrad(w0, grads, lr, b1=0.9, b2=0.999, eps=1e-7):
    """The oracle of tests/test_optimizer_oracle.py (keras optimizer_v2/adam.py
    with amsgrad=True, transcribed in numpy), copied."""
    w = w0.astype(np.float64).copy()
    m = np.zeros_like(w)
    v = np.zeros_like(w)
    vhat = np.zeros_like(w)
    traj = []
    for t, g in enumerate(grads, start=1):
        g = g.astype(np.float64)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        vhat = np.maximum(vhat, v)
        lr_t = lr * np.sqrt(1 - b2**t) / (1 - b1**t)
        w = w - lr_t * m / (np.sqrt(vhat) + eps)
        traj.append(w.copy())
    return traj


def _run_port(opt, w0, grads):
    p = torch.from_numpy(w0.copy())
    state, traj = opt.init({"w": p}), []
    for g in grads:
        up, state = opt.update({"w": torch.from_numpy(g)}, state, {"w": p})
        p = p + up["w"]
        traj.append(p.numpy().copy())
    return traj


def test_keras_amsgrad_matches_the_numpy_oracle():
    rng = np.random.default_rng(0)
    w0 = rng.normal(size=(32,)).astype(np.float32)
    grads = [rng.normal(size=(32,)).astype(np.float32) * 0.1 for _ in range(40)]
    oracle = _numpy_keras_amsgrad(w0, grads, lr=1e-3)
    for t, got in enumerate(_run_port(tt.make_optimizer("adam", 1e-3), w0, grads)):
        np.testing.assert_allclose(got, oracle[t], rtol=2e-5, atol=1e-7, err_msg=f"step {t + 1}")


def test_keras_amsgrad_with_a_schedule_matches_jax():
    """The learning rate reads the update count, as optax's
    scale_by_learning_rate does: the port's steps equal JAX's."""
    rng = np.random.default_rng(1)
    w0 = rng.normal(size=(64,)).astype(np.float32)
    grads = [rng.normal(size=(64,)).astype(np.float32) for _ in range(6)]
    jsched = js.cosine_decay_restarts(1e-2, 3, 2.0, 1.0, 1e-3)
    tx, p = jt.make_optimizer("adam", jsched), jnp.asarray(w0)
    st, want = tx.init(p), []
    for g in grads:
        up, st = tx.update(jnp.asarray(g), st, p)
        p = optax.apply_updates(p, up)
        want.append(np.asarray(p))
    got = _run_port(tt.make_optimizer("adam", ts.cosine_decay_restarts(1e-2, 3, 2.0, 1.0, 1e-3)),
                    w0, grads)
    for t, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-8, err_msg=f"step {t + 1}")


def test_sgd_nesterov_matches_optax():
    rng = np.random.default_rng(2)
    w0 = rng.normal(size=(16,)).astype(np.float32)
    grads = [rng.normal(size=(16,)).astype(np.float32) for _ in range(8)]
    tx, p = jt.make_optimizer("sgd", 1e-2), jnp.asarray(w0)
    st = tx.init(p)
    got = _run_port(tt.make_optimizer("sgd", 1e-2), w0, grads)
    for t, g in enumerate(grads):
        up, st = tx.update(jnp.asarray(g), st, p)
        p = optax.apply_updates(p, up)
        np.testing.assert_allclose(got[t], np.asarray(p), rtol=1e-6, atol=1e-8)


def test_freeze_first_n_freezes_the_same_modules_as_jax():
    jm = jax_model(0, **KW, dropout_rate=0.0)
    grads = jax.tree_util.tree_map(jnp.ones_like, jm.params)
    tx = jt.make_optimizer("adam", 1e-3, freeze_first_n=3)
    up, _ = tx.update(grads, tx.init(jm.params), jm.params)
    frozen_jax = {k for k, v in from_jax_params(up).items() if not v.abs().max()}
    params = dict(port_model(jm).net.named_parameters())
    opt = tt.make_optimizer("adam", 1e-3, freeze_first_n=3)
    ups, _ = opt.update({k: torch.ones_like(p) for k, p in params.items()}, opt.init(params),
                        params)
    frozen_port = {k for k, v in ups.items() if not v.abs().max()}
    assert frozen_port == frozen_jax and frozen_port
    assert {tt.module_path(k) for k in frozen_port} == {"core/att0", "core/att1", "core/att2"}
    for n in (None, 0, 9999):  # the CLI's "freeze nothing" values
        assert isinstance(tt.make_optimizer("adam", freeze_first_n=n), tt.KerasAmsgrad)


def test_l2_penalty_matches_jax_and_skips_norms_and_se():
    jm = jax_model(1, **KW, dropout_rate=0.0)
    want = float(jl2(jm.params, 1e-4, 2e-4))
    net = port_model(jm).net
    np.testing.assert_allclose(float(tl2(net, 1e-4, 2e-4)), want, rtol=1e-6)
    np.testing.assert_allclose(float(tl2(dict(net.named_parameters()), 1e-4, 2e-4)), want,
                               rtol=1e-6)
    only = {k: v for k, v in net.named_parameters() if ".norm" in k or ".se_" in k}
    assert only and float(tl2(only, 1.0, 1.0)) == 0.0


STEPS = [0, 1, 2, 5, 17, 63, 64, 250, 1000, 4999, 12345]


@pytest.mark.parametrize("name,jfn,tfn", [
    ("calr", js.cosine_decay_restarts(1e-3, 100, 2.0, 1.0, 1e-3),
     ts.cosine_decay_restarts(1e-3, 100, 2.0, 1.0, 1e-3)),
    ("calr_t1", js.cosine_decay_restarts(1e-3, 64, 1.0, 0.5, 0.0),
     ts.cosine_decay_restarts(1e-3, 64, 1.0, 0.5, 0.0)),
    ("clr_tri", js.cyclic_lr(1e-4, 1e-3, 40.0, "triangular"), ts.cyclic_lr(1e-4, 1e-3, 40.0, "triangular")),
    ("clr_tri2", js.cyclic_lr(1e-4, 1e-3, 40.0, "triangular2"),
     ts.cyclic_lr(1e-4, 1e-3, 40.0, "triangular2")),
    ("clr_exp", js.cyclic_lr(1e-4, 1e-3, 40.0, "exp_range", 0.999),
     ts.cyclic_lr(1e-4, 1e-3, 40.0, "exp_range", 0.999)),
    ("poly", js.poly_lr(1e-3, 0.9, 300, 50), ts.poly_lr(1e-3, 0.9, 300, 50)),
    ("piecewise", js.piecewise_epoch_lr([1e-3, 5e-4, 1e-4, 5e-5], [1, 20, 60, 200], 25),
     ts.piecewise_epoch_lr([1e-3, 5e-4, 1e-4, 5e-5], [1, 20, 60, 200], 25)),
    ("build_calr", jt.build_schedule("CALR", 1e-3, 10, 25), ts.build_schedule("CALR", 1e-3, 10, 25)),
    ("build_clr", jt.build_schedule("CLR", 1e-3, 10, 25), ts.build_schedule("CLR", 1e-3, 10, 25)),
    ("build_const", jt.build_schedule("none", 1e-3), ts.build_schedule("none", 1e-3)),
])
def test_schedule_matches_jax(name, jfn, tfn):
    for step in STEPS:
        np.testing.assert_allclose(float(tfn(step)), float(jfn(step)), rtol=1e-6, atol=1e-12,
                                   err_msg=f"{name} at step {step}")


def _stack(batches):
    return {k: np.stack([b[k] for b in batches]) for k in batches[0]}


def test_accum_steps_equals_one_step_on_identical_microbatches():
    """Two identical microbatches (with the same draws): their summed and
    halved gradients, and their averaged metrics, are the single step's
    bit for bit (x + x and its half are exact)."""
    jm = jax_model(2, **KW, dropout_mode="monte-carlo", dropout_rate=0.5)
    batch = labelled_batch(6)
    one, many = port_model(jm), port_model(jm)
    opt = tt.make_optimizer("adam", 1e-3)
    s1, m1 = tt.make_train_step(one, tt.make_loss(), opt)(tt.init_train_state(one, opt), batch, 4)
    acc = tt.make_train_step(many, tt.make_loss(), opt, accum_steps=2)
    s3, m3 = acc(tt.init_train_state(many, opt), _stack([batch] * 2), [4, 4])
    assert s1.step == s3.step == 1
    for k in m1:
        assert torch.equal(m1[k], m3[k]), k
    for (k, a), b in zip(one.net.named_parameters(), many.net.parameters()):
        assert torch.equal(a, b), k
    with pytest.raises(ValueError, match="mutually exclusive"):
        tt.make_train_step(one, tt.make_loss(), opt, accum_steps=2, scan_steps=2)


def test_scan_steps_equals_sequential_steps():
    jm = jax_model(3, **KW, dropout_mode="monte-carlo", dropout_rate=0.5)
    batches = [labelled_batch(7), labelled_batch(8)]
    a, b = port_model(jm), port_model(jm)
    opt = tt.make_optimizer("adam", 1e-3)
    step = tt.make_train_step(a, tt.make_loss(), opt)
    state, seq = tt.init_train_state(a, opt), []
    rngs = [torch.Generator().manual_seed(s) for s in (11, 12)]
    for bt, r in zip(batches, rngs):
        state, m = step(state, bt, r)
        seq.append(m)
    multi = tt.make_train_step(b, tt.make_loss(), opt, scan_steps=2)
    rngs = [torch.Generator().manual_seed(s) for s in (11, 12)]
    state2, stacked = multi(tt.init_train_state(b, opt), _stack(batches), rngs)
    assert state.step == state2.step == 2 and stacked["loss"].shape == (2,)
    for k in stacked:
        assert torch.equal(stacked[k], torch.stack([m[k] for m in seq])), k
    for (k, p), q in zip(a.net.named_parameters(), b.net.parameters()):
        assert torch.equal(p, q), k
    # a generator gives step i fold_in(rng, i): the same seed, the same run
    c, d = port_model(jm), port_model(jm)
    for mod in (c, d):
        tt.make_train_step(mod, tt.make_loss(), opt, scan_steps=2)(
            tt.init_train_state(mod, opt), _stack(batches), 5)
    for p, q in zip(c.net.parameters(), d.net.parameters()):
        assert torch.equal(p, q)


def test_multi_step_programs_augment_each_batch():
    """With ``augment_params`` the scan and accumulation programs augment
    each step's batch as the single step does (``fold_in`` of the step's
    rng): the same metrics, bit for bit, and not those of a step without
    augmentation."""
    jm = jax_model(3, **KW, dropout_rate=0.0)
    batches = [labelled_batch(7), labelled_batch(8)]
    aug = dict(augment_params=CLI_AUGMENT, train_obj="lesion")

    def rngs():
        return [torch.Generator().manual_seed(s) for s in (11, 12)]

    single = tt.make_train_step(port_model(jm), tt.make_loss(), CaptureOpt(), **aug)
    seq = [single(tt.init_train_state(port_model(jm), CaptureOpt()), bt, r)[1]
           for bt, r in zip(batches, rngs())]
    for kw in (dict(scan_steps=2), dict(accum_steps=2)):
        pm = port_model(jm)
        multi = tt.make_train_step(pm, tt.make_loss(), CaptureOpt(), **kw, **aug)
        _, got = multi(tt.init_train_state(pm, CaptureOpt()), _stack(batches), rngs())
        for k in got:
            want = torch.stack([m[k] for m in seq])
            assert torch.equal(got[k], want if "scan_steps" in kw else want.mean()), (kw, k)
    plain = tt.make_train_step(port_model(jm), tt.make_loss(), CaptureOpt())
    _, m = plain(tt.init_train_state(port_model(jm), CaptureOpt()), batches[0], rngs()[0])
    assert not torch.equal(m["loss"], seq[0]["loss"])


def test_augmentation_and_a_mesh_are_refused():
    """Augmenting a cascade's pair of exams raises (JAX's step fails there
    too); a single-stage model takes augmentation; a one-position mesh
    gives the step without one, bit for bit, and a mesh of two positions in
    one process is refused (one process a position:
    tests/test_torch_parallel_train.py)."""
    from prostatemr_3d_cad_cspca_tpu_torch.models import M1 as TM1

    cascade = TM1(**{**KW, "input_spatial_dims": (4, 16, 16)}, num_classes=2,
                  cascaded="noisy-or", summary=False, device="cpu")
    with pytest.raises(ValueError, match="cascade"):
        tt.make_train_step(cascade, tt.make_loss(), CaptureOpt(),
                           augment_params=[0.5] * 9 + [(0.5, 1.5)])
    pm = port_model(jax_model(0, **KW, dropout_rate=0.0))
    tt.make_train_step(pm, tt.make_loss(), CaptureOpt(), augment_params=[0.5] * 10)
    from prostatemr_3d_cad_cspca_tpu_torch.parallel.mesh import make_mesh

    batch = {"image": np.random.default_rng(2).normal(size=(2, *KW["input_spatial_dims"], 3))
             .astype(np.float32)}
    batch["detection"] = np.stack([np.ones(batch["image"].shape[:-1], np.float32),
                                   np.zeros(batch["image"].shape[:-1], np.float32)], -1)
    got = []
    for mesh in (None, make_mesh(n_data=1, devices=["cpu"])):
        m, opt = port_model(jax_model(0, **KW, dropout_rate=0.0)), CaptureOpt()
        state, met = tt.make_train_step(m, tt.make_loss(), opt, mesh=mesh)(
            tt.init_train_state(m, opt), batch, 0)
        got.append((state.opt_state, met))
    assert all(torch.equal(got[0][0][k], got[1][0][k]) for k in got[0][0])
    assert float(got[0][1]["loss"]) == float(got[1][1]["loss"])
    with pytest.raises(ValueError, match="one process a position"):
        tt.make_train_step(pm, tt.make_loss(), CaptureOpt(),
                           mesh=make_mesh(n_data=2, devices=["cpu", "cpu"]))


def test_three_amsgrad_steps_match_jax():
    """Three Keras-amsgrad steps (lr 1e-3) on the deterministic model, on
    three batches, against JAX's jitted steps. Adam moves a leaf by about lr
    whatever its gradient's size, so leaves whose gradient is 0 but for
    rounding (|step-1 fp64 gradient| < 1e-3: the conv biases ahead of an
    instance norm) move by noise, at most about lr a step each way: they
    are held by their gradients in tests/test_torch_train.py, and here
    only to 2 x 3 lr (two walks of three steps apart), as is every
    element. In the other leaves an element's update errs by its
    gradient's relative error: the gradients agree to ~5e-3 of their
    leaf's largest element (JAX's rounding), a larger share of the smaller
    elements, and where an LReLU input sits within rounding of 0 the two
    fp32 steps take different slopes for it. So each such leaf's MEAN
    |difference| is held at a hundredth of the three steps' travel (3 lr);
    a wrong moment or bias correction moves every element (optax's
    amsgrad differs by 2.6e-2 at step 2) and would exceed it."""
    lr = 1e-3
    jm = jax_model(4, **KW, dropout_rate=0.0)
    batches = [labelled_batch(20 + i) for i in range(3)]
    tx = jt.make_optimizer("adam", lr)
    step = jt.make_train_step(jm, jt.make_loss(), tx)
    params = jax.tree_util.tree_map(lambda a: jnp.array(a, copy=True), jm.params)
    state = jt.TrainState(params, tx.init(params), jnp.zeros((), jnp.int32))
    for i, bt in enumerate(batches):
        state, _ = step(state, bt, jax.random.PRNGKey(i))
    want = {k: v.numpy() for k, v in from_jax_params(jax.device_get(state.params)).items()}
    exact, _ = port_step_grads(port_model(jm, dtype="float64"), batches[0], {})
    pm = port_model(jm)
    opt = tt.make_optimizer("adam", lr)
    pstate, pstep = tt.init_train_state(pm, opt), tt.make_train_step(pm, tt.make_loss(), opt)
    for bt in batches:
        pstate, _ = pstep(pstate, bt, None)
    assert pstate.step == 3 and pstate.opt_state["count"] == 3
    got = {k: to_np(v) for k, v in pm.net.named_parameters()}
    noise = {k for k, g in exact.items() if np.abs(g).max() < 1e-3}
    for k in want:
        diff = np.abs(got[k] - want[k])
        assert diff.max() <= 6 * lr, (k, diff.max())
        assert k in noise or diff.mean() <= 3 * lr * 1e-2, (k, diff.mean())
    moved = leaf_errors(got, {k: to_np(v) for k, v in port_model(jm).net.named_parameters()})
    assert min(moved.values()) > 0  # every leaf moved
