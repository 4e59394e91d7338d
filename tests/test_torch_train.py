"""The port's train step against the JAX package's ``make_train_step``, on
the CPU: the deterministic M1 (dropout rate 0) and the CLI's Monte-Carlo
dropout at 0.5 with JAX's keep-masks replayed into the port
(tests/test_torch_util.py ``record_train_draws``). The probabilistic and
cascaded models are in tests/test_torch_train_kinds.py.

The tiny model (filters 4/8/12/16/24, SE reduction 2, the bench cfg1
strides) at 8x32x32x3, batch 2, focal loss (alpha 1, 1; gamma 2), L2 1e-4.
JAX's step runs jitted with an optax transformation that keeps the
gradients as its state, so the gradients are those of JAX's own step.

The fp64 evaluation replays the fp32 step's branch decisions at every kink
(LReLU, the instance norm's fused LReLU, the focal clip;
tests/test_torch_util.py ``BranchReplay``): where an input lies within
rounding of a kink the two would otherwise take different slopes.

Tolerances. The focal loss sums 16,384 voxels to about 2.9e3, so its fp32
value moves by ~1e-6 relative with the summation order alone: metrics are
held at rtol 1e-5. Gradients are held to the port's own step evaluated in
fp64 (its plain twins take fp64), with the per-leaf error max|diff| /
max(1, max|exact|): the port's fp32 step within 1e-4, JAX's fp32 step
within 5e-3. JAX's own fp32 rounding is the larger (up to 3.1e-3 on the
conv biases ahead of an instance norm, whose exact gradient is 0; the
port's 2e-5), so the JAX bound states its error and the fp64 evaluation
ties the two. The fp64 evaluation still takes the loss in fp32 (the focal
loss casts its input, as the reference's does), so leaves whose exact
gradient is 0 (those biases, and parameters the loss does not reach, such
as the posterior's logits) read up to ~1e-4 there: leaves below 1e-3 are
held at 5e-3 in both fp32 steps, the rounding noise of an fp32 loss of
~3e3.
"""

import jax
import numpy as np
import pytest

from prostatemr_3d_cad_cspca_tpu.augment import AugmentParams as JAugmentParams
from test_torch_util import (BranchReplay, jax_model, jax_step_grads, leaf_errors,
                             port_model, port_step_grads, record_train_draws)
from test_torch_util import one_torch_thread  # noqa: F401  (autouse)

SPATIAL8 = (8, 32, 32)
KW = dict(input_spatial_dims=SPATIAL8, input_channels=3,
          strides=((1, 1, 1), (1, 2, 2), (1, 2, 2), (2, 2, 2), (2, 2, 2)))
KINDS = {"deterministic": dict(dropout_rate=0.0),
         "mc": dict(dropout_mode="monte-carlo", dropout_rate=0.5)}
PORT_TOL, JAX_TOL, METRIC_RTOL = 1e-4, 5e-3, 1e-5
# the CLI's --AUGM_PARAMS default as its parser gives it (JAX cli.py:90-91, :104-107)
CLI_AUGMENT = [1.0, 0.25, 0.15, 10.0, True, 1.2, 0.1, 0.025, True, (0.5, 1.5)]
ZERO_GRAD = 1e-3  # below: a gradient that is 0 but for the fp32 loss's rounding


def labelled_batch(seed, channels=3, batch=2, spatial=SPATIAL8):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch, *spatial, channels)).astype(np.float32)
    lesion = (rng.random((batch, *spatial)) < 0.2).astype(np.float32)
    return {"image": x, "detection": np.stack([1 - lesion, lesion], -1)}


def check_step(jm, batch, key, **kw):
    """One step in JAX, in the port (fp32) and in the port at fp64 on the
    same parameters, batch and draws (with ``augment_params``, the
    augmentation's too), the fp64 step taking the port's fp32 branch
    decisions (``BranchReplay``); returns the three results."""
    augment = None
    if kw.get("augment_params") is not None:
        augment = (JAugmentParams.from_list(kw["augment_params"]),
                   kw.get("train_obj", "lesion"), batch)
    draws = record_train_draws(jm, batch["image"], key, augment)
    jg, jmet = jax_step_grads(jm, batch, key, **kw)
    branches = BranchReplay()
    with branches.record():
        pg, pmet = port_step_grads(port_model(jm), batch, draws, **kw)
    with branches.replay():
        eg, _ = port_step_grads(port_model(jm, dtype="float64"), batch, draws, **kw)
    assert set(pg) == set(jg) == set(eg)
    assert set(pmet) == set(jmet)
    for k in jmet:
        np.testing.assert_allclose(pmet[k], jmet[k], rtol=METRIC_RTOL, err_msg=k)
    port_err, jax_err = leaf_errors(pg, eg), leaf_errors(jg, eg)
    zero = {k for k, v in eg.items() if np.abs(v).max() <= ZERO_GRAD}
    for k, e in port_err.items():
        assert e <= (JAX_TOL if k in zero else PORT_TOL), (k, e, float(np.abs(eg[k]).max()))
    worst = max(jax_err, key=jax_err.get)
    assert jax_err[worst] <= JAX_TOL, (worst, jax_err[worst])
    return draws, (jg, jmet), (pg, pmet)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_train_step_matches_jax(kind):
    jm = jax_model(0, **KW, **KINDS[kind])
    draws, (_, jmet), _ = check_step(jm, labelled_batch(1), jax.random.PRNGKey(1))
    assert sorted(jmet) == ["loss", "reg", "seg_loss"]
    if kind == "mc":  # every site's mask was replayed, and is live
        assert sorted(draws) == ["dropd0", "dropd1", "dropd2", "dropd3",
                                 "drope1", "drope2", "drope3", "drope4"]
        assert all(0.3 < m.mean() < 0.9 for m in draws.values())
    else:
        assert draws == {}


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_augmented_train_step_matches_jax(kind):
    """The step of test_train_step_matches_jax (the same model, batch and
    key) with the CLI's default augmentation: JAX's draws (its
    ``split(rng)`` then a key a sample) replayed into the port's step
    beside the forward's keep-masks, held as the unaugmented step is."""
    jm = jax_model(0, **KW, **KINDS[kind])
    draws, _, _ = check_step(jm, labelled_batch(1), jax.random.PRNGKey(1),
                             augment_params=CLI_AUGMENT, train_obj="lesion")
    assert draws["augment/noise"].shape == (2, *SPATIAL8, 3)
    assert (draws["augment/master"] > 0).all()  # prob 1: every sample augmented
    assert any((draws[f"augment/{g}_on"] > 0.25).any() for g in ("zoom", "rot", "trans"))
    assert len([k for k in draws if not k.startswith("augment/")]) == (8 if kind == "mc" else 0)


def test_augmented_boundary_loss_step_warps_the_dist_map_with_its_label():
    """The region/boundary loss with the batch's dist_map: the step warps
    the map with the label, as JAX's does."""
    from prostatemr_3d_cad_cspca_tpu.ops.edt import signed_distance_map
    from prostatemr_3d_cad_cspca_tpu.train import trainer as jt
    from prostatemr_3d_cad_cspca_tpu_torch.train import trainer as tt

    jm = jax_model(6, **KW, **KINDS["deterministic"])
    batch = labelled_batch(10)
    batch["dist_map"] = signed_distance_map(batch["detection"][..., 1:])
    key, aug = jax.random.PRNGKey(7), dict(augment_params=CLI_AUGMENT, train_obj="lesion")
    draws = record_train_draws(jm, batch["image"], key,
                               (JAugmentParams.from_list(CLI_AUGMENT), "lesion", batch))
    jg, jmet = jax_step_grads(jm, batch, key, loss=jt.make_loss("region_boundary"), **aug)
    pg, pmet = port_step_grads(port_model(jm), batch, draws,
                               loss=tt.make_loss("region_boundary"), **aug)
    for k in jmet:
        np.testing.assert_allclose(pmet[k], jmet[k], rtol=METRIC_RTOL, err_msg=k)
    err = leaf_errors(pg, jg)
    worst = max(err, key=err.get)
    assert err[worst] <= JAX_TOL, (worst, err[worst])


def test_boundary_loss_step_matches_jax_with_and_without_dist_map():
    """The region/boundary loss: with the batch's precomputed dist_map and
    with the host EDT inside the loss, the same step."""
    from prostatemr_3d_cad_cspca_tpu.ops.edt import signed_distance_map
    from prostatemr_3d_cad_cspca_tpu.train import trainer as jt
    from prostatemr_3d_cad_cspca_tpu_torch.train import trainer as tt

    jm = jax_model(1, **KW, **KINDS["deterministic"])
    batch = labelled_batch(2)
    key = jax.random.PRNGKey(2)
    jg, jmet = jax_step_grads(jm, batch, key, loss=jt.make_loss("region_boundary"))
    with_map = dict(batch, dist_map=signed_distance_map(batch["detection"][..., 1:]))
    for b in (batch, with_map):
        pg, pmet = port_step_grads(port_model(jm), b, {}, loss=tt.make_loss("region_boundary"))
        for k in jmet:
            np.testing.assert_allclose(pmet[k], jmet[k], rtol=METRIC_RTOL, err_msg=k)
        err = leaf_errors(pg, jg)
        worst = max(err, key=err.get)
        assert err[worst] <= JAX_TOL, (worst, err[worst])
