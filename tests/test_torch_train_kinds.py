"""The port's train step against the JAX package's for the probabilistic M1
(ELBO beta 10, latents recorded from JAX's step forward and replayed) and
the two-stage cascade (both stages' losses), on the CPU. Dropout is 0 in
both, so the latents are the only draws. Model, batch and tolerances as in
tests/test_torch_train.py (metrics rtol 1e-5; gradients against the port's
fp64 evaluation: the port within 1e-4, JAX within 5e-3).
"""

import jax
import numpy as np

from test_torch_train import KW, check_step, labelled_batch
from test_torch_util import jax_model
from test_torch_util import one_torch_thread  # noqa: F401  (autouse)


def test_probabilistic_train_step_matches_jax():
    jm = jax_model(2, **{**KW, "input_channels": 4}, dropout_rate=0.0, probabilistic=True,
                   prob_latent_dims=(2, 1, 1, 0), deep_supervision=True)
    batch = labelled_batch(3, channels=3)
    batch["image"] = np.concatenate([batch["image"], batch["detection"][..., 1:]], -1)
    draws, (_, jmet), (_, pmet) = check_step(jm, batch, jax.random.PRNGKey(3), elbo_beta=10.0)
    assert sorted(draws) == ["p_sample/z_0", "p_sample/z_1", "p_sample/z_2",
                             "q_sample/z_0", "q_sample/z_1", "q_sample/z_2"]
    assert sorted(jmet) == ["kl", "loss", "reg", "seg_loss"] and pmet["kl"] > 0
    np.testing.assert_allclose(pmet["loss"], pmet["seg_loss"] + 10.0 * pmet["kl"] + pmet["reg"],
                               rtol=1e-6)


def test_cascaded_train_step_matches_jax():
    jm = jax_model(3, **KW, dropout_rate=0.0, cascaded="noisy-or")
    batch = labelled_batch(4)
    batch["image"] = (batch["image"], labelled_batch(5)["image"])
    draws, (_, jmet), _ = check_step(jm, batch, jax.random.PRNGKey(4))
    assert draws == {} and sorted(jmet) == ["loss", "reg", "seg_loss"]
