"""The port's SE bottleneck and attention gate against the JAX package's
flax blocks, with the flax parameters bridged into the torch modules
(bridge.from_jax_params), at the repo's fp32 oracle tolerance atol 2e-5.

Parameters are redrawn by numpy after the flax init, so every weight (IN
scale and bias included) differs from its initializer's constant and the
mapping of each one is exercised.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prostatemr_3d_cad_cspca_tpu.models import blocks as jblocks
from prostatemr_3d_cad_cspca_tpu_torch.bridge import from_jax_params, to_jax_params
from prostatemr_3d_cad_cspca_tpu_torch.models import blocks as tblocks
from test_torch_util import one_torch_thread  # noqa: F401  (autouse)

ATOL = 2e-5


def _redraw(params, seed):
    """Same tree, every leaf redrawn: kernels ~ N(0, 1/fan_in), IN scales
    near 1, biases small."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return jnp.asarray(rng.normal(0, fan_in ** -0.5, shape), jnp.float32)
        if name == "scale":
            return jnp.asarray(1 + 0.3 * rng.normal(size=shape), jnp.float32)
        return jnp.asarray(0.3 * rng.normal(size=shape), jnp.float32)

    return jax.tree_util.tree_map_with_path(draw, params)


def _load(module, params):
    module.load_state_dict(from_jax_params(params))
    return module


@pytest.mark.parametrize("case", ["projection", "identity", "parts"])
def test_se_bottleneck_matches_flax(case):
    rng = np.random.default_rng(0)
    spatial = (3, 8, 6)
    if case == "projection":  # channel count changes: conv4 + norm4 shortcut
        widths, filters, ks, st = (6,), 8, (1, 3, 3), (1, 2, 2)
    elif case == "identity":  # same width: the input is the shortcut
        widths, filters, ks, st = (8,), 8, (3, 3, 3), (1, 1, 1)
    else:  # decoder stitch: a part list standing for its concat
        widths, filters, ks, st = (4, 4), 8, (3, 3, 3), (1, 1, 1)
    parts = [rng.normal(size=(2, *spatial, c)).astype(np.float32) for c in widths]
    jmod = jblocks.SEResNetBottleNeck(filters=filters, kernel_size=ks, strides=st,
                                      reduction=2)
    jin = [jnp.asarray(p) for p in parts]
    jin = jin[0] if len(jin) == 1 else jin
    params = _redraw(jmod.init(jax.random.PRNGKey(0), jin)["params"], 1)
    want = np.asarray(jmod.apply({"params": params}, jin))

    tmod = _load(tblocks.SEResNetBottleNeck(sum(widths), filters, ks, st, 2), params)
    assert (tmod.conv4 is None) == (case != "projection")
    tin = [torch.from_numpy(p) for p in parts]
    with torch.no_grad():
        got = tmod(tin[0] if len(tin) == 1 else tin).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_se_bottleneck_params_round_trip_to_flax_keys():
    jmod = jblocks.SEResNetBottleNeck(filters=8, kernel_size=(1, 3, 3),
                                      strides=(1, 2, 2), reduction=2)
    params = jmod.init(jax.random.PRNGKey(0), jnp.zeros((1, 2, 4, 4, 6)))["params"]
    tmod = _load(tblocks.SEResNetBottleNeck(6, 8, (1, 3, 3), (1, 2, 2), 2), params)
    back = to_jax_params(tmod)
    flat = {"/".join(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    assert sorted(back) == sorted(flat)
    for key in flat:
        np.testing.assert_array_equal(back[key], flat[key])


@pytest.mark.parametrize("sub_samp", [(1, 1, 1), (1, 2, 2)])
def test_attention_gate_matches_flax(sub_samp):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 4, 8, 8, 6)).astype(np.float32)
    g = rng.normal(size=(2, 1, 2, 2, 10)).astype(np.float32)
    jmod = jblocks.GridAttentionBlock3D(inter_channels=6, sub_samp=sub_samp)
    params = _redraw(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x),
                               jnp.asarray(g))["params"], 3)
    want_y, want_att = jmod.apply({"params": params}, jnp.asarray(x), jnp.asarray(g))

    tmod = _load(tblocks.GridAttentionBlock3D(6, 10, 6, sub_samp), params)
    with torch.no_grad():
        got_y, got_att = tmod(torch.from_numpy(x), torch.from_numpy(g))
    np.testing.assert_allclose(got_att.numpy(), np.asarray(want_att), atol=ATOL)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), atol=ATOL)


def test_dropout_is_identity_when_deterministic_and_raises_otherwise():
    """Inactive dropout is the identity; active dropout without an rng
    raises, as flax's does without a 'dropout' stream."""
    x = torch.ones(2, 3)
    assert tblocks.ConfigurableDropout(0.0, "monte-carlo")(x) is x
    assert tblocks.ConfigurableDropout(0.5, "standard")(x, train=False) is x
    with pytest.raises(ValueError, match="needs rng"):
        tblocks.ConfigurableDropout(0.5, "monte-carlo")(x)
    with pytest.raises(ValueError, match="needs rng"):
        tblocks.ConfigurableDropout(0.5, "standard")(x, train=True)
    with pytest.raises(ValueError, match="needs rng"):
        tblocks.MonteCarloDropout(0.5)(x)
    gen = torch.Generator().manual_seed(0)
    y = tblocks.ConfigurableDropout(0.5, "monte-carlo", "s")(x, rng=gen)
    assert set(y.unique().tolist()) <= {0.0, 2.0}


def test_leaky_relu_slope():
    x = torch.tensor([-2.0, 0.0, 3.0])
    np.testing.assert_array_equal(tblocks.leaky_relu01(x).numpy(),
                                  np.float32([-0.2, 0.0, 3.0]))
