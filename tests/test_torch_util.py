"""Helpers shared by the port's CPU tests of the cfg2, probabilistic and
cascaded M1 against the JAX package (tests/test_torch_{cfg2,prob,cascade}.py);
this module holds no test of its own.

The models are the JAX tests' tiny config: filters 4/8/12/16/24, SE
reduction 2, the bench cfg1 strides and kernels, a 4x16x16 volume
(tests/test_tf_prob_oracle.py:34-40). Flax parameters are redrawn by numpy so
every weight differs from its initializer's constant; the port loads them
through the bridge.

JAX draws its own latents, which the port cannot reproduce: ``record`` runs
an eager flax forward, records the latent each sampling ladder pass used
(``flax.linen.intercept_methods`` on ``M1Core.ladder``) and returns them as
the port's mapping of latents (paths as ``prng`` names them).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import linen as nn

from prostatemr_3d_cad_cspca_tpu.models import M1 as JM1
from prostatemr_3d_cad_cspca_tpu.models.m1_core import M1Core as JM1Core
from prostatemr_3d_cad_cspca_tpu_torch.bridge import from_jax_params
from prostatemr_3d_cad_cspca_tpu_torch.models import M1 as TM1
from port_support import BranchReplay  # noqa: F401  (the train tests' fp64 replays)
from test_torch_dist_util import one_torch_thread  # noqa: F401  (the files' autouse fixture)

ATOL = 2e-5  # fp32: the repo's oracle tolerance (tests/test_tf_parity.py:43)
SPATIAL = (4, 16, 16)
TINY = dict(input_spatial_dims=SPATIAL, num_classes=2, filters=(4, 8, 12, 16, 24),
            strides=((1, 1, 1), (1, 2, 2), (1, 2, 2), (2, 2, 2), (2, 2, 2)),
            kernel_sizes=((1, 3, 3), (1, 3, 3), (3, 3, 3), (3, 3, 3), (3, 3, 3)),
            se_reduction=(2, 2, 2, 2, 2), summary=False)
DIMS = (2, 1, 1, 0)


def redraw(params, seed):
    """Every leaf drawn by numpy: kernels N(0, 1/fan_in), IN scales
    1 + N(0, 0.3), biases N(0, 0.3)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return jnp.asarray(rng.normal(0, fan_in ** -0.5, shape), jnp.float32)
        if name == "scale":
            return jnp.asarray(1 + 0.3 * rng.normal(size=shape), jnp.float32)
        return jnp.asarray(0.3 * rng.normal(size=shape), jnp.float32)

    return jax.tree_util.tree_map_with_path(draw, params)


def jax_model(seed=0, **kw):
    """A JAX M1 with numpy-drawn parameters; the tree's shapes come from
    ``jax.eval_shape`` of the flax init, which traces but compiles nothing."""
    model = JM1(**{**TINY, **kw}, init_params=False)
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: model.net.init(
        {"params": key, "dropout": key, "latent": key}, model.example_inputs(),
        train=False)["params"])
    model.params = redraw(shapes, seed)
    return model


def port_model(jmodel, **overrides):
    """The port's M1 of ``jmodel``'s config on the CPU, with its parameters."""
    config = {**jmodel.config, "summary": False, **overrides}
    model = TM1(**config, device="cpu", init_params=False)
    model.params = from_jax_params(jmodel.params)
    return model


def inputs(seed, channels, batch=2, spatial=SPATIAL):
    return np.random.default_rng(seed).normal(size=(batch, *spatial, channels)).astype(
        np.float32)


def to_np(tree):
    if isinstance(tree, dict):
        return {k: to_np(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(to_np(v) for v in tree)
    if torch.is_tensor(tree):
        return tree.detach().to(torch.promote_types(tree.dtype, torch.float32)).numpy()
    return None if tree is None else np.asarray(tree, np.promote_types(
        np.asarray(tree).dtype, np.float32))


def _pass_name(module, kwargs):
    """The port's name of a JAX ladder call that samples (None otherwise)."""
    if kwargs.get("prob_mean") or kwargs.get("prob_z_q") is not None:
        return None
    return {"prior": "p_sample", "posterior": "q_sample"}[module.name]


def record(jmodel, x, seed=0):
    """An eager flax forward of ``jmodel.net`` with latent key ``seed``:
    (output, {latent path: latent}) where each sampling ladder call's
    latents sit under its scope path (``[stage/]<pass>/z_<level>``)."""
    latents = {}

    def interceptor(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if isinstance(context.module, JM1Core) and context.method_name == "ladder":
            name = _pass_name(context.module, kwargs)
            if name is not None:
                scope = "/".join((*context.module.path[:-1], name))
                for i, z in enumerate(out["prob_used_latents"]):
                    if z is not None:
                        latents[f"{scope}/z_{i}"] = np.array(z, np.float32)
        return out

    key = jax.random.PRNGKey(seed)
    x = tuple(jnp.asarray(t) for t in x) if isinstance(x, tuple) else jnp.asarray(x)
    with nn.intercept_methods(interceptor):
        out = jmodel.net.apply({"params": jmodel.params}, x, train=False,
                               rngs={"dropout": key, "latent": jax.random.fold_in(key, 1)})
    return out, latents


def assert_tree_close(got, want, atol=ATOL, path="", scaled=False):
    """Every leaf of ``got`` within ``atol`` of ``want``'s; with ``scaled``,
    within ``atol * max(1, |want|)`` (the kernels' limit form): atol itself
    wherever |want| <= 1, a relative bound above it."""
    if isinstance(want, dict):
        assert set(got) >= set(want), (path, set(want) - set(got))
        for k in want:
            assert_tree_close(got[k], want[k], atol, f"{path}/{k}", scaled)
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_tree_close(g, w, atol, f"{path}/{i}", scaled)
    elif want is None:
        assert got is None, path
    else:
        g, w = to_np(got), to_np(want)
        assert g.shape == w.shape, (path, g.shape, w.shape)
        if scaled:
            err = float((np.abs(g - w) / np.maximum(1.0, np.abs(w))).max())
            assert err <= atol, (path, err)
        else:
            np.testing.assert_allclose(g, w, atol=atol, err_msg=path)


# ----------------------------------------------------------- train steps
def capture_tx():
    """An optax transformation that moves nothing and keeps the gradients
    as its state: JAX's ``make_train_step`` with it returns the step's
    gradients in ``state.opt_state``."""
    import optax

    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))


class CaptureOpt:
    """The port's counterpart of :func:`capture_tx`."""

    def init(self, params):
        return None

    def update(self, grads, state, params):
        return {k: torch.zeros_like(g) for k, g in grads.items()}, grads


def record_train_draws(jmodel, x, key, augment=None):
    """The draws of the forward inside JAX's train step for ``key`` (its
    ``d, l = split(key)`` streams, train=True), as the port's mapping: each
    dropout site's keep-mask (out != 0 of an eager flax forward; the
    activations carry no exact zeros) and each sampling ladder pass's
    latents. Ladder dropout sites (which need the pass) are not handled.

    ``augment`` = (JAX ``AugmentParams``, train_obj, batch): the step
    augments first, with ``rng, a_rng = split(key)`` (JAX train/trainer.py:
    230) and a key a sample from ``split(a_rng, B)``; the forward's draws
    then come from ``rng`` on the augmented image, and the augmentation's
    (``jax_batch_draws`` of ``a_rng``) join the mapping under
    ``augment/``."""
    draws = {}
    if augment is not None:
        from prostatemr_3d_cad_cspca_tpu.augment import augment_sample

        params, train_obj, batch = augment
        key, a_key = jax.random.split(key)
        shape = np.shape(batch["image"])
        draws = {f"augment/{k}": v for k, v in
                 jax_batch_draws(a_key, params, shape, train_obj).items()}
        x = jax.vmap(lambda k, im, lb: augment_sample(k, im, lb, params, train_obj)[0])(
            jax.random.split(a_key, shape[0]), jnp.asarray(batch["image"]),
            jnp.asarray(batch["detection"]))

    def interceptor(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        mod = context.module
        if isinstance(mod, nn.Dropout) and context.method_name == "__call__":
            path = [p for p in mod.path if p != "core"][:-1]
            assert not path[-1].startswith("dropp"), "ladder dropout needs its pass"
            assert not (np.asarray(args[0]) == 0).any(), "an exact zero hides the mask"
            draws["/".join(path)] = np.asarray(out) != 0
        elif isinstance(mod, JM1Core) and context.method_name == "ladder":
            name = _pass_name(mod, kwargs)
            if name is not None:
                scope = "/".join((*mod.path[:-1], name))
                for i, z in enumerate(out["prob_used_latents"]):
                    if z is not None:
                        draws[f"{scope}/z_{i}"] = np.array(z, np.float32)
        return out

    d, l = jax.random.split(key)
    x = tuple(jnp.asarray(t) for t in x) if isinstance(x, tuple) else jnp.asarray(x)
    with nn.intercept_methods(interceptor):
        jmodel.net.apply({"params": jmodel.params}, x, train=True,
                         rngs={"dropout": d, "latent": l})
    return draws


def jax_step_grads(jmodel, batch, key, loss=None, **kw):
    """(gradients by port name, metrics) of one step of JAX's
    ``make_train_step`` on a copy of ``jmodel``'s parameters."""
    from prostatemr_3d_cad_cspca_tpu.train import trainer as jt

    tx = capture_tx()
    step = jt.make_train_step(jmodel, loss or jt.make_loss(), tx, **kw)
    params = jax.tree_util.tree_map(lambda a: jnp.array(a, copy=True), jmodel.params)
    state = jt.TrainState(params, tx.init(params), jnp.zeros((), jnp.int32))
    state, metrics = step(state, batch, key)
    grads = from_jax_params(jax.device_get(state.opt_state))
    return {k: v.numpy() for k, v in grads.items()}, {k: float(v) for k, v in metrics.items()}


def port_step_grads(pmodel, batch, draws, loss=None, **kw):
    """(gradients, metrics) of one step of the port's ``make_train_step``."""
    from prostatemr_3d_cad_cspca_tpu_torch.train import trainer as tt

    opt = CaptureOpt()
    step = tt.make_train_step(pmodel, loss or tt.make_loss(), opt, **kw)
    state, metrics = step(tt.init_train_state(pmodel, opt), batch, draws)
    return ({k: to_np(v) for k, v in state.opt_state.items()},
            {k: float(v) for k, v in metrics.items()})


def leaf_errors(got, want):
    """Per leaf: max |got - want| / max(1, max |want|)."""
    return {k: float(np.abs(np.asarray(got[k], np.float64) - want[k]).max()
                     / max(1.0, float(np.abs(want[k]).max()))) for k in want}


# ----------------------------------------------------------- augmentation
def jax_augment_draws(key, params, shape, train_obj="lesion"):
    """One sample's draws as the JAX package's ``augment_sample`` makes them
    for ``key`` (its ``split(key, 20)``, ``fold_in(key, 101)`` and
    ``fold_in(key, 202)`` streams, augment.py:185, :264, :276), under the
    port's replay names (``augment.DRAW_NAMES``): the gates as their
    uniforms, the rest as values. A draw of a disabled transform is made
    all the same (JAX skips it; the port's replay ignores it)."""
    import math

    p, (D, H, W, _) = params, shape
    n = 3 if train_obj == "lesion" else 1
    k = jax.random.split(key, 20)
    uni = lambda kk, lo=0.0, hi=1.0: np.float32(jax.random.uniform(kk, (), minval=lo, maxval=hi))  # noqa: E731
    rint = lambda kk, lo, hi: int(jax.random.randint(kk, (), lo, hi))  # noqa: E731
    mh, mw = math.ceil(H * p.translate_factor), math.ceil(W * p.translate_factor)
    ch, cw = math.ceil(H * p.chan_shift_factor), math.ceil(W * p.chan_shift_factor)
    gamma = tuple(p.gamma_correct) or (0.0, 0.0)
    ps, nz = jax.random.fold_in(key, 101), jax.random.fold_in(key, 202)
    return {
        "master": uni(k[0]), "zoom_on": uni(k[1]),
        "zoom_scale": np.int64(rint(k[2], H, int(math.ceil(H * p.zoom_factor)))),
        "flip_on": uni(k[3]), "rot_on": uni(k[4]),
        "rot_angle": uni(k[5], -p.rotation_degree, p.rotation_degree),
        "trans_on": uni(k[6]),
        "trans_pads": np.array([rint(k[7], 0, mh), rint(k[8], 0, mh), rint(k[9], 0, mw),
                                rint(k[10], 0, mw)], np.int64),
        "cs_on": uni(k[11]),
        "cs_pads": np.array([rint(k[12], 0, ch), rint(k[13], 0, ch), rint(k[14], 0, cw),
                             rint(k[15], 0, cw)], np.int64),
        "cs_channel": np.int64(rint(k[16], 0, 3)),
        "gamma_on": uni(k[17]), "gamma": uni(k[18], gamma[0], gamma[1]),
        "gamma_channel": np.array([uni(g) for g in jax.random.split(k[19], n)], np.float32),
        "poor_on": uni(jax.random.fold_in(ps, 0)),
        "poor_channel": np.array([uni(g) for g in jax.random.split(jax.random.fold_in(ps, 1), n)],
                                 np.float32),
        "noise_on": uni(jax.random.fold_in(nz, 0)),
        "noise_std": uni(jax.random.fold_in(nz, 1), 0.0, p.gauss_noise_stddev),
        "noise": np.array(jax.random.normal(jax.random.fold_in(nz, 2), (D, H, W, n)),
                          np.float32),
    }


def jax_batch_draws(key, params, shape, train_obj="lesion"):
    """The draws of ``augment_batch`` (and of the train step's augmentation
    key) for a batch of ``shape`` (B, D, H, W, C): each sample's under
    ``split(key, B)``, stacked on a leading batch axis."""
    per = [jax_augment_draws(k, params, shape[1:], train_obj)
           for k in jax.random.split(key, shape[0])]
    return {name: np.stack([d[name] for d in per]) for name in per[0]}
