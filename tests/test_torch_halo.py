"""Halo-sharded execution of the port against the JAX package's, on the CPU
(one gloo world of 4 spawned ranks, tests/test_torch_dist_util.py, against
JAX's shard_map on 4 of its forced host devices):

  * ``halo_exchange`` one-hop (halo 2, slab 4) and multi-hop (halo 6 over
    slabs of 4), its output and its gradient;
  * ``spatial_infer_m1`` on JAX's model (4x320x16, ``n_spatial=4``) against
    JAX's sharded result and the unsharded forward (atol 1e-5,
    tests/test_infer_and_parallel.py:169-192);
  * the spatial train step's loss against JAX's sharded step and the
    unsharded loss (rtol 1e-5, tests/test_spatial_train.py:41-75);
  * the conv + IN + SE stack's gradients through every cross-rank coupling
    at JAX's rtol 2e-4 / atol 1e-4 (tests/test_spatial_train.py:78-133);
  * the spatial step's guards, with JAX's messages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax import shard_map
from jax.sharding import PartitionSpec as P

from prostatemr_3d_cad_cspca_tpu.losses import Focal as JFocal
from prostatemr_3d_cad_cspca_tpu.models import M1 as JM1
from prostatemr_3d_cad_cspca_tpu.ops.normalization import global_spatial_mean as jgsm
from prostatemr_3d_cad_cspca_tpu.ops.normalization import instance_norm as jin
from prostatemr_3d_cad_cspca_tpu.parallel import halo as jhalo
from prostatemr_3d_cad_cspca_tpu.parallel.mesh import make_mesh as jmake_mesh
from prostatemr_3d_cad_cspca_tpu_torch.bridge import from_jax_params
from prostatemr_3d_cad_cspca_tpu_torch.losses import Focal
from prostatemr_3d_cad_cspca_tpu_torch.models import M1 as TM1
from prostatemr_3d_cad_cspca_tpu_torch.parallel import halo as thalo
from prostatemr_3d_cad_cspca_tpu_torch.parallel.mesh import make_mesh
from prostatemr_3d_cad_cspca_tpu_torch.train.trainer import SGDNesterov
from test_torch_dist_util import run_world
from test_torch_util import one_torch_thread  # noqa: F401  (autouse)

N = 4
SPATIAL_KW = dict(  # JAX's whole-gland test model (tests/test_infer_and_parallel.py:173)
    input_spatial_dims=(4, 320, 16), input_channels=3, num_classes=2,
    filters=(4, 8, 12, 16, 24),
    strides=((1, 1, 1), (1, 2, 2), (1, 2, 2), (2, 2, 2), (1, 1, 1)),
    kernel_sizes=((1, 3, 3), (1, 3, 3), (3, 3, 3), (3, 3, 3), (3, 3, 3)),
    se_reduction=(2, 2, 2, 2, 2), att_sub_samp=((1, 1, 1),) * 4, dropout_rate=0.0)
HALOS = (2, 6)  # one hop over slabs of 4, and two


def _exchange_inputs():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 16, 3)).astype(np.float32)  # (B, H, C), slabs of 4
    weights = {h: rng.normal(size=(N, 2, 4 + 2 * h, 3)).astype(np.float32) for h in HALOS}
    return x, weights


def _stack_params():
    rng = np.random.default_rng(0)
    return {
        "w1": (rng.normal(size=(1, 3, 3, 3, 6)) * 0.3).astype(np.float32),
        "scale": (rng.normal(size=(6,)) * 0.3 + 1).astype(np.float32),
        "bias": (rng.normal(size=(6,)) * 0.2).astype(np.float32),
        "w6": (rng.normal(size=(6, 3)) * 0.3).astype(np.float32),
        "b6": (rng.normal(size=(3,)) * 0.1).astype(np.float32),
        "w7": (rng.normal(size=(3, 6)) * 0.3).astype(np.float32),
    }, rng.normal(size=(1, 4, 64, 8, 3)).astype(np.float32)


def _spatial_case():
    rng = np.random.default_rng(11)
    img = rng.normal(size=(1, 4, 320, 16, 3)).astype(np.float32)
    blob = np.zeros((1, 4, 320, 16), np.float32)
    blob[:, 1:3, 100:220, 4:12] = 1.0
    return img, np.stack([1.0 - blob, blob], axis=-1)


@pytest.fixture(scope="module")
def jm():
    """JAX's whole-gland test model with its own initializers, as JAX's
    tests build it (numpy-redrawn weights take the logits where the port's
    and JAX's fp32 forwards differ by ~1.7e-5)."""
    return JM1(**SPATIAL_KW, summary=False)


@pytest.fixture(scope="module")
def world(jm):
    """Every case of this module in one world of 4 ranks."""
    x, weights = _exchange_inputs()
    img, lab = _spatial_case()
    vol = np.random.default_rng(7).normal(size=(1, 4, 320, 16, 3)).astype(np.float32)
    params, xs = _stack_params()
    cfg, tp = jm.config, from_jax_params(jm.params)
    cases = [("exchange", (x, h, weights[h])) for h in HALOS]
    cases += [("infer", (cfg, tp, vol)), ("step", (cfg, tp, img, lab, 1e-5)),
              ("stack", (params, xs, 4))]
    got = run_world("halo_world", N, cases)
    return dict(got=got, x=x, weights=weights, vol=vol, img=img, lab=lab, params=params,
                xs=xs)


def _jax_mesh():
    return jmake_mesh(n_data=1, n_spatial=N, devices=jax.devices()[:N])


@pytest.mark.parametrize("halo", HALOS, ids=["one-hop", "multi-hop"])
def test_halo_exchange_matches_jax(world, halo):
    """Each rank's padded slab (zeros beyond the volume's ends) and the
    gradient of sum_r sum(padded_r * w_r) with respect to the slabs (JAX:
    the ppermutes' transpose)."""
    x, w = jnp.asarray(world["x"]), jnp.asarray(world["weights"][halo])
    spec = P(None, "spatial", None)

    def padded(xl):
        return jhalo.halo_exchange(xl, halo, "spatial", 1)

    def local_sum(xl, wl):
        return jnp.sum(padded(xl) * wl[0])[None]

    mesh = _jax_mesh()
    want = shard_map(padded, mesh=mesh, in_specs=(spec,), out_specs=spec,
                     check_vma=False)(x)
    total = shard_map(local_sum, mesh=mesh, in_specs=(spec, P("spatial")),
                      out_specs=P("spatial"), check_vma=False)
    want_grad = jax.grad(lambda v: jnp.sum(total(v, w)))(x)
    case = HALOS.index(halo)
    blocks = np.split(np.asarray(want), N, axis=1)
    for r in range(N):
        np.testing.assert_array_equal(world["got"][r][case][0], blocks[r])
    got_grad = np.concatenate([world["got"][r][case][1] for r in range(N)], axis=1)
    np.testing.assert_allclose(got_grad, np.asarray(want_grad), atol=1e-6)
    assert halo <= x.shape[1] // N or np.abs(blocks[0][:, :halo]).max() == 0


def test_spatial_infer_m1_matches_jax_and_the_unsharded_forward(jm, world):
    vol = world["vol"]
    want = np.asarray(jhalo.spatial_infer_m1(jm, jm.params, jnp.asarray(vol), _jax_mesh()))
    model = TM1(**{**jm.config, "summary": False}, device="cpu", init_params=False)
    model.params = from_jax_params(jm.params)
    import torch

    with torch.no_grad():
        unsharded = model.net(torch.as_tensor(vol))["y_softmax"].numpy()
    for r in range(N):
        got = world["got"][r][2]
        assert got.shape == unsharded.shape and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, atol=1e-5)
        np.testing.assert_allclose(got, unsharded, atol=1e-5)
        assert np.mean(np.argmax(got, -1) == np.argmax(unsharded, -1)) > 0.9999


def test_spatial_train_step_loss_matches_jax_and_the_unsharded_loss(jm, world):
    """The sharded step's loss at rtol 1e-5 against JAX's sharded step and
    the unsharded forward's focal loss; the second step lowers it."""
    img, lab = jnp.asarray(world["img"]), jnp.asarray(world["lab"])
    focal, tx = JFocal(alpha=(1.0, 1.0), gamma=2.0), optax.sgd(1e-5)
    step = jhalo.make_spatial_train_step(jm, focal, tx, _jax_mesh(), spatial_axis=2)
    _, _, want = step(jm.params, tx.init(jm.params), img, lab)
    ref = focal(lab, jm.net.apply({"params": jm.params}, img, train=True)["y_softmax"])
    for r in range(N):
        l1, l2 = world["got"][r][3]
        np.testing.assert_allclose(l1, float(want), rtol=1e-5)
        np.testing.assert_allclose(l1, float(ref), rtol=1e-5)
        assert l2 < l1


def test_sharded_gradients_of_the_conv_in_se_stack(world):
    """Gradients through the halo exchange, the core-masked IN statistics
    and the psum'd squeeze, held as JAX's own test holds its sharded ones
    (rtol 2e-4, atol 1e-4): against the port's unsharded autodiff and the
    fp64 gradient. JAX's unsharded fp32 gradient lies further from fp64
    (3.5e-4 on w1, whose largest element is 0.16, where the port's lies
    1.6e-5 away): it is held to fp64 by max|diff| / max(1, max|ref|) within
    5e-3, check_step's bound for JAX's rounding."""
    import torch

    from test_torch_dist_util import _stack_net

    x = world["xs"]
    want = {}
    for dtype in (torch.float32, torch.float64):
        p = {k: torch.as_tensor(v).to(dtype).requires_grad_(True)
             for k, v in world["params"].items()}
        loss = (_stack_net(p, torch.as_tensor(x).to(dtype))[..., :2] ** 2).sum()
        grads = torch.autograd.grad(loss, list(p.values()))
        want[dtype] = (float(loss.detach()), {k: g.numpy() for k, g in zip(p, grads)})
    q = {k: jnp.asarray(v) for k, v in world["params"].items()}

    def net(q, v):
        h = jax.lax.conv_general_dilated(v, q["w1"], (1, 1, 1), "SAME",
                                         dimension_numbers=("NDHWC", "DHWIO", "NDHWC"))
        h = jin(h, q["scale"], q["bias"])
        g = jgsm(h).astype(h.dtype)
        s = jax.nn.sigmoid(jnp.einsum("bdhwc,co->bdhwo", jax.nn.leaky_relu(
            jnp.einsum("bdhwc,co->bdhwo", g, q["w6"]) + q["b6"], 0.1), q["w7"]))
        return h * s

    jl, jg = jax.value_and_grad(lambda q: jnp.sum(net(q, jnp.asarray(x))[..., :2] ** 2))(q)
    exact_loss, exact = want[torch.float64]
    np.testing.assert_allclose(float(jl), exact_loss, rtol=1e-5)
    for k, v in exact.items():
        err = np.abs(np.asarray(jg[k]) - v).max() / max(1.0, np.abs(v).max())
        assert err <= 5e-3, (k, err)
    for r in range(N):
        loss, grads = world["got"][r][4]
        for ref_loss, ref in (want[torch.float32], want[torch.float64]):
            np.testing.assert_allclose(loss, ref_loss, rtol=1e-5)
            for k in ref:
                np.testing.assert_allclose(grads[k], ref[k], rtol=2e-4, atol=1e-4, err_msg=k)


def test_spatial_train_step_guards():
    """Active dropout, deep supervision and probabilistic models raise the
    JAX package's ValueErrors at build time (no world needed)."""
    common = dict(SPATIAL_KW, input_spatial_dims=(4, 64, 16))
    mesh = make_mesh(n_data=1, n_spatial=1, devices=["cpu"])
    tx = SGDNesterov(1e-5, momentum=0.0)
    for kw, match in ((dict(dropout_rate=0.5), "dropout_rate=0"),
                      (dict(deep_supervision=True), "deep_supervision"),
                      (dict(probabilistic=True, prob_latent_dims=(2, 1, 1, 0)),
                       "stand-alone deterministic")):
        model = TM1(**{**common, **kw}, summary=False, device="cpu", init_params=False)
        with pytest.raises(ValueError, match=match):
            thalo.make_spatial_train_step(model, Focal(), tx, mesh)
    with pytest.raises(ValueError, match="one process per position"):
        thalo.spatial_infer_m1(TM1(**common, summary=False, device="cpu"), None,
                               np.zeros((1, 4, 64, 16, 3), np.float32),
                               make_mesh(n_data=1, n_spatial=2, devices=["cpu"] * 2))
    assert thalo.receptive_margin(SPATIAL_KW["kernel_sizes"], SPATIAL_KW["strides"], 1) == \
        jhalo.receptive_margin(SPATIAL_KW["kernel_sizes"], SPATIAL_KW["strides"], 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sharded_instance_norm_matches_jax_formula(dtype):
    """The sharded norm without grad (K3 on the core copy, K4 with the
    statistics; their plain twins here) against JAX's sharded branch on a
    one-device spatial mesh, halo 4 of an extent of 24: fp32 within 1e-5;
    bf16 within 2**-6 of max(1, |ref|), K4's bf16 route rounding its
    coefficients to bf16 where JAX's sharded formula keeps them fp32."""
    import torch

    from prostatemr_3d_cad_cspca_tpu.ops.normalization import ShardedStats as JShardedStats
    from prostatemr_3d_cad_cspca_tpu_torch.ops.normalization import (ShardedStats,
                                                                     instance_norm)
    from prostatemr_3d_cad_cspca_tpu_torch.parallel.collectives import Axis

    rng = np.random.default_rng(4)
    x = (rng.normal(size=(2, 4, 24, 8, 6)) * 3 + 1).astype(np.float32)
    scale = (1 + 0.3 * rng.normal(size=6)).astype(np.float32)
    bias = (0.3 * rng.normal(size=6)).astype(np.float32)
    jmesh = jmake_mesh(n_data=1, n_spatial=1, devices=jax.devices()[:1])
    sh = JShardedStats(axis_name="spatial", spatial_axis=2, halo=4, extent=24)
    spec = P(None, None, "spatial")
    want = shard_map(lambda v: jin(v, jnp.asarray(scale), jnp.asarray(bias), sharded=sh),
                     mesh=jmesh, in_specs=(spec,), out_specs=spec,
                     check_vma=False)(jnp.asarray(x, dtype))
    want = np.asarray(want.astype(jnp.float32))
    tdt = getattr(torch, dtype)
    with torch.no_grad():
        got = instance_norm(torch.as_tensor(x).to(tdt), torch.as_tensor(scale),
                            torch.as_tensor(bias),
                            sharded=ShardedStats(Axis("spatial", 1), 2, 4, 24)).float().numpy()
    err = float((np.abs(got - want) / np.maximum(1.0, np.abs(want))).max())
    assert err <= (1e-5 if dtype == "float32" else 2.0 ** -6), err
