"""The port's inference layer against the JAX package's, on the CPU:
Monte-Carlo dropout (replayed keep-masks), ``mc_predict``, the sliding
window, flip TTA, fold ensembles and ``serve.run`` with whole-gland cases.

Models are the verify skill's tiny M1 (filters 4/8/12/16/24, SE reduction
2, 3 channels, the bench cfg1 strides) at 8x32x32, which leaves 2x2x2
voxels at the deepest level, so the deepest instance norm does not zero its
input and every dropout site's mask shows in the output. Parameters are
redrawn by numpy. Tolerances: fp32 atol 2e-5 for anything that runs the
network (the repo's oracle tolerance, tests/test_tf_parity.py:43); 1e-6 for
the sliding window around an analytic tile function; exact for the tile
geometry.

JAX draws its own bits, which the port cannot reproduce: the MC tests record
every ``nn.Dropout`` call of an eager flax forward with
``flax.linen.intercept_methods`` and hand the keep-masks to the port.
"""

import csv
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from prostatemr_3d_cad_cspca_tpu import ensemble as jens
from prostatemr_3d_cad_cspca_tpu import infer as jinfer
from prostatemr_3d_cad_cspca_tpu import serve as jserve
from prostatemr_3d_cad_cspca_tpu.models import M1 as JM1
from prostatemr_3d_cad_cspca_tpu_torch import ensemble as tens
from prostatemr_3d_cad_cspca_tpu_torch import infer as tinfer
from prostatemr_3d_cad_cspca_tpu_torch import serve as tserve
from prostatemr_3d_cad_cspca_tpu_torch.bridge import from_jax_params
from prostatemr_3d_cad_cspca_tpu_torch.models import M1 as TM1
from prostatemr_3d_cad_cspca_tpu_torch.models import blocks as tblocks
from test_torch_util import one_torch_thread  # noqa: F401  (autouse)

ATOL = 2e-5
SPATIAL = (8, 32, 32)
BIG = (10, 40, 40)  # 2 x 2 x 2 = 8 tiles of the window at overlap 0.5
KW = dict(input_spatial_dims=SPATIAL, input_channels=3, num_classes=2,
          filters=(4, 8, 12, 16, 24),
          strides=((1, 1, 1), (1, 2, 2), (1, 2, 2), (2, 2, 2), (2, 2, 2)),
          se_reduction=(2, 2, 2, 2, 2), summary=False)
MC = dict(dropout_mode="monte-carlo", dropout_rate=0.5)
SITES = ("drope1", "drope2", "drope3", "drope4", "dropd3", "dropd2", "dropd1", "dropd0")


def _redraw(params, seed):
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


def _jax_model(seed, **kw):
    model = JM1(**KW, **kw)
    model.params = _redraw(model.params, seed)
    return model


def _port(jmodel, **kw):
    model = TM1(**KW, device="cpu", init_params=False, **kw)
    model.params = from_jax_params(jmodel.params)
    return model


@pytest.fixture(scope="module")
def jdet():
    return _jax_model(0)


@pytest.fixture(scope="module")
def jmc():
    return _jax_model(0, **MC)


@pytest.fixture(scope="module")
def batch():
    return np.random.default_rng(1).normal(size=(2, *SPATIAL, 3)).astype(np.float32)


def _record_draw(jmodel, x, key):
    """One eager flax forward of ``jmodel`` as ``M1.apply(rng=key)`` runs it:
    (detect output, {site: keep-mask}, recorded module paths)."""
    seen = {}

    def interceptor(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if isinstance(context.module, nn.Dropout) and context.method_name == "__call__":
            seen[context.module.path] = (np.asarray(args[0]), np.asarray(out))
        return out

    d, l = jax.random.split(key)
    with nn.intercept_methods(interceptor):
        out = jmodel.net.apply({"params": jmodel.params}, jnp.asarray(x), train=False,
                               rngs={"dropout": d, "latent": l})
    # the keep-mask is out != 0 where the input is non-zero; elsewhere any
    # bit gives the same output
    masks = {path[1]: o != 0 for path, (_, o) in seen.items()}
    return {k: np.asarray(v) for k, v in out.items()}, masks, sorted(seen)


# ---------------------------------------------------------------- geometry
@pytest.mark.parametrize("full,window,overlap", [
    (24, 20, 0.5), (256, 160, 0.5), (192, 160, 0.5), (13, 5, 0.5), (10, 3, 0.5),
    (40, 10, 0.25), (21, 6, 0.25), (7, 7, 0.5), (5, 8, 0.5), (100, 7, 0.5), (9, 4, 0.9)])
def test_tile_starts_equal_jax(full, window, overlap):
    assert list(tinfer._tile_starts(full, window, overlap)) == \
        list(jinfer._tile_starts(full, window, overlap))


def test_tile_starts_round_half_to_even():
    # 5 * 0.5 = 2.5 -> 2 and 3 * 0.5 = 1.5 -> 2 under Python's round
    assert tinfer._tile_starts(13, 5, 0.5) == [0, 2, 4, 6, 8]
    assert tinfer._tile_starts(10, 3, 0.5) == [0, 2, 4, 6, 7]


@pytest.mark.parametrize("window", [(8, 32, 32), (20, 160, 160), (5, 8, 7), (1, 3, 2)])
def test_gaussian_importance_equals_jax(window):
    got = tinfer._gaussian_importance(window)
    want = jinfer._gaussian_importance(window)
    assert got.dtype == want.dtype and np.array_equal(got, want)


# ----------------------------------------------------------- sliding window
def _jf(t):
    return jnp.concatenate([jnp.sin(t[..., :1]) * 2, t[..., 1:2] ** 2,
                            t.mean(-1, keepdims=True)], -1)


def _tf(t):
    return torch.cat([torch.sin(t[..., :1]) * 2, t[..., 1:2] ** 2,
                      t.mean(-1, keepdim=True)], -1)


SW_VOL, SW_WIN = (13, 21, 17), (5, 8, 7)


@pytest.mark.parametrize("gaussian", [True, False])
def test_sliding_window_predict_matches_jax(gaussian):
    vol = np.random.default_rng(2).normal(size=(*SW_VOL, 3)).astype(np.float32)
    want = jinfer.sliding_window_predict(_jf, jnp.asarray(vol), SW_WIN, 0.5, 4,
                                         gaussian_weights=gaussian)
    got = tinfer.sliding_window_predict(_tf, torch.from_numpy(vol), SW_WIN, 0.5, 4,
                                        gaussian_weights=gaussian)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("cases", [1, 3])
def test_make_sliding_window_fn_matches_jax(cases):
    rng = np.random.default_rng(3)
    shape = (*SW_VOL, 3) if cases == 1 else (cases, *SW_VOL, 3)
    vol = rng.normal(size=shape).astype(np.float32)
    kw = dict(full_spatial=SW_VOL, window=SW_WIN, in_channels=3, out_channels=3,
              overlap=0.5, batch_size=4, cases=cases)
    want = jinfer.make_sliding_window_fn(_jf, **kw)(jnp.asarray(vol))
    got = tinfer.make_sliding_window_fn(_tf, **kw)(torch.from_numpy(vol))
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_sliding_window_chunk_generators_follow_the_calls():
    """rng_per_chunk: chunk i gets fold_in(rng, i), so a call is a fixed
    function of its generator's seed; padding tiles carry no weight. A
    one-process mesh of two CPU positions splits two cases over them and
    gives the same output; cases that do not divide the data axis raise."""
    seen = []

    def fn(tiles, gen):
        seen.append(gen.initial_seed())
        return tiles[..., :1] * 0 + torch.rand((), generator=gen)

    vol = torch.zeros((*SW_VOL, 3))
    run = tinfer.make_sliding_window_fn(fn, SW_VOL, SW_WIN, 3, 1, batch_size=4,
                                        rng_per_chunk=True, out_dtype=torch.float16)
    a = run(vol, torch.Generator().manual_seed(5))
    b = run(vol, torch.Generator().manual_seed(5))
    assert a.dtype == torch.float16 and torch.equal(a, b)
    n_tiles = math.prod(len(tinfer._tile_starts(f, w, 0.5)) for f, w in zip(SW_VOL, SW_WIN))
    assert len(seen) == 2 * -(-n_tiles // 4) and len(set(seen)) == len(seen) // 2
    from prostatemr_3d_cad_cspca_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(n_data=2, devices=["cpu", "cpu"])
    vols = torch.from_numpy(np.random.default_rng(3).normal(size=(2, *SW_VOL, 3))
                            .astype(np.float32))
    one = tinfer.make_sliding_window_fn(lambda t: t[..., :1] * 2, SW_VOL, SW_WIN, 3, 1,
                                        batch_size=4, cases=2)(vols)
    two = tinfer.make_sliding_window_fn(lambda t: t[..., :1] * 2, SW_VOL, SW_WIN, 3, 1,
                                        batch_size=4, cases=2, mesh=mesh)(vols)
    assert torch.equal(one, two)
    with pytest.raises(AssertionError, match="must divide"):
        tinfer.make_sliding_window_fn(fn, SW_VOL, SW_WIN, 3, 1, cases=3, mesh=mesh)


# ------------------------------------------------------------- mc_predict
@pytest.mark.parametrize("reduce,n", [("mean", 3), ("mean_std", 3), (None, 3),
                                      ("mean_std", 1)])
def test_mc_predict_reductions_match_jax(reduce, n):
    """The same sample stacks through both: JAX draws noise per key; the
    port replays those draws, stacked sample-major on the batch axis."""
    x = np.random.default_rng(4).normal(size=(2, 4, 5, 2)).astype(np.float32)
    key = jax.random.PRNGKey(3)

    def jdet(params, inputs, rng):
        return inputs + jax.random.normal(rng, inputs.shape)

    noise = np.asarray(jax.vmap(lambda k: jax.random.normal(k, x.shape))(
        jax.random.split(key, n))).reshape(n * 2, *x.shape[1:])
    want = jinfer.mc_predict(jdet, None, jnp.asarray(x), key, n, reduce=reduce)

    def tdet(params, inputs, rng):
        return inputs + torch.from_numpy(np.array(rng["noise"]))

    got = tinfer.mc_predict(tdet, None, x, {"noise": noise}, n, reduce=reduce)
    for g, w in zip(got if reduce == "mean_std" else (got,),
                    want if reduce == "mean_std" else (want,)):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)


# -------------------------------------------------------------- MC dropout
def test_mc_dropout_one_draw_matches_jax_with_replayed_masks(jmc, batch):
    out, masks, paths = _record_draw(jmc, batch, jax.random.PRNGKey(11))
    assert paths == sorted(("core", s, "Dropout_0") for s in SITES)
    assert all(0.3 < m.mean() < 0.9 for m in masks.values())  # masks are live
    got = _port(jmc, **MC).apply(None, batch, rng=masks)
    np.testing.assert_allclose(got["y_softmax"].numpy(), out["y_softmax"], atol=ATOL)
    # logits reach |8| after seven x2 dropout scalings; JAX's own eager and
    # jitted forwards of this draw differ by 3.5e-5 there, hence rtol too
    np.testing.assert_allclose(got["logits"].numpy(), out["logits"], atol=ATOL,
                               rtol=ATOL)
    plain = _port(jmc).apply(None, batch)  # dropout off: a different answer
    assert np.abs(plain["y_softmax"].numpy() - out["y_softmax"]).max() > 1e-3


def test_mc_predict_of_the_model_matches_jax(jmc, batch):
    """mc_predict(num_samples=3, 'mean_std') against JAX's, with the masks of
    the three keys of jax.random.split recorded one key at a time; those
    unbatched draws equal JAX's vmapped ones."""
    key = jax.random.PRNGKey(5)
    jdetect = jmc.get_detect_model()
    want_mean, want_std = jinfer.mc_predict(jdetect, jmc.params, batch, key, 3,
                                            reduce="mean_std")
    vmapped = jinfer.mc_predict(jdetect, jmc.params, batch, key, 3, reduce=None)
    draws = [_record_draw(jmc, batch, k) for k in jax.random.split(key, 3)]
    np.testing.assert_allclose(np.stack([d[0]["y_softmax"] for d in draws]),
                               np.asarray(vmapped), atol=ATOL)
    masks = {s: np.concatenate([d[1][s] for d in draws]) for s in SITES}
    mean, std = tinfer.mc_predict(_port(jmc, **MC).get_detect_model(), None, batch,
                                  masks, 3, reduce="mean_std")
    np.testing.assert_allclose(mean.numpy(), np.asarray(want_mean), atol=ATOL)
    np.testing.assert_allclose(std.numpy(), np.asarray(want_std), atol=ATOL)
    assert float(std.max()) > 1e-3


@pytest.mark.parametrize("rate", [0.5, 0.25])
def test_port_generator_masks(rate):
    """Keep share within 4 sigma of 1 - rate over 1e5 draws, kept values
    scaled exactly as flax scales them, the same seed the same draws."""
    n, keep = 100_000, 1.0 - rate
    x = torch.ones(n)
    y = tblocks.dropout(x, rate, torch.Generator().manual_seed(3))
    share = float((y != 0).float().mean())
    assert abs(share - keep) <= 4 * math.sqrt(keep * rate / n)
    assert torch.equal(y.unique(), torch.tensor([0.0, 1.0 / np.float32(keep)]))
    assert torch.equal(y, tblocks.dropout(x, rate, torch.Generator().manual_seed(3)))
    assert not torch.equal(y, tblocks.dropout(x, rate, torch.Generator().manual_seed(4)))


def test_bf16_dropout_scales_as_flax():
    """x / keep in bf16 rounds as flax's does (keep 0.75 at dropd0)."""
    x = np.random.default_rng(6).normal(size=(64, 33)).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    mask = np.random.default_rng(7).random(x.shape) < 0.75
    got = tblocks.dropout(xb, 0.25, {"s": mask}, "s")
    want = jax.lax.select(jnp.asarray(mask), jnp.asarray(x, jnp.bfloat16) / 0.75,
                          jnp.zeros(x.shape, jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.float().numpy(), np.asarray(want, np.float32))


def test_mc_model_draws_fresh_seeds_and_replays_given_ones(jmc, batch):
    model = _port(jmc, **MC)
    a = model.predict(batch, rng=9)
    assert torch.equal(a, model.predict(batch, rng=torch.Generator().manual_seed(9)))
    assert not torch.equal(model.predict(batch), model.predict(batch))
    with pytest.raises(ValueError, match="needs rng"):
        model.get_detect_model()(None, batch)


# --------------------------------------------------------- TTA, ensembles
def test_tta_detect_matches_jax(jdet, batch):
    want = jens.tta_detect(jdet.get_detect_model(), flip_axes=(-2, -3))(jdet.params, batch)
    got = tens.tta_detect(_port(jdet).get_detect_model(), flip_axes=(-2, -3))(None, batch)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert tens.AXIAL_LR_AXIS == jens.AXIAL_LR_AXIS == -2
    with pytest.raises(ValueError):
        tens.tta_detect(lambda p, x: x, flip_axes=(-1,))


@pytest.mark.parametrize("reduce", ["mean", "mean_std"])
def test_two_member_ensemble_matches_jax(jdet, batch, reduce):
    j2 = _jax_model(1)
    want = jens.M1Ensemble([jdet, j2], reduce=reduce).predict(batch)
    got = tens.M1Ensemble([_port(jdet), _port(j2)], reduce=reduce).predict(batch)
    for g, w in zip(got if reduce == "mean_std" else (got,),
                    want if reduce == "mean_std" else (want,)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


def test_ensemble_refuses_mixed_architectures(jdet):
    other = TM1(**{**KW, "filters": (4, 8, 12, 16, 32)}, device="cpu")
    with pytest.raises(ValueError, match="filters"):
        tens.M1Ensemble([_port(jdet), other])


# ------------------------------------------------------------ serve.run
def _manifest(tmp_path, shapes):
    rng = np.random.default_rng(8)
    rows = []
    for i, shape in enumerate(shapes):
        ip = str(tmp_path / f"case{i}.npy")
        np.save(ip, rng.normal(size=(*shape, 3)).astype(np.float32))
        rows.append({"p-id": f"case{i}", "image_path": ip})
    man = str(tmp_path / "test.csv")
    with open(man, "w", newline="") as fh:
        w = csv.DictWriter(fh, fieldnames=list(rows[0]))
        w.writeheader()
        [w.writerow(r) for r in rows]
    return man


def test_serve_run_with_sliding_windows_matches_jax(jdet, tmp_path):
    """One oversized case first, then a window-sized one, then another
    oversized one of the same shape: the outputs come back in manifest
    order."""
    ckpt = str(tmp_path / "model.npz")
    jdet.save(ckpt)
    man = _manifest(tmp_path, [BIG, SPATIAL, BIG])
    argv = ["--MODEL", ckpt, "--MANIFEST", man, "--BATCH_SIZE", "2"]
    want = jserve.run(jserve.build_parser().parse_args(
        argv + ["--OUTPUT_DIR", str(tmp_path / "jax")]))
    got = tserve.run(tserve.build_parser().parse_args(
        argv + ["--OUTPUT_DIR", str(tmp_path / "port"), "--DEVICE", "cpu"]))
    with open(tmp_path / "port" / "predictions.json") as f:
        assert json.load(f) == got
    assert [r["p-id"] for r in got] == [r["p-id"] for r in want] == \
        ["case0", "case1", "case2"]
    for g, w in zip(got, want):
        det = np.load(g["detection_path"])
        assert det.shape == np.load(w["detection_path"]).shape
        np.testing.assert_allclose(det, np.load(w["detection_path"]), atol=ATOL)
        assert abs(g["case_score"] - w["case_score"]) <= ATOL
        assert [c["voxels"] for c in g["lesion_candidates"]] == \
            [c["voxels"] for c in w["lesion_candidates"]]
    assert np.load(got[0]["detection_path"]).shape == (*BIG, 2)


def test_serve_run_mc_ensemble_with_tta_writes_uncertainty(jmc, tmp_path):
    ckpt = str(tmp_path / "mc.npz")
    jmc.save(ckpt)
    man = _manifest(tmp_path, [SPATIAL, BIG, BIG])

    def serve(out):
        return tserve.main(["--MODEL", f"{ckpt},{ckpt}", "--MANIFEST", man,
                            "--OUTPUT_DIR", str(tmp_path / out), "--MC_ITER", "2",
                            "--TTA", "1", "--SEED", "3", "--TRANSFER_CHANNELS",
                            "foreground", "--DEVICE", "cpu"])

    first, again = serve("a"), serve("b")
    assert [r["p-id"] for r in first] == ["case0", "case1", "case2"]
    for r, r2, shape in zip(first, again, [SPATIAL, BIG, BIG]):
        det, unc = np.load(r["detection_path"]), np.load(r["uncertainty_path"])
        assert det.shape == unc.shape == (*shape, 2)
        assert (unc >= 0).all() and unc.max() > 1e-4
        np.testing.assert_allclose(unc[..., 0], unc[..., 1])  # std(1 - p) == std(p)
        assert np.abs(det.sum(-1) - 1).max() <= 1e-5
        assert np.array_equal(det, np.load(r2["detection_path"]))
        assert np.array_equal(unc, np.load(r2["uncertainty_path"]))
