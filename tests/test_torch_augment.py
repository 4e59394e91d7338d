"""The port's augmentation (``augment.py``) against the JAX package's, on the
CPU, at the tiny model's 8x32x32.

JAX draws from its keys, which the port cannot reproduce: the comparisons
replay JAX's draws into the port (``jax_augment_draws`` and
``jax_batch_draws`` in tests/test_torch_util.py re-derive them from JAX's
key splits; if they were wrong, the outputs would differ). Each transform
alone, then ``augment_sample`` and ``augment_batch`` whole for the lesion
(3 MRI channels), probabilistic (a 4th, label channel) and zonal (1)
tasks, with and without a dist_map, with every gate forced on
(``tx_prob`` 0), every transform gate off (``tx_prob`` 1) and the master
gate off (``prob`` 0), at three keys that between them take the flip and
every per-channel coin both ways. Index-only transforms (flip, translate,
channel shift, nearest) are bit-equal; the rest within 2e-5, the fp32
parity tolerance (``ROADMAP.md``). Then the JAX package's property tests
(tests/test_augment.py), repeated on the port with its own generators.
"""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prostatemr_3d_cad_cspca_tpu import augment as ja
from prostatemr_3d_cad_cspca_tpu_torch import augment as ta
from prostatemr_3d_cad_cspca_tpu_torch import prng
from test_torch_util import jax_augment_draws, jax_batch_draws
from test_torch_util import one_torch_thread  # noqa: F401  (autouse)

ATOL = 2e-5
D, H, W = 8, 32, 32
KEYS = (2, 10, 4)  # between them: the flip and each gamma and poor-scan coin both ways
TASKS = {"lesion": ("lesion", 3, 2), "probabilistic": ("lesion", 4, 2), "zonal": ("zonal", 1, 3)}
GATES = {"on": dict(tx_prob=0.0), "off": dict(tx_prob=1.0), "master_off": dict(prob=0.0)}


def _sample(seed, channels, classes, shape=(D, H, W)):
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(*shape, channels)).astype(np.float32)
    lab = np.zeros(shape, np.int64)
    lab[2:5, 8:20, 10:22] = 1
    lab[5:7, 20:28, 4:12] = classes - 1
    lbl = np.eye(classes, dtype=np.float32)[lab]
    dm = rng.normal(size=(*shape, classes - 1)).astype(np.float32)
    return img, lbl, dm


def _both(**kw):
    return ja.AugmentParams(**kw), ta.AugmentParams(**kw)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def test_replayed_keys_cover_every_coin_both_ways():
    draws = [jax_augment_draws(jax.random.PRNGKey(k), ja.AugmentParams(), (D, H, W, 3))
             for k in KEYS]
    assert {bool(d["flip_on"] > 0.5) for d in draws} == {False, True}
    for name in ("gamma_channel", "poor_channel"):
        coins = np.stack([d[name] > 0.5 for d in draws])
        assert coins.any(0).all() and (~coins).any(0).all(), (name, coins)


# ------------------------------------------------------- each transform alone
@pytest.mark.parametrize("scale", [32, 35, 38])
def test_zoom_matches_jax(scale):
    img, lbl, _ = _sample(0, 3, 2)
    x = np.concatenate([img, lbl], -1)
    want = np.asarray(ja._zoom(jnp.asarray(x), jnp.asarray(scale, jnp.int32)))
    got = ta._zoom(_t(x[None]), torch.tensor([scale]))[0].numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("angle", [-10.0, -3.7, 0.0, 8.25, 45.0])
def test_rotate_matches_jax(angle):
    x = _sample(1, 3, 2)[0]
    want = np.asarray(ja._rotate(jnp.asarray(x), jnp.float32(angle)))
    got = ta._rotate(_t(x[None]), torch.tensor([angle]))[0].numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("pads", [(0, 0, 0, 0), (3, 1, 0, 4), (1, 70, 66, 2), (80, 5, 1, 99)])
def test_translate_matches_jax_bit_for_bit(pads):
    """Shifts beyond one period (2 H = 64) fold back as JAX's ``jnp.mod``."""
    x = _sample(2, 3, 2)[0]
    top, bottom, right, left = pads
    want = np.asarray(ja._translate(jnp.asarray(x), bottom - top, right - left))
    got = ta._translate(_t(x[None]), torch.tensor([pads]))[0].numpy()
    np.testing.assert_array_equal(got, want)


def test_flip_and_channel_shift_match_jax_bit_for_bit():
    """Only the flip, then only the channel shift, under replayed draws with
    the gate on: index-only, so the same bits."""
    img, lbl, _ = _sample(3, 4, 2)
    for kw in (dict(translate_factor=0.0, rotation_degree=0.0, zoom_factor=0.0,
                    gauss_noise_stddev=0.0, chan_shift_factor=0.0, sim_poor_scan=False,
                    gamma_correct=(0.0, 0.0), tx_prob=0.0),
               dict(translate_factor=0.0, rotation_degree=0.0, axial_hflip=False,
                    zoom_factor=0.0, gauss_noise_stddev=0.0, chan_shift_factor=0.2,
                    sim_poor_scan=False, gamma_correct=(0.0, 0.0), tx_prob=0.0)):
        jp, tp = _both(**kw)
        key = jax.random.PRNGKey(KEYS[1])
        d = jax_augment_draws(key, jp, img.shape)
        want = ja.augment_sample(key, jnp.asarray(img), jnp.asarray(lbl), jp)
        got = ta.augment_sample(d, img, lbl, tp)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert not np.array_equal(got[0].numpy(), img)


@pytest.mark.parametrize("gamma", [0.5, 0.83, 1.5])
def test_gamma_matches_jax(gamma):
    img = _sample(4, 3, 2)[0] * 2.0 + 1.0
    key = next(k for k in (jax.random.PRNGKey(i) for i in range(20))
               if float(jax.random.uniform(k)) > 0.5)  # the per-channel coin on
    got = ta._gamma(_t(img[None]), torch.tensor([gamma]))[0].numpy()
    for c in range(3):
        want = np.asarray(ja._gamma_one_channel(key, jnp.asarray(img[..., c]),
                                                jnp.float32(gamma)))
        np.testing.assert_allclose(got[..., c], want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("width", [32, 24, 40])
def test_poor_scan_matches_jax(width):
    """Square, and W below or above H (cropped, zero-padded)."""
    img = _sample(5, 3, 2, shape=(D, H, width))[0]
    key = next(k for k in (jax.random.PRNGKey(i) for i in range(20))
               if float(jax.random.uniform(k)) > 0.5)
    got = ta._poor_scan(_t(img[None]))[0].numpy()
    for c in range(3):
        want = np.asarray(ja._poor_scan_one_channel(key, jnp.asarray(img[..., c])))
        np.testing.assert_allclose(got[..., c], want, atol=ATOL, rtol=0)


# ---------------------------------------------------- whole, replayed draws
@pytest.mark.parametrize("gates", sorted(GATES))
@pytest.mark.parametrize("with_dm", [False, True], ids=["no_dist_map", "dist_map"])
@pytest.mark.parametrize("task", sorted(TASKS))
def test_augment_sample_matches_jax_under_replayed_draws(task, with_dm, gates):
    train_obj, channels, classes = TASKS[task]
    img, lbl, dm = _sample(6, channels, classes)
    jp, tp = _both(**GATES[gates])
    for k in KEYS:
        key = jax.random.PRNGKey(k)
        d = jax_augment_draws(key, jp, img.shape, train_obj)
        want = ja.augment_sample(key, jnp.asarray(img), jnp.asarray(lbl), jp, train_obj,
                                 jnp.asarray(dm) if with_dm else None)
        got = ta.augment_sample(d, img, lbl, tp, train_obj, dm if with_dm else None)
        assert len(got) == len(want) == (3 if with_dm else 2)
        for g, w in zip(got, want):
            assert g.dtype == torch.float32 and g.shape == w.shape
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0)
        if gates != "on":  # at most the flip (p 0.5) applies: index-only, bit for bit
            np.testing.assert_array_equal(got[0].numpy(), img if gates == "master_off"
                                          else np.asarray(want[0]))
        else:
            assert not np.allclose(got[0].numpy(), img)


@pytest.mark.parametrize("task", ["lesion", "zonal"])
def test_augment_batch_matches_jax_under_replayed_draws(task):
    """The CLI's parameters over a batch of 3, each sample its own draws
    (``split(key, B)``), a dist_map warped with the label."""
    train_obj, channels, classes = TASKS[task]
    samples = [_sample(10 + i, channels, classes) for i in range(3)]
    batch = {"image": np.stack([s[0] for s in samples]),
             "detection": np.stack([s[1] for s in samples]),
             "dist_map": np.stack([s[2] for s in samples]),
             "KL": np.zeros((3, 1), np.float32)}
    jp, tp = _both(tx_prob=0.25)
    key = jax.random.PRNGKey(5)
    want = ja.augment_batch(key, {k: jnp.asarray(v) for k, v in batch.items()}, jp, train_obj)
    d = jax_batch_draws(key, jp, batch["image"].shape, train_obj)
    got = ta.augment_batch(d, {k: _t(v) for k, v in batch.items()}, tp, train_obj)
    assert sorted(got) == sorted(batch)
    for k in ("image", "detection", "dist_map"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(got["KL"].numpy(), batch["KL"])


def test_from_list_reads_the_cli_list_and_its_gamma_fallback():
    cli = [1.0, 0.25, 0.15, 10.0, True, 1.2, 0.1, 0.025, True, (0.5, 1.5)]
    assert ta.AugmentParams.from_list(cli) == ta.AugmentParams()
    for lst in (cli, cli[:9] + [0.7]):  # a bare number: the (0.5, 1.5) fallback
        assert dataclasses.asdict(ta.AugmentParams.from_list(lst)) == dataclasses.asdict(
            ja.AugmentParams.from_list(lst))
    assert ta.AugmentParams.from_list(cli[:9] + [[0.8, 1.2]]).gamma_correct == (0.8, 1.2)


def test_generator_draws_follow_the_documented_order():
    """A generator's draws: one uniform block (B, 22 + 2 n) in the order of
    UNIFORM_COLUMNS, then the standard normal noise; values in range."""
    p = ta.AugmentParams()
    shape = (3, D, H, W, 3)
    d = ta.draw(prng.generator(4, "cpu"), shape, p)
    g = prng.generator(4, "cpu")
    u = torch.rand((3, len(ta.UNIFORM_COLUMNS) + 6), generator=g)
    noise = torch.randn((3, D, H, W, 3), generator=g)
    assert sorted(d) == sorted(ta.DRAW_NAMES)
    assert torch.equal(d["master"], u[:, 0]) and torch.equal(d["noise"], noise)
    assert torch.equal(d["poor_channel"], u[:, -3:])
    assert ((d["zoom_scale"] >= H) & (d["zoom_scale"] < 39)).all()
    assert (d["trans_pads"] >= 0).all() and (d["trans_pads"] < 5).all()
    assert (d["cs_pads"] >= 0).all() and (d["cs_pads"] < 1).all()  # ceil(32 * 0.025) = 1
    assert ((d["cs_channel"] >= 0) & (d["cs_channel"] < 3)).all()
    assert (d["rot_angle"].abs() <= 10).all() and ((d["gamma"] >= 0.5) & (d["gamma"] < 1.5)).all()
    with pytest.raises(ValueError, match="rng"):
        ta.draw(None, shape, p)


# ------------------------------------- the JAX package's property tests
def _blob_label():
    lab = np.zeros((4, 16, 16), np.float32)
    lab[1:3, 4:10, 5:11] = 1.0
    return np.stack([1.0 - lab, lab], axis=-1)


def _geom_only(**kw):
    base = dict(prob=1.0, tx_prob=0.0, translate_factor=0.2, rotation_degree=15.0,
                axial_hflip=True, zoom_factor=1.3, gauss_noise_stddev=0.0,
                chan_shift_factor=0.0, sim_poor_scan=False, gamma_correct=(0.0, 0.0))
    return ta.AugmentParams(**{**base, **kw})


def _gen(seed):
    return prng.generator(seed, "cpu")


def test_master_prob_zero_is_identity():
    img = np.random.default_rng(0).normal(size=(4, 16, 16, 3)).astype(np.float32)
    lbl = _blob_label()
    out_i, out_l = ta.augment_sample(_gen(0), img, lbl, ta.AugmentParams(prob=0.0))
    np.testing.assert_array_equal(out_i.numpy(), img)
    np.testing.assert_array_equal(out_l.numpy(), lbl)


def test_the_same_generator_gives_the_same_bits():
    img = np.random.default_rng(1).normal(size=(4, 16, 16, 3)).astype(np.float32)
    lbl, p = _blob_label(), ta.AugmentParams(tx_prob=0.0)
    a = ta.augment_sample(_gen(7), img, lbl, p)
    b = ta.augment_sample(_gen(7), img, lbl, p)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    c = ta.augment_sample(_gen(8), img, lbl, p)
    assert not torch.allclose(a[0], c[0])


def test_shared_draws_keep_image_label_aligned():
    lbl = _blob_label()
    img = np.repeat(lbl[..., 1:2], 3, axis=-1)
    for seed in range(4):
        out_i, out_l = ta.augment_sample(_gen(seed), img, lbl, _geom_only())
        np.testing.assert_allclose(out_i[..., 0].numpy(), out_l[..., 1].numpy(), atol=1e-5)
        np.testing.assert_allclose(out_l.sum(-1).numpy(), 1.0, atol=1e-5)


def test_intensity_transforms_never_touch_labels():
    p = ta.AugmentParams(prob=1.0, tx_prob=0.0, translate_factor=0.0, rotation_degree=0.0,
                         axial_hflip=False, zoom_factor=0.0, gauss_noise_stddev=0.5,
                         chan_shift_factor=0.0, sim_poor_scan=True, gamma_correct=(0.5, 1.5))
    img = np.random.default_rng(2).normal(size=(4, 16, 16, 4)).astype(np.float32)
    lbl = _blob_label()
    out_i, out_l = ta.augment_sample(_gen(3), img, lbl, p)
    np.testing.assert_array_equal(out_l.numpy(), lbl)
    np.testing.assert_array_equal(out_i[..., 3].numpy(), img[..., 3])  # appended channel
    assert not np.allclose(out_i.numpy(), img)


def test_channel_shift_moves_exactly_one_mri_channel():
    p = ta.AugmentParams(prob=1.0, tx_prob=0.0, translate_factor=0.0, rotation_degree=0.0,
                         axial_hflip=False, zoom_factor=0.0, gauss_noise_stddev=0.0,
                         chan_shift_factor=0.2, sim_poor_scan=False, gamma_correct=(0.0, 0.0))
    img = np.random.default_rng(4).normal(size=(4, 16, 16, 4)).astype(np.float32)
    moved = []
    for seed in range(6):
        out_i, _ = ta.augment_sample(_gen(seed), img, _blob_label(), p, train_obj="lesion")
        changed = [not np.allclose(out_i[..., c].numpy(), img[..., c]) for c in range(4)]
        assert sum(changed[:3]) <= 1 and not changed[3]
        moved.append(sum(changed))
    assert max(moved) == 1


def test_batch_augment_preserves_shapes_and_stays_finite():
    batch = {"image": torch.from_numpy(
        np.random.default_rng(5).normal(size=(2, 4, 16, 16, 3)).astype(np.float32)),
             "detection": torch.from_numpy(np.stack([_blob_label()] * 2))}
    out = ta.augment_batch(_gen(0), batch, ta.AugmentParams())
    assert out["image"].shape == batch["image"].shape
    assert out["detection"].shape == batch["detection"].shape
    assert torch.isfinite(out["image"]).all()


def test_zoom_preserves_label_mass_approximately():
    p = _geom_only(translate_factor=0.0, rotation_degree=0.0, axial_hflip=False,
                   zoom_factor=1.2)
    lbl = _blob_label()
    img = np.repeat(lbl[..., 1:2], 3, axis=-1)
    _, out_l = ta.augment_sample(_gen(1), img, lbl, p)
    assert float(out_l[..., 1].sum()) > 0.5 * float(lbl[..., 1].sum())


def test_make_augment_fn_moves_the_batch_and_augments_it():
    fn = ta.make_augment_fn([1.0, 0.0, 0.15, 10.0, 1, 1.2, 0.1, 0.025, 1, (0.5, 1.5)],
                            device="cpu")
    batch = {"image": np.random.default_rng(6).normal(size=(2, 4, 16, 16, 3)).astype(
        np.float32), "detection": np.stack([_blob_label()] * 2)}
    out = fn(_gen(2), batch)
    want = ta.augment_batch(_gen(2), {k: torch.from_numpy(v) for k, v in batch.items()},
                            ta.AugmentParams(tx_prob=0.0))
    for k in batch:
        assert torch.equal(out[k], want[k])


def test_a_pass_runs_the_same_ops_at_any_batch_and_reads_nothing_back():
    """One pass over the batch: the ops dispatched do not grow with the
    batch size, and none reads a value back to the host (``.item()``,
    ``nonzero``), so the pass never synchronises with a card."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(str(func.overloadpacket))
            return func(*args, **(kwargs or {}))

    counts = []
    for b in (1, 4):
        img, lbl, dm = _sample(7, 4, 2)
        batch = {"image": _t(np.stack([img] * b)), "detection": _t(np.stack([lbl] * b)),
                 "dist_map": _t(np.stack([dm] * b))}
        with Ops() as mode:
            ta.augment_batch(_gen(b), batch, ta.AugmentParams())
        counts.append(collections.Counter(mode.ops))
        assert not {"aten._local_scalar_dense", "aten.nonzero", "aten.item"} & set(mode.ops)
    assert counts[0] == counts[1]
