"""The port's training data layer (``data/generators.py``,
``data/preprocess.py``) against the JAX package's, on the CPU:
``custom_data_generator``'s order and samples for one ``shuffle_seed``
(with and without ``cache_dir``, whose files and replay must match),
``batch_iterator``'s stacking, its errors raised to the consumer, its
prefetch thread gone after ``close()`` and its per-batch seeds, and
each preprocessing helper. Host numpy copies are held bit for bit;
``whitening_device`` (torch, fp32 reductions in another order) within
2e-5, the fp32 parity tolerance.
"""

import csv
import os
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prostatemr_3d_cad_cspca_tpu.data import generators as jg
from prostatemr_3d_cad_cspca_tpu.data import preprocess as jp
from prostatemr_3d_cad_cspca_tpu_torch import augment as ta
from prostatemr_3d_cad_cspca_tpu_torch import prng
from prostatemr_3d_cad_cspca_tpu_torch.data import generators as tg
from prostatemr_3d_cad_cspca_tpu_torch.data import preprocess as tp

SHAPE = (4, 16, 16)


@pytest.fixture
def manifest(tmp_path):
    """Five labelled cases (.npy image, lesion grades, zones) and a csv."""
    rng = np.random.default_rng(0)
    rows = []
    for i in range(5):
        paths = {k: str(tmp_path / f"case{i}_{k}.npy") for k in ("image", "label", "zones")}
        np.save(paths["image"], rng.normal(size=(*SHAPE, 3)).astype(np.float32))
        grades = np.zeros(SHAPE, np.float32)
        grades[1:3, 3 + i:9 + i, 4:10] = 2.0 + (i % 2)
        np.save(paths["label"], grades)
        np.save(paths["zones"], rng.integers(0, 3, SHAPE).astype(np.uint8))
        rows.append({"p-id": f"case{i}", "image_path": paths["image"],
                     "label_path": paths["label"], "zones_path": paths["zones"]})
    path = str(tmp_path / "train-fold-1.csv")
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    return path


def _take(gen, n):
    out = [next(gen) for _ in range(n)]
    gen.close()
    return out


def _assert_samples_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("kw", [
    dict(train_obj="lesion", shuffle_seed=3),
    dict(train_obj="lesion", probabilistic=True, with_dist_map=True, shuffle_seed=11),
    dict(train_obj="zonal", mode="valid", shuffle_seed=None),
], ids=["lesion", "lesion_prob_edt", "zonal_valid_unshuffled"])
def test_custom_data_generator_gives_jax_samples_in_jax_order(manifest, kw):
    n = 12  # two epochs and a bit: each epoch reshuffled
    _assert_samples_equal(_take(tg.custom_data_generator(manifest, **kw), n),
                          _take(jg.custom_data_generator(manifest, **kw), n))


def test_cache_dir_writes_jax_files_and_replays_them(manifest, tmp_path):
    kw = dict(train_obj="lesion", probabilistic=True, with_dist_map=True, shuffle_seed=5)
    jdir, tdir = str(tmp_path / "jcache"), str(tmp_path / "tcache")
    want = _take(jg.custom_data_generator(manifest, cache_dir=jdir, **kw), 7)
    first = _take(tg.custom_data_generator(manifest, cache_dir=tdir, **kw), 7)
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    assert sorted(os.listdir(tdir))[0] == "case0.lesion-p-train-edt.npz"
    _assert_samples_equal(first, want)
    # a replay from the cache (the cases themselves gone) gives the same
    for name in os.listdir(tmp_path):
        if name.endswith(".npy"):
            os.remove(tmp_path / name)
    _assert_samples_equal(_take(tg.custom_data_generator(manifest, cache_dir=tdir, **kw), 7),
                          want)


def _new_threads(before):
    return [t for t in threading.enumerate() if t not in before and t.is_alive()]


@pytest.mark.parametrize("prefetch", [0, 2])
def test_batch_iterator_stacks_samples_in_order(manifest, prefetch):
    samples = _take(jg.custom_data_generator(manifest, train_obj="lesion", shuffle_seed=1), 6)
    before = set(threading.enumerate())
    it = tg.batch_iterator(tg.custom_data_generator(manifest, train_obj="lesion",
                                                    shuffle_seed=1), 3, prefetch=prefetch)
    batches = [next(it), next(it)]
    it.close()
    for b, batch in enumerate(batches):
        for k in samples[0]:
            np.testing.assert_array_equal(batch[k], np.stack([s[k] for s in
                                                              samples[3 * b:3 * b + 3]]))
    assert _new_threads(before) == []  # the producer has stopped


def test_batch_iterator_raises_a_loading_error_to_the_consumer():
    def broken():
        yield {"image": np.zeros((2, 2), np.float32)}
        raise OSError("unreadable case")

    before = set(threading.enumerate())
    it = tg.batch_iterator(broken(), 2, prefetch=2)
    with pytest.raises(OSError, match="unreadable case"):
        next(it)
    deadline = time.monotonic() + 5.0
    while _new_threads(before) and time.monotonic() < deadline:
        time.sleep(0.05)
    assert _new_threads(before) == []


def test_batch_iterator_thread_is_gone_after_close():
    def endless():
        while True:
            yield {"image": np.zeros((2, 2), np.float32)}

    before = set(threading.enumerate())
    it = tg.batch_iterator(endless(), 2, prefetch=2)
    next(it)
    assert len(_new_threads(before)) == 1  # the producer, blocked on a full queue
    it.close()
    assert _new_threads(before) == []


def test_batch_iterator_augments_batch_i_with_its_folded_seed(manifest):
    fn = ta.make_augment_fn(ta.AugmentParams(tx_prob=0.0), "lesion", device="cpu")
    samples = _take(jg.custom_data_generator(manifest, train_obj="lesion"), 4)
    it = tg.batch_iterator(tg.custom_data_generator(manifest, train_obj="lesion"), 2,
                           augment_fn=fn, rng_seed=9)
    got = [next(it), next(it)]
    it.close()
    base = prng.generator(9, "cpu")
    for i, batch in enumerate(got):
        raw = {k: np.stack([s[k] for s in samples[2 * i:2 * i + 2]]) for k in samples[0]}
        want = fn(prng.fold_in(base, i), raw)
        for k in want:
            assert torch.equal(batch[k], want[k]), (i, k)
        assert not np.allclose(batch["image"].numpy(), raw["image"])


# ------------------------------------------------------------- preprocess
def test_center_crop_matches_jax():
    vol = np.random.default_rng(1).normal(size=(9, 20, 22, 2)).astype(np.float32)
    for kw in (dict(), dict(center_2d_coords=(8.7, 12.2))):
        np.testing.assert_array_equal(tp.center_crop(vol[..., 0], 5, 10, 12, **kw),
                                      jp.center_crop(vol[..., 0], 5, 10, 12, **kw))
        np.testing.assert_array_equal(tp.center_crop(vol, 4, 9, 7, multi_channel=True, **kw),
                                      jp.center_crop(vol, 4, 9, 7, multi_channel=True, **kw))


@pytest.mark.parametrize("size", [(6, 12, 14), (11, 25, 20), (9, 20, 22)])
def test_resize_image_with_crop_or_pad_matches_jax(size):
    vol = np.random.default_rng(2).normal(size=(9, 20, 22, 3)).astype(np.float32)
    for x in (vol, vol[..., 0]):
        got = tp.resize_image_with_crop_or_pad(x, size, mode="constant")
        np.testing.assert_array_equal(got, jp.resize_image_with_crop_or_pad(
            x, size, mode="constant"))
        assert got.shape[:3] == size


@pytest.mark.parametrize("is_label", [False, True])
def test_resample_volume_matches_jax(is_label):
    rng = np.random.default_rng(3)
    vol = (rng.integers(0, 3, (6, 10, 12)).astype(np.uint8) if is_label
           else rng.normal(size=(6, 10, 12, 2)).astype(np.float32))
    for spacing in ((3.0, 0.5, 0.5), (1.5, 0.8, 0.6)):
        got = tp.resample_volume(vol, spacing, (1.5, 0.7, 0.7), is_label=is_label)
        want = jp.resample_volume(vol, spacing, (1.5, 0.7, 0.7), is_label=is_label)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_resample_img_refuses_without_simpleitk_as_jax_does():
    if tp._HAS_SITK:
        pytest.skip("SimpleITK is installed: nothing to refuse")
    for mod in (tp, jp):
        with pytest.raises(ImportError, match="SimpleITK"):
            mod.resample_img(object())


@pytest.mark.parametrize("percentile", [None, 99.0, 97.5])
def test_whitening_device_matches_jax(percentile):
    img = (np.random.default_rng(4).standard_t(3, size=(2, 6, 20, 20, 3)) * 3 + 1).astype(
        np.float32)
    want = np.asarray(jp.whitening_device(jnp.asarray(img), percentile))
    got = tp.whitening_device(torch.from_numpy(img), percentile)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)
    # the host twin agrees on what it clips
    np.testing.assert_allclose(got.numpy(), tp.whitening(img, percentile), atol=2e-5, rtol=0)


def test_whitening_device_percentiles_are_jax_linear_interpolation():
    x = np.random.default_rng(5).normal(size=1001).astype(np.float32)
    for q in (0.5, 2.5, 50.0, 97.5, 99.0):
        got = float(tp._percentiles(torch.from_numpy(x), (q,))[0])
        assert got == float(jnp.percentile(jnp.asarray(x), q)), q


def test_whitening_device_maps_a_constant_image_to_zeros():
    out = tp.whitening_device(torch.full((3, 4, 4), 7.0), 99.0)
    assert torch.equal(out, torch.zeros(3, 4, 4))
