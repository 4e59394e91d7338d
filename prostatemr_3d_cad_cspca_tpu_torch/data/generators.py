"""Data generators: manifest -> preprocessed .npy -> model-ready samples and
batches, port of the JAX package's ``data/generators.py`` (host-side numpy,
copied: ``load_sample`` :84-144 and the contour smoothening :36-81; the
training generators ``custom_data_generator`` :147-193 and
``batch_iterator`` :196-270, whose per-batch keys are ``prng`` generators).

Per-task label handling (reference data_generators.py:43-97):

  * zonal  — split zones into TZ/PZ binaries, Gaussian-blur contour
             smoothening per axial slice, 3-class one-hot (WG=1-TZ-PZ,TZ,PZ);
  * lesion — binarize GGG>=2, smoothen, 2-class one-hot;
  * probabilistic mode — append the (zeroed-at-valid/test) foreground label
    channels onto the image and yield a zeros 'KL' target.
"""

from __future__ import annotations

import itertools
import os
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np

from .. import prng
from .manifest import read_manifest

try:  # pragma: no cover - env dependent
    import cv2

    _HAS_CV2 = True
except Exception:  # pragma: no cover
    _HAS_CV2 = False


def _gaussian_kernel_1d(ksize: int = 7, sigma: float = 0.0) -> np.ndarray:
    """cv2.getGaussianKernel parity: sigma<=0 => 0.3*((k-1)*0.5-1)+0.8."""
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    xs = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2.0
    k = np.exp(-(xs**2) / (2.0 * sigma**2))
    return k / k.sum()


def _smooth_numpy(sl: np.ndarray, ksize: int) -> np.ndarray:
    """Separable Gaussian blur of one uint8 slice, BORDER_REFLECT_101, rounded."""
    kern = _gaussian_kernel_1d(ksize)
    pad = len(kern) // 2
    x = np.pad(sl.astype(np.float64), pad, mode="reflect")
    x = np.apply_along_axis(lambda m: np.convolve(m, kern, mode="valid"), 0, x)
    x = np.apply_along_axis(lambda m: np.convolve(m, kern, mode="valid"), 1, x)
    return np.rint(x)


def contour_smoothening(label: np.ndarray, kernel_2d=(7, 7), iterations: int = 1
                        ) -> np.ndarray:
    """Per-slice 2D Gaussian blur of a (D,H,W) uint8 mask (reference
    data_generators.py:92-97). Priority, as in the JAX package: cv2
    (reference-exact), the native C++ filter (native/edt.cpp, within +/-1
    gray level of cv2's fixed-point rounding), the separable numpy filter
    (:func:`_smooth_numpy`). All use BORDER_REFLECT_101."""
    if not _HAS_CV2:
        from ..utils.native import contour_smooth as _native_smooth

        out = label.astype(np.uint8)
        for _ in range(iterations):
            got = _native_smooth(out, kernel_2d[0])
            if got is None:
                break
            out = got
        else:
            return out.astype(label.dtype)
    label = label.copy()
    for _ in range(iterations):
        for k in range(label.shape[0]):
            sl = label[k].astype(np.uint8)
            if _HAS_CV2:
                label[k] = cv2.GaussianBlur(sl, tuple(kernel_2d), cv2.BORDER_DEFAULT)
            else:
                label[k] = _smooth_numpy(sl, kernel_2d[0]).astype(label.dtype)
    return label


def load_image(row: Dict[str, str], train_obj: str = "zonal") -> np.ndarray:
    """One case's (D, H, W, C) fp32 image as ``load_sample(mode='test')``
    yields it (the zonal task keeps the first channel only)."""
    if train_obj == "zonal":
        image = np.load(row["image_path"])[:, :, :, :1]
    elif train_obj == "lesion":
        image = np.load(row["image_path"])
    else:
        raise ValueError(f"Unknown train_obj {train_obj!r}")
    return image.astype(np.float32)


def load_sample(row: Dict[str, str], train_obj: str = "zonal", probabilistic: bool = False,
                mode: str = "train", with_dist_map: bool = False) -> Dict[str, np.ndarray]:
    """One case -> model I/O dict (reference data_generators.py:43-88):
    'image', 'detection' (the smoothed one-hot label), for a probabilistic
    model the label channels appended to the image (zeros in 'valid' and
    'test' modes) and a zeros 'KL' target; ``with_dist_map`` adds the signed
    EDT of the foreground label channels ('dist_map', for the boundary
    loss)."""
    image = load_image(row, train_obj)
    if train_obj == "zonal":
        if mode != "test":
            zones = np.load(row["zones_path"]).astype(np.uint8)
        else:
            zones = np.zeros_like(image[..., 0], dtype=np.uint8)
        tz, pz = zones.copy(), zones.copy()
        tz[zones != 1], pz[zones != 2] = 0, 0
        tz[zones == 1], pz[zones == 2] = 1, 1
        tz, pz = contour_smoothening(tz), contour_smoothening(pz)
        label = np.stack([np.ones_like(zones) - tz - pz, tz, pz], axis=-1)
    else:
        if mode != "test":
            lesions = np.load(row["label_path"])
        else:
            lesions = np.zeros_like(image[..., 0])
        lesions = lesions.copy()
        lesions[lesions <= 1] = 0
        lesions[lesions >= 2] = 1  # csPCa: GGG >= 2
        lesions = contour_smoothening(lesions.astype(np.uint8))
        label = np.stack([np.ones_like(lesions) - lesions, lesions], axis=-1)
    label = label.astype(np.float32)

    if mode in ("test", "valid"):
        postq_lbl = np.zeros_like(label)[:, :, :, 1:]
    else:
        postq_lbl = label[:, :, :, 1:]
    if probabilistic:
        sample = {"image": np.concatenate([image, postq_lbl], axis=-1),
                  "detection": label, "KL": np.zeros(label.shape, np.float32)}
    else:
        sample = {"image": image, "detection": label}
    if with_dist_map:
        from ..ops.edt import signed_distance_map

        sample["dist_map"] = signed_distance_map(label[..., 1:])
    return sample


def custom_data_generator(data_manifest: str, train_obj: str = "zonal",
                          probabilistic: bool = False, mode: str = "train",
                          shuffle_seed: Optional[int] = None, with_dist_map: bool = False,
                          cache_dir: Optional[str] = None) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite per-sample generator (reference data_generators.py:30-88)
    over the manifest's rows, each epoch in an order shuffled by one
    ``np.random.default_rng(shuffle_seed)`` (None: manifest order).

    ``cache_dir`` is the reference's --CACHE_TDS_PATH (train_model.py:
    177-181): the first pass writes each prepared sample as
    ``<p-id>.<task>-<p|d>-<mode>[-edt].npz`` (atomically, by ``os.replace``
    of a temporary file, so concurrent fold workers may share it); later
    passes read it instead of preparing the case again.
    """
    rows = read_manifest(data_manifest)
    rng = np.random.default_rng(shuffle_seed) if shuffle_seed is not None else None
    if cache_dir:
        os.makedirs(cache_dir, exist_ok=True)

    def prepare(row) -> Dict[str, np.ndarray]:
        if not cache_dir:
            return load_sample(row, train_obj, probabilistic, mode, with_dist_map)
        pid = str(row.get("p-id", "")) or os.path.basename(row["image_path"])
        recipe = f"{train_obj}-{'p' if probabilistic else 'd'}-{mode}" \
                 f"{'-edt' if with_dist_map else ''}"
        path = os.path.join(cache_dir, f"{pid}.{recipe}.npz")
        if os.path.isfile(path):
            with np.load(path) as z:
                return {k: z[k] for k in z.files}
        sample = load_sample(row, train_obj, probabilistic, mode, with_dist_map)
        tmp = path + ".tmp.npz"
        np.savez(tmp, **sample)
        os.replace(tmp, path)
        return sample

    for _ in itertools.count():
        order = np.arange(len(rows))
        if rng is not None:
            rng.shuffle(order)
        for i in order:
            yield prepare(rows[i])


def batch_iterator(sample_iter: Iterator[Dict[str, np.ndarray]], batch_size: int,
                   augment_fn=None, rng_seed: int = 0,
                   prefetch: int = 2) -> Iterator[Dict[str, np.ndarray]]:
    """Stack per-sample dicts into batches; ``augment_fn(rng, batch)`` (e.g.
    ``augment.make_augment_fn``), if given, augments batch i with one key a
    batch: the seed of ``prng.fold_in(prng.generator(rng_seed, "cpu"), i)``,
    which ``augment_fn`` turns into a generator on its own device.

    ``prefetch`` batches are assembled ahead on a background thread
    (tf.data's prefetch, train_model.py:183); an error raised while loading
    is raised to the consumer, and the thread stops when the returned
    generator is closed or collected.
    """
    def make_batch():
        samples = [next(sample_iter) for _ in range(batch_size)]
        return {k: np.stack([s[k] for s in samples]) for k in samples[0]}

    if prefetch and prefetch > 0:
        q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        stop = threading.Event()

        def producer():
            while not stop.is_set():
                try:
                    item = make_batch()
                except Exception as e:  # noqa: BLE001  (raised to the consumer)
                    item = e
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.25)
                        break
                    except queue.Full:
                        continue
                if isinstance(item, Exception):
                    return

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()

        def batches():
            try:
                while True:
                    item = q.get()
                    if isinstance(item, Exception):
                        raise item
                    yield item
            finally:
                stop.set()
                thread.join(timeout=5.0)
    else:
        def batches():
            while True:
                yield make_batch()

    source = batches()
    base = prng.generator(rng_seed, "cpu")
    try:
        for i, batch in enumerate(source):
            if augment_fn is not None:
                batch = augment_fn(prng.fold_in(base, i).initial_seed(), batch)
            yield batch
    finally:
        source.close()
