"""The port's 2D samplers (``ops/resample.py``) against the JAX package's, on
the CPU: the symmetric reflection of integer indices, bilinear sampling at
each boundary, bilinear and nearest resizes, and the batched form (one
coordinate map per sample, every depth slice and channel alike).

Coordinates and offsets cross both borders by more than one period (2n),
where ``jnp.mod`` and ``torch.fmod`` part ways. Index-only results (the
reflection, nearest resizes) are bit-equal; bilinear results are held at
the fp32 parity tolerance 2e-5 (``ROADMAP.md``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prostatemr_3d_cad_cspca_tpu.ops import resample as jr
from prostatemr_3d_cad_cspca_tpu_torch.ops import resample as tr

ATOL = 2e-5


def _img(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("size", [1, 5, 16])
def test_reflect_index_matches_jax(size):
    idx = np.arange(-5 * size - 3, 5 * size + 4, dtype=np.int32)
    want = np.asarray(jr._reflect_index(jnp.asarray(idx), size))
    got = tr._reflect_index(torch.from_numpy(idx), size).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0 and got.max() < size


@pytest.mark.parametrize("boundary", ["symmetric", "edge", "zero"])
def test_sample_bilinear_2d_matches_jax_across_both_borders(boundary):
    H, W, C = 7, 9, 3
    img = _img(0, (H, W, C))
    rng = np.random.default_rng(1)
    cy = rng.uniform(-3 * H, 4 * H, size=(11, 13)).astype(np.float32)
    cx = rng.uniform(-3 * W, 4 * W, size=(11, 13)).astype(np.float32)
    cy[0, :4] = [-2 * H - 0.5, 2 * H + 0.25, 0.0, H - 1.0]  # beyond one period, on the edge
    want = np.asarray(jr.sample_bilinear_2d(jnp.asarray(img), jnp.asarray(cy), jnp.asarray(cx),
                                            boundary=boundary))
    got = tr.sample_bilinear_2d(torch.from_numpy(img), torch.from_numpy(cy),
                                torch.from_numpy(cx), boundary=boundary).numpy()
    assert got.shape == want.shape == (11, 13, C)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_sample_bilinear_2d_batched_warps_each_sample_by_its_own_map():
    B, D, H, W, C = 3, 2, 8, 10, 4
    vol = _img(2, (B, D, H, W, C))
    rng = np.random.default_rng(3)
    cy = rng.uniform(-2 * H, 3 * H, size=(B, H, W)).astype(np.float32)
    cx = rng.uniform(-2 * W, 3 * W, size=(B, H, W)).astype(np.float32)
    got = tr.sample_bilinear_2d(torch.from_numpy(vol), torch.from_numpy(cy),
                                torch.from_numpy(cx)).numpy()
    for b in range(B):
        for d in range(D):
            want = np.asarray(jr.sample_bilinear_2d(jnp.asarray(vol[b, d]), jnp.asarray(cy[b]),
                                                    jnp.asarray(cx[b])))
            np.testing.assert_allclose(got[b, d], want, atol=ATOL, rtol=0)


def test_take_2d_is_a_per_sample_integer_gather():
    B, D, H, W, C = 2, 3, 5, 6, 2
    vol = _img(4, (B, D, H, W, C))
    rng = np.random.default_rng(5)
    iy, ix = rng.integers(0, H, (B, 4, 7)), rng.integers(0, W, (B, 4, 7))
    got = tr.take_2d(torch.from_numpy(vol), torch.from_numpy(iy), torch.from_numpy(ix)).numpy()
    want = np.stack([vol[b][:, iy[b], ix[b]] for b in range(B)])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("out_hw", [(12, 12), (24, 20), (5, 7), (16, 16)])
def test_resizes_match_jax(out_hw):
    img = _img(6, (16, 12, 3))
    want_b = np.asarray(jr.resize_bilinear_2d(jnp.asarray(img), *out_hw))
    got_b = tr.resize_bilinear_2d(torch.from_numpy(img), *out_hw).numpy()
    np.testing.assert_allclose(got_b, want_b, atol=ATOL, rtol=0)
    want_n = np.asarray(jr.resize_nearest_2d(jnp.asarray(img), *out_hw))
    got_n = tr.resize_nearest_2d(torch.from_numpy(img), *out_hw).numpy()
    np.testing.assert_array_equal(got_n, want_n)
    # leading axes: every (b, d) slice resized alike, as JAX's vmap does
    vol = _img(7, (2, 3, 16, 12, 3))
    got = tr.resize_bilinear_2d(torch.from_numpy(vol), *out_hw).numpy()
    want = np.asarray(jax.vmap(jax.vmap(lambda s: jr.resize_bilinear_2d(s, *out_hw)))(
        jnp.asarray(vol)))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_unknown_boundary_is_refused():
    with pytest.raises(ValueError, match="boundary"):
        tr.sample_bilinear_2d(torch.zeros(4, 4, 1), torch.zeros(2, 2), torch.zeros(2, 2),
                              boundary="wrap")
