"""The port's ops against the JAX package's, on the CPU. (K1-K4 against
their plain twins on a CUDA card: tests/test_torch_kernels.py.)

Inputs are drawn by numpy from a seed and handed to both frameworks. fp32
comparisons use the repo's oracle tolerance, atol 2e-5
(tests/test_tf_parity.py:43). The kernels' own index arithmetic (the host
arrays the CUDA entries read) is replayed in numpy and held to flax too, so
the windows, phases and strides the card will use are checked here.
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from prostatemr_3d_cad_cspca_tpu.ops import normalization as jnorm
from prostatemr_3d_cad_cspca_tpu.ops.convolution import SplitInputConv
from prostatemr_3d_cad_cspca_tpu.ops.resample import upsample_nearest as j_upsample
from prostatemr_3d_cad_cspca_tpu_torch.ops import convolution as tconv
from prostatemr_3d_cad_cspca_tpu_torch.ops import normalization as tnorm
from prostatemr_3d_cad_cspca_tpu_torch.ops.resample import upsample_nearest

ATOL = 2e-5  # fp32 oracle tolerance of the repo
# bf16 affine: JAX rounds x*a and then +b to bf16 (two roundings), the port
# rounds x*a+b once; each rounding is half a bf16 ulp (2**-8 relative), so
# the two differ by under two ulps: 2**-6 relative to max(|y|, 1).
BF16_REL = 2.0 ** -6

CONV_CASES = [  # (kernel, stride) pairs of the M1 path
    ((1, 3, 3), (1, 1, 1)), ((1, 3, 3), (1, 2, 2)), ((3, 3, 3), (1, 1, 1)),
    ((3, 3, 3), (1, 2, 2)), ((3, 3, 3), (2, 2, 2)), ((1, 1, 1), (1, 1, 1)),
]
SIZES = {"even": (4, 8, 8), "odd": (5, 7, 9)}
CONVT_CASES = [((3, 3, 3), (2, 2, 2)), ((3, 3, 3), (1, 2, 2)),
               ((1, 3, 3), (1, 2, 2))]


def _seed(*case):
    return zlib.crc32(repr(case).encode())


def _parts(rng, spatial, widths, batch=2):
    return [rng.normal(size=(batch, *spatial, c)).astype(np.float32) for c in widths]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _emulate_igemm(parts, kernel, bias, strides, transposed):
    """numpy replay of csrc/conv3d.cu: the same meta/tap arrays the wrapper
    hands the C entry, walked phase by phase, tap by tap."""
    tparts = [_t(p) for p in parts]
    ks = tuple(kernel.shape[:3])
    spatial = tuple(parts[0].shape[1:4])
    plan_fn = tconv.transpose_plan if transposed else tconv.forward_plan
    plan = plan_fn(ks, strides, spatial)
    cout = kernel.shape[3] if transposed else kernel.shape[4]
    y = torch.empty((parts[0].shape[0], *plan["out"], cout))
    _, meta, taps = tconv._pack_conv_args(tparts, _t(kernel), _t(bias), y, plan,
                                          transposed)
    nparts, cin_total, batch = meta[0], meta[6], meta[7]
    ind, outd, grid = meta[8:11], meta[11:14], meta[14:17]
    cout = meta[17]
    in_mul, in_add, out_mul = meta[18:21], meta[21:24], meta[24:27]
    wci, wco = meta[27], meta[28]
    wflat = kernel.reshape(-1)
    out = np.full((batch, *outd, cout), np.nan, np.float64)
    g = np.meshgrid(*[np.arange(n) for n in grid], indexing="ij")
    for ph in range(meta[29]):
        res = meta[38 + 3 * ph:41 + 3 * ph]
        acc = np.zeros((batch, *grid, cout))
        ci_base = 0
        for p in range(nparts):
            x, cin = parts[p], meta[1 + p]
            for dz, dy, dx, wt in taps[ph, :meta[30 + ph]]:
                coords = [g[a] * in_mul[a] + in_add[a] + d
                          for a, d in enumerate((dz, dy, dx))]
                ok = np.ones(grid, bool)
                for a in range(3):
                    ok &= (coords[a] >= 0) & (coords[a] < ind[a])
                cl = [np.clip(c, 0, n - 1) for c, n in zip(coords, ind)]
                xs = x[:, cl[0], cl[1], cl[2], :] * ok[None, ..., None]
                idx = (int(wt) * cin_total * cout
                       + (ci_base + np.arange(cin))[:, None] * wci
                       + np.arange(cout)[None, :] * wco)
                acc += xs.astype(np.float64) @ wflat[idx]
            ci_base += cin
        o = [g[a] * out_mul[a] + res[a] for a in range(3)]
        out[:, o[0], o[1], o[2], :] = acc + bias
    assert not np.isnan(out).any(), "some output voxel belongs to no phase"
    return out


def _flax_split_conv(parts, kernel, bias, ks, st):
    mod = SplitInputConv(features=kernel.shape[-1], kernel_size=ks, strides=st)
    params = {"params": {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}}
    return np.asarray(mod.apply(params, [jnp.asarray(p) for p in parts]))


def _flax_convt(x, kernel, bias, ks, st):
    mod = fnn.ConvTranspose(kernel.shape[3], ks, st, padding="SAME",
                            transpose_kernel=True)
    params = {"params": {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}}
    return np.asarray(mod.apply(params, jnp.asarray(x)))


# -------------------------------------------------------------------- K1
@pytest.mark.parametrize("nparts", [1, 2])
@pytest.mark.parametrize("size", sorted(SIZES))
@pytest.mark.parametrize("ks,st", CONV_CASES)
def test_conv3d_matches_flax(ks, st, size, nparts):
    rng = np.random.default_rng(_seed(ks, st, size, nparts))
    widths = (3, 2)[:nparts]
    parts = _parts(rng, SIZES[size], widths)
    kernel = rng.normal(size=(*ks, sum(widths), 4)).astype(np.float32)
    bias = rng.normal(size=(4,)).astype(np.float32)
    want = _flax_split_conv(parts, kernel, bias, ks, st)
    got = tconv.conv3d([_t(p) for p in parts], _t(kernel), _t(bias), st)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    np.testing.assert_allclose(
        _emulate_igemm(parts, kernel, bias, st, transposed=False), want, atol=ATOL)


def test_conv3d_module_takes_a_part_list():
    rng = np.random.default_rng(1)
    parts = _parts(rng, (4, 6, 6), (2, 3))
    mod = tconv.Conv3d(5, 4, (3, 3, 3), (1, 2, 2))
    kernel = rng.normal(size=tuple(mod.kernel.shape)).astype(np.float32)
    bias = rng.normal(size=(4,)).astype(np.float32)
    mod.load_state_dict({"kernel": _t(kernel), "bias": _t(bias)})
    with torch.no_grad():
        got = mod([_t(p) for p in parts]).numpy()
        whole = mod(_t(np.concatenate(parts, -1))).numpy()
    want = _flax_split_conv(parts, kernel, bias, (3, 3, 3), (1, 2, 2))
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(whole, want, atol=ATOL)


@pytest.mark.parametrize("n,k,s,want", [
    (20, 3, 2, (10, 0, 1)), (160, 3, 2, (80, 0, 1)), (5, 3, 2, (3, 1, 1)),
    (20, 3, 1, (20, 1, 1)), (20, 1, 1, (20, 0, 0)),
])
def test_same_pads_are_xla_asymmetric(n, k, s, want):
    assert tconv.same_pads(n, k, s) == want


# -------------------------------------------------------------------- K2
@pytest.mark.parametrize("size", sorted(SIZES))
@pytest.mark.parametrize("ks,st", CONVT_CASES)
def test_conv3d_transpose_matches_flax(ks, st, size):
    rng = np.random.default_rng(_seed(ks, st, size))
    (x,) = _parts(rng, SIZES[size], (3,))
    kernel = rng.normal(size=(*ks, 4, 3)).astype(np.float32)  # (k.., out, in)
    bias = rng.normal(size=(4,)).astype(np.float32)
    want = _flax_convt(x, kernel, bias, ks, st)
    got = tconv.conv3d_transpose(_t(x), _t(kernel), _t(bias), st)
    assert got.shape == want.shape == (2, *[n * s for n, s in zip(SIZES[size], st)], 4)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    np.testing.assert_allclose(
        _emulate_igemm([x], kernel, bias, st, transposed=True), want, atol=ATOL)


def test_transpose_plan_phases_partition_the_taps():
    plan = tconv.transpose_plan((3, 3, 3), (2, 2, 2), (5, 10, 10))
    assert len(plan["phases"]) == 8
    used = sorted(t[3] for _, taps in plan["phases"] for t in taps)
    assert used == list(range(27))  # each tap feeds exactly one phase


# ----------------------------------------------------------------- K3/K4
def _in_inputs(seed, c=5, spatial=(3, 6, 7)):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(2, *spatial, c)) * 2 + 0.7).astype(np.float32)
    scale = (1 + 0.3 * rng.normal(size=(c,))).astype(np.float32)
    bias = (0.3 * rng.normal(size=(c,))).astype(np.float32)
    return x, scale, bias


@pytest.mark.parametrize("lrelu", [False, True])
def test_instance_norm_fp32_matches_jax(lrelu):
    x, scale, bias = _in_inputs(0)
    want = jnorm.instance_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    if lrelu:
        want = fnn.leaky_relu(want, 0.1)
    got = tnorm.instance_norm(_t(x), _t(scale), _t(bias), lrelu=lrelu)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("lrelu", [False, True])
def test_instance_norm_bf16_matches_jax(lrelu):
    x, scale, bias = _in_inputs(1)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = jnorm.instance_norm(xb, jnp.asarray(scale), jnp.asarray(bias))
    if lrelu:
        want = fnn.leaky_relu(want, 0.1)
    want = np.asarray(want.astype(jnp.float32))
    got = tnorm.instance_norm(_t(x).to(torch.bfloat16), _t(scale), _t(bias),
                              lrelu=lrelu)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want) / np.maximum(np.abs(want), 1.0)
    assert err.max() <= BF16_REL, err.max()


def test_instance_norm_module_matches_flax():
    x, scale, bias = _in_inputs(2)
    mod = tnorm.InstanceNorm(x.shape[-1])
    mod.load_state_dict({"scale": _t(scale), "bias": _t(bias)})
    want = jnorm.InstanceNorm().apply(
        {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}},
        jnp.asarray(x))
    with torch.no_grad():
        np.testing.assert_allclose(mod(_t(x)).numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_in_stats_formulas(dtype):
    """fp32: two-pass centred variance; bf16: one-pass E[x^2]-mean^2 in fp32,
    clamped at 0 (a constant channel gives exactly 0)."""
    x, _, _ = _in_inputs(3)
    x[..., 0] = 3.0
    xt = _t(x).to(getattr(torch, dtype))
    stats = tnorm.in_stats(xt).numpy()
    xf = xt.float().numpy().astype(np.float64)
    np.testing.assert_allclose(stats[:, 0], xf.mean(axis=(1, 2, 3)), atol=1e-5)
    np.testing.assert_allclose(stats[:, 1], xf.var(axis=(1, 2, 3)), atol=1e-4)
    assert (stats[:, 1] >= 0).all() and (stats[:, 1, 0] == 0).all()


def test_global_spatial_mean_matches_jax():
    x, _, _ = _in_inputs(4)
    want = np.asarray(jnorm.global_spatial_mean(jnp.asarray(x)))
    got = tnorm.global_spatial_mean(_t(x))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("factors", [(1, 1, 1), (2, 2, 2), (4, 16, 16), (1, 2, 3)])
def test_upsample_nearest_matches_jax(factors):
    x, _, _ = _in_inputs(5, c=2, spatial=(2, 1, 3))
    want = np.asarray(j_upsample(jnp.asarray(x), factors))
    np.testing.assert_array_equal(upsample_nearest(_t(x), factors).numpy(), want)


def test_store_act_rounds_through_fp8():
    x = torch.tensor([1.0, 1.03, -3.3, 0.0])
    cfg = tconv.ConvConfig(act_store="float8_e4m3fn")
    got = tconv.store_act(cfg, x)
    want = np.asarray(jnp.asarray(x.numpy()).astype(jnp.float8_e4m3fn)
                      .astype(jnp.float32))
    np.testing.assert_array_equal(got.numpy(), want)
    assert tconv.store_act(tconv.ConvConfig(), x) is x


# ------------------------------------------------------- dispatch, counts
def test_cpu_tensors_take_the_plain_path_and_count_nothing():
    fns = (tconv.conv3d, tconv.conv3d_transpose, tnorm.in_stats, tnorm.in_apply)
    before = [f.launches for f in fns]
    x, scale, bias = _in_inputs(6, c=3)
    xt = _t(x)
    k = torch.ones(3, 3, 3, 3, 4)
    tconv.conv3d([xt], k, torch.zeros(4), (1, 2, 2))
    tconv.conv3d_transpose(xt, torch.ones(3, 3, 3, 4, 3), None, (2, 2, 2))
    tnorm.instance_norm(xt, _t(scale), _t(bias), lrelu=True)
    assert [f.launches for f in fns] == before == [0, 0, 0, 0]
