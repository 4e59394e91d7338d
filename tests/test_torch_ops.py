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
    """numpy replay of csrc/conv3d_mma.cu's schedule, from the host arrays
    and the igemm_plan that the wrapper hands the C entry: per phase and
    split, the split's K-slabs of 32 (parts in order, tap-major within a
    part, each part rounded up to whole slabs), each slab gathered in
    8-channel chunks of one tap (the cp.async route) or element by element
    (the scalar route, cin 3 and 4); the partials land in the workspace and
    are summed in split order with the bias, as the reduce kernel does."""
    y, ws, igemm, (_, meta, taps) = tconv.igemm_args(
        [_t(p) for p in parts], _t(kernel), _t(bias), strides, transposed)
    splits, a_vec = int(meta[64]), int(meta[65])
    assert splits == igemm["splits"] and meta[67] == transposed
    assert (ws is None if splits == 1 else ws.shape == (splits, y.numel()))
    assert (0 if ws is None else ws.numel()) == igemm["workspace"]
    nparts, cin_total, batch = meta[0], meta[6], meta[7]
    cins = meta[1:1 + nparts]
    ind, outd, grid = meta[8:11], meta[11:14], meta[14:17]
    cout = meta[17]
    in_mul, in_add, out_mul = meta[18:21], meta[21:24], meta[24:27]
    wci, wco = meta[27], meta[28]
    wflat = kernel.reshape(-1).astype(np.float64)
    # output rows of one phase: (batch, grid) in C order, as the kernel's m
    rb, *g = [a.reshape(-1) for a in
              np.meshgrid(np.arange(batch), *[np.arange(n) for n in grid], indexing="ij")]
    workspace = np.full((splits, y.numel()), np.nan)
    for ph in range(meta[29]):
        ntap, res = meta[30 + ph], meta[38 + 3 * ph:41 + 3 * ph]
        o = [g[a] * out_mul[a] + res[a] for a in range(3)]
        oofs = (((rb * outd[0] + o[0]) * outd[1] + o[1]) * outd[2] + o[2]) * cout
        starts = np.concatenate([[0], np.cumsum(-(-ntap * cins // tconv.BK))])
        assert starts[-1] == igemm["slabs"][ph]
        for j in range(splits):
            lo, hi = igemm["ranges"][ph][j]
            assert (lo, hi) == (starts[-1] * j // splits, starts[-1] * (j + 1) // splits)
            acc = np.zeros((rb.size, cout))
            for s in range(lo, hi):
                part = int(np.searchsorted(starts, s, side="right")) - 1
                cin, ci_base = cins[part], int(cins[:part].sum())
                x, k0 = parts[part], (s - starts[part]) * tconv.BK
                step = 8 if (a_vec >> part) & 1 else 1
                a = np.zeros((rb.size, tconv.BK))
                b = np.zeros((tconv.BK, cout))
                for kk in range(0, tconv.BK, step):  # one chunk or one element
                    k = k0 + kk
                    if k >= ntap * cin:
                        continue  # zero-filled past the part's K
                    t, ci = divmod(k, cin)
                    dz, dy, dx, wt = taps[ph, t]
                    coords = [g[ax] * in_mul[ax] + in_add[ax] + d
                              for ax, d in enumerate((dz, dy, dx))]
                    ok = np.ones(rb.size, bool)
                    for ax in range(3):
                        ok &= (coords[ax] >= 0) & (coords[ax] < ind[ax])
                    cl = [np.clip(c, 0, n - 1) for c, n in zip(coords, ind)]
                    a[:, kk:kk + step] = x[rb, cl[0], cl[1], cl[2], ci:ci + step] * ok[:, None]
                    b[kk:kk + step] = wflat[int(wt) * cin_total * cout
                                            + (ci_base + ci + np.arange(step))[:, None] * wci
                                            + np.arange(cout)[None, :] * wco]
                acc += a @ b
            workspace[j, oofs[:, None] + np.arange(cout)[None, :]] = acc
    assert not np.isnan(workspace).any(), "some output voxel belongs to no phase"
    total = workspace[0].copy()
    for j in range(1, splits):  # the reduce kernel's order
        total += workspace[j]
    total += np.tile(bias, y.numel() // cout)
    return total.reshape(batch, *outd, cout)


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


# ------------------------------------------- K1/K2 bf16 schedule (igemm)
@pytest.mark.parametrize("ks,st,transposed", [(ks, st, False) for ks, st in CONV_CASES]
                         + [(ks, st, True) for ks, st in CONVT_CASES])
def test_igemm_split_schedule_matches_flax(ks, st, transposed, monkeypatch):
    """The cp.async route (K1 cin 16, K2 cin 64) beside the scalar one (K1
    cin 3), with K split as finely as the plan allows (one slab in the
    shortest phase), so the workspace and the ordered reduce are walked."""
    monkeypatch.setattr(tconv, "MIN_SLABS_PER_SPLIT", 1)
    rng = np.random.default_rng(_seed(ks, st, transposed, "split"))
    if transposed:
        (x,) = _parts(rng, SIZES["odd"], (64,))
        kernel = (rng.normal(size=(*ks, 4, 64)) / 8).astype(np.float32)
        parts, want_fn = [x], lambda b: _flax_convt(x, kernel, b, ks, st)
    else:
        parts = _parts(rng, SIZES["odd"], (16, 3))
        kernel = rng.normal(size=(*ks, 19, 4)).astype(np.float32)
        want_fn = lambda b: _flax_split_conv(parts, kernel, b, ks, st)  # noqa: E731
    bias = rng.normal(size=(4,)).astype(np.float32)
    _, _, igemm, (_, meta, _) = tconv.igemm_args([_t(p) for p in parts], _t(kernel), None,
                                                 st, transposed)
    assert igemm["splits"] == min(igemm["slabs"]) > 1
    assert meta[65] == 1  # part 0 by cp.async, a K1's part 1 (cin 3) scalar
    np.testing.assert_allclose(_emulate_igemm(parts, kernel, bias, st, transposed),
                               want_fn(bias), atol=ATOL)


def test_gather_routes_follow_channels_and_alignment():
    flat = torch.zeros(2 * 4 * 4 * 4 * 16 + 1, dtype=torch.bfloat16)
    aligned = flat[:-1].view(2, 4, 4, 4, 16)
    shifted = flat[1:].view(2, 4, 4, 4, 16)  # 2 bytes off a 16-byte boundary
    narrow = torch.zeros(2, 4, 4, 4, 3, dtype=torch.bfloat16)
    assert aligned.data_ptr() % 16 == 0 and shifted.data_ptr() % 16 == 2
    k1 = torch.zeros(3, 3, 3, 35, 8, dtype=torch.bfloat16)
    assert tconv.gather_routes([aligned, shifted, narrow], k1) == (
        ["cp.async", "scalar", "scalar"], "cp.async")
    k1_narrow = torch.zeros(1, 1, 1, 16, 4, dtype=torch.bfloat16)  # cout 4
    assert tconv.gather_routes([aligned], k1_narrow)[1] == "scalar"
    k2 = torch.zeros(3, 3, 3, 4, 16, dtype=torch.bfloat16)  # (.., Cout 4, Cin 16)
    assert tconv.gather_routes([aligned], k2)[1] == "cp.async"


def _path_convs(batch):
    """Every distinct K1/K2 call of the cfg1 forward at ``batch`` (the
    serve path's 2, serve_mc's 8, serve_sw's 16): (name, signature)."""
    import chip_smoke

    return [key for key in chip_smoke.trace_path_calls(batch)
            if key[0] in ("conv3d", "conv3d_transpose")]


def _path_plan(name, sig):
    """The wrapper's launch arguments of one path call, on the meta device."""
    transposed = name == "conv3d_transpose"
    shapes = [sig[0]] if transposed else sig[0]
    parts = [torch.empty(s, dtype=torch.bfloat16, device="meta") for s in shapes]
    kernel = torch.empty(sig[1], dtype=torch.bfloat16, device="meta")
    return tconv.igemm_args(parts, kernel, None, sig[2], transposed)


@pytest.mark.parametrize("batch", [2, 8, 16])
def test_igemm_plan_splits_partition_k(batch):
    for name, sig in _path_convs(batch):
        plan = _path_plan(name, sig)[2]
        assert len(plan["ranges"]) == len(plan["slabs"])
        for n, ranges in zip(plan["slabs"], plan["ranges"]):
            assert len(ranges) == plan["splits"]
            assert ranges[0][0] == 0 and ranges[-1][1] == n, (name, sig)
            assert all(lo < hi for lo, hi in ranges), (name, sig)  # none empty
            assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


@pytest.mark.parametrize("batch", [2, 8, 16])
def test_igemm_plan_fills_the_grid_or_runs_out_of_k(batch):
    """Split K into the most splits that keep the grid within one wave of
    the card (the target), or as far as K allows."""
    split_shapes = 0
    for name, sig in _path_convs(batch):
        plan = _path_plan(name, sig)[2]
        slabs = plan["slabs"]
        cap = max(1, min(min(slabs), sum(slabs) // (len(slabs) * tconv.MIN_SLABS_PER_SPLIT),
                         tconv.MAX_SPLITS))
        assert plan["cap"] == cap
        assert plan["target"] == tconv.SMS * tconv.RESIDENT_BLOCKS[plan["bn"]]
        if plan["splits"] > 1:
            assert plan["blocks"] <= plan["target"], (name, sig, plan)
        assert (plan["splits"] == cap  # K ran out
                or plan["tiles"] * (plan["splits"] + 1) > plan["target"]), (name, sig, plan)
        split_shapes += plan["splits"] > 1
    assert split_shapes > 0  # the deep levels split at every served batch


@pytest.mark.parametrize("batch", [2, 8, 16])
def test_igemm_plan_workspace_is_what_the_wrapper_allocates(batch):
    for name, sig in _path_convs(batch):
        y, ws, plan, (ptrs, meta, _) = _path_plan(name, sig)
        assert meta[64] == plan["splits"] and meta[68] == plan["bn"]
        if plan["splits"] == 1:
            assert ws is None and plan["workspace"] == 0
        else:
            assert ws.dtype == torch.float32 and tuple(ws.shape) == (plan["splits"], y.numel())
            assert ws.numel() == plan["workspace"]


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
